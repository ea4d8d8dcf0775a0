"""Chunked state-space duality (the mamba2 SSD scan) in plain PyTorch.

Counterpart of bem_tpu/ops/ssd.py, which computes all of it outside any
Pallas kernel; so does the port: the SS2D ``m0`` forward type runs no
kernel of its own.

- :func:`ssd_chunked` is the chunked recurrence: within a chunk the
  lower-triangular masked product of the "attention-like" form, across
  chunks a first-order recurrence over the chunk states. bem_tpu runs the
  latter as an associative scan; here it is its cumulative form (the
  reference's ``ssd_minimal``): the states entering each chunk are one
  product with exp(segsum) of the chunks' log decays. The 4-operand
  einsums are contracted pairwise, so no (B, c, l, s, H, N, P) tensor is
  made.
- :func:`ssd_chunk_scan` discretizes (dt bias, softplus), halves the
  chunk until it divides L (VMamba-T's 7x7 stage runs with chunk 1),
  adds D * x and the optional silu(z) gate.
- :func:`selective_state_update` (one decode step) and
  :func:`layernorm_gated` complete the module; no model calls them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import softplus


def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k=j+1..i} x[..., k] for j < i, 0 on the
    diagonal, -inf above it (bem_tpu/ops/ssd.py:31-40)."""
    T = x.shape[-1]
    ones = torch.ones(T, T, dtype=torch.bool, device=x.device)
    xe = x[..., None].expand(*x.shape, T).masked_fill(~ones.tril(-1), 0.0)
    return xe.cumsum(-2).masked_fill(~ones.tril(0), float("-inf"))


def ssd_chunked(u, w, Bm, Cm, chunk: int, initial_states=None):
    """The chunked SSD recurrence (bem_tpu/ops/ssd.py:43-129): u (B, L, H,
    P) dt-scaled inputs, w (B, L, H) log decays A * dt, Bm / Cm (B, L, H,
    N), optional initial_states (B, H, P, N). Returns (Y (B, L, H, P),
    final state (B, H, P, N)), both fp32."""
    Bsz, L, H, P = u.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError(f"ssd_chunked: chunk {chunk} does not divide L={L}")
    c = L // chunk
    ub = u.float().reshape(Bsz, c, chunk, H, P)
    Bb = Bm.float().reshape(Bsz, c, chunk, H, N)
    Cb = Cm.float().reshape(Bsz, c, chunk, H, N)
    wb = w.float().reshape(Bsz, c, chunk, H).permute(0, 3, 1, 2)   # (B, H, c, l)
    w_cs = wb.cumsum(-1)
    # 1. within each chunk: (C_l . B_s) exp(segsum) u_s over s <= l
    CB = torch.einsum("bclhn,bcshn->bhcls", Cb, Bb)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", CB * torch.exp(segsum(wb)), ub)
    # 2. each chunk's end state
    decay_states = torch.exp(w_cs[..., -1:] - w_cs).permute(0, 2, 3, 1)  # (B, c, l, H)
    states = torch.einsum("bclhn,bclhp->bchpn", Bb * decay_states[..., None], ub)
    # 3. the states entering each chunk: the recurrence over chunks in its
    #    cumulative form, the initial state (zeros when none) as chunk -1
    init = (torch.zeros_like(states[:, 0]) if initial_states is None
            else initial_states.float().expand_as(states[:, 0]))
    states = torch.cat([init[:, None], states], 1)                     # (B, c+1, H, P, N)
    decay_chunk = torch.exp(segsum(F.pad(w_cs[..., -1], (1, 0))))       # (B, H, c+1, c+1)
    states = torch.einsum("bhzj,bjhpn->bzhpn", decay_chunk, states)
    # 4. each position's readout of the state entering its chunk
    Cd = Cb * torch.exp(w_cs).permute(0, 2, 3, 1)[..., None]
    Y_off = torch.einsum("bclhn,bchpn->bclhp", Cd, states[:, :-1])
    return (Y_diag + Y_off).reshape(Bsz, L, H, P), states[:, -1]


def ssd_chunk_scan(x, dt, A, Bm, Cm, chunk_size: int, D=None, z=None, dt_bias=None,
                   initial_states=None, dt_softplus: bool = False,
                   return_final_states: bool = False):
    """mamba_chunk_scan_combined (bem_tpu/ops/ssd.py:132-173): x (B, L, H,
    P), dt (B, L, H), A (H,), Bm / Cm (B, L, G, N) with G dividing H, D
    (H,) or (H, P), z like x, dt_bias (H,). The output in x's dtype (fp32
    inside); with ``return_final_states`` also the final state (B, H, P,
    N) fp32."""
    L, H = x.shape[1], x.shape[2]
    while L % chunk_size:
        chunk_size >>= 1
    G = Bm.shape[2]
    if H != G:
        if H % G:
            raise ValueError(f"ssd_chunk_scan: {G} groups do not divide {H} heads")
        Bm, Cm = Bm.repeat_interleave(H // G, 2), Cm.repeat_interleave(H // G, 2)
    dt = dt.float()
    if dt_bias is not None:
        dt = dt + dt_bias.float()
    if dt_softplus:
        dt = softplus(dt)
    y, final_state = ssd_chunked(x.float() * dt[..., None], A.float() * dt, Bm, Cm, chunk_size,
                                 initial_states)
    if D is not None:
        Df = D.float()
        y = y + (Df[:, None] if Df.dim() == 1 else Df) * x.float()
    if z is not None:
        y = y * F.silu(z.float())
    y = y.to(x.dtype)
    return (y, final_state) if return_final_states else y


def selective_state_update(state, x, dt, A, B, C, D=None, z=None, dt_bias=None,
                           dt_softplus: bool = False):
    """One decode step of the selective scan (bem_tpu/ops/ssd.py:176-255):
    h' = exp(dt A) h + dt B x, out = C . h' (+ D x) (* silu(z)). Returns
    (new state, out); nothing is updated in place. state (b, d, n) or (b,
    h, d, n); x, dt (b, [h,] d); A (d, n) or (h, d, n); B, C (b, n) or (b,
    g, n), g dividing h; D, dt_bias (d,) or (h, d); z like x."""
    has_heads = state.dim() > 3
    if state.dim() == 3:
        state = state[:, None]
    x, dt, z = (t[:, None] if t is not None and t.dim() == 2 else t for t in (x, dt, z))
    A = A[None] if A.dim() == 2 else A
    B, C = (t[:, None] if t.dim() == 2 else t for t in (B, C))
    D, dt_bias = (t[None] if t is not None and t.dim() == 1 else t for t in (D, dt_bias))
    batch, nheads, dim, dstate = state.shape
    if tuple(x.shape) != (batch, nheads, dim) or dt.shape != x.shape:
        raise ValueError(f"x/dt shape {tuple(x.shape)}/{tuple(dt.shape)} vs state "
                         f"{tuple(state.shape)}")
    if tuple(A.shape) != (nheads, dim, dstate):
        raise ValueError(f"A shape {tuple(A.shape)}")
    if nheads % B.shape[1]:
        raise ValueError("nheads must be divisible by ngroups")
    rep = nheads // B.shape[1]
    dtf = dt.float()
    if dt_bias is not None:
        dtf = dtf + dt_bias.float()[None]
    if dt_softplus:
        dtf = softplus(dtf)
    dA = torch.exp(dtf[..., None] * A.float()[None])
    Bh = B.repeat_interleave(rep, 1).float()
    Ch = C.repeat_interleave(rep, 1).float()
    xf = x.float()
    new_state = state.float() * dA + (dtf[..., None] * Bh[:, :, None, :]) * xf[..., None]
    out = torch.einsum("bhdn,bhn->bhd", new_state, Ch)
    if D is not None:
        out = out + xf * D.float()[None]
    if z is not None:
        out = out * F.silu(z.float())
    out, new_state = out.to(x.dtype), new_state.to(state.dtype)
    if not has_heads:
        out, new_state = out[:, 0], new_state[:, 0]
    return new_state, out


def layernorm_gated(x, weight, bias=None, z=None, eps: float = 1e-6, group_size=None,
                    norm_before_gate: bool = True, is_rms_norm: bool = False):
    """Gated (group) Layer / RMS norm over the last axis (bem_tpu/ops/ssd.py:
    258-302): norm(x) * silu(z) when ``norm_before_gate``, else
    norm(x * silu(z)); fp32 statistics, moments over groups of
    ``group_size`` channels where given, the affine over the whole axis."""
    xf = x.float()
    gate = F.silu(z.float()) if z is not None else None
    if gate is not None and not norm_before_gate:
        xf = xf * gate

    def _norm(v):
        if not is_rms_norm:
            v = v - v.mean(-1, keepdim=True)
        return v * torch.rsqrt(v.square().mean(-1, keepdim=True) + eps)

    if group_size is None:
        out = _norm(xf)
    else:
        if x.shape[-1] % group_size:
            raise ValueError("group_size must divide the channel axis")
        out = _norm(xf.reshape(*xf.shape[:-1], -1, group_size)).reshape(xf.shape)
    out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    if gate is not None and norm_before_gate:
        out = out * gate
    return out.to(x.dtype)
