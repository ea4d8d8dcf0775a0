"""Kernel 9's chunked reverse scan (csrc/ss2d_fused.cu backward), pinned on the CPU.

No kernel runs here, so this file mirrors the backward's three passes in
plain PyTorch and holds the mirror's six gradients against the port's
plain backward (``ss2d_dir_fused_bwd_plain``) and against bem_tpu's
custom VJP (run_bwd, Pallas interpret mode), on the same numpy-seeded
inputs. Per direction, in its scan order, with chunks of 32 positions
(the forward's checkpoints) and positions past L padded with x = g = 0
and projection rows 0, as the kernels stage them:

  1. summaries: per chunk and (channel, state), walked back from mu = 0
     at the chunk's end, lambda_t = g_t C_t + mu and mu = a_t lambda_t,
     over its valid positions; the chunk's decay exp(sum of dt A), no
     clamp;
  2. the carry: ``linear_scan_plain`` in reverse over the chunks, on the
     kernels' (B*2*2, nchunks, C*N) layout;
  3. every chunk from its checkpoint (the state entering it, here from
     the forward scan) and from mu of the chunk after it (0 for the
     last): dt, dx, dA, dB, dC and the rest, the channel sums of dB / dC
     per block of ``bwd_cb(N)`` channels, then over blocks in order, the
     sums over L per chunk, then over chunks and images.

Cases: L a multiple of 32, not a multiple, shorter than 32; N = 1, 2, 4
and 16; two channel blocks; clamp-probe inputs (bias +12 on every third
channel, so dt A < -10 there), where the gradients are the unclamped
function's. Tolerance: 2e-4 of each gradient's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.ss2d_fused import ss2d_dir_fused as jax_fused
from bem_tpu_torch.ops import ss2d_fused as pf
from bem_tpu_torch.ops.scan import linear_scan_plain, scan_plain

from test_torch_ss2d_fused import NAMES, _close, make
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

CK = pf.CKPT


@pytest.fixture(autouse=True, scope="module")
def _drop_interpret_traces():
    """Drop the jitted interpret-mode traces when the module ends, so that a
    later test lowering the same shapes for the TPU does not reuse them."""
    yield
    jax.clear_caches()


def bwd_cb(N):
    """Channels per block of the backward kernels (bwd_cb in the source)."""
    return min(256 // N, 64)


def _chunks(t, nck):
    """(B, C, L, ...) -> (B, C, nck, CK, ...), zero past L."""
    L = t.shape[2]
    pad = [0, 0] * (t.dim() - 3) + [0, nck * CK - L]
    return torch.nn.functional.pad(t, pad).reshape(*t.shape[:2], nck, CK, *t.shape[3:])


def _direction(x, g, Wx, Wdt, bias, A, D, mu_next, h_in, nck):
    """Pass 3 of one direction in its scan order: x, g (B, C, L); mu_next,
    h_in (B, C, nck, N). Returns (dx, dWx, dWdt, dbias, dA, dD)."""
    B, C, L = x.shape
    N = A.shape[-1]
    R = Wdt.shape[-1]
    xd = _chunks(torch.einsum("pc,bcl->bpl", Wx, x), nck)           # (B, P, nck, CK)
    xc, gc = _chunks(x, nck), _chunks(g, nck)
    dtr = torch.einsum("cr,brkt->bckt", Wdt, xd[:, :R]) + bias[None, :, None, None]
    dt = pf._softplus(dtr)
    a = torch.exp(dt[..., None] * A[None, :, None, None])           # (B, C, nck, CK, N)
    Bt = xd[:, R:R + N].permute(0, 2, 3, 1)[:, None]                 # (B, 1, nck, CK, N)
    Ct = xd[:, R + N:].permute(0, 2, 3, 1)[:, None]
    hs, h = [], h_in
    for t in range(CK):  # the chunk's states from its checkpoint
        h = a[:, :, :, t] * h + (dt * xc)[:, :, :, t, None] * Bt[:, :, :, t]
        hs.append(h)
    lam = torch.zeros_like(a)
    m = mu_next
    for t in reversed(range(CK)):
        lam[:, :, :, t] = gc[:, :, :, t, None] * Ct[:, :, :, t] + m
        m = a[:, :, :, t] * lam[:, :, :, t]
    h = torch.stack(hs, 3)
    h_prev = torch.cat([h_in[:, :, :, None], h[:, :, :, :-1]], 3)
    daa = lam * h_prev * a
    ddt = (daa * A[None, :, None, None]).sum(-1) + (lam * Bt).sum(-1) * xc
    dxa = (lam * Bt).sum(-1) * dt
    dd = (ddt * torch.sigmoid(dtr)).reshape(B, C, nck * CK)[..., :L]
    # dB | dC: per channel block, then over the blocks in order
    cb = bwd_cb(N)
    parts = [((lam * (dt * xc)[..., None])[:, i:i + cb].sum(1),
              (gc[..., None] * h)[:, i:i + cb].sum(1)) for i in range(0, C, cb)]
    dBC = [sum(p[q] for p in parts) for q in (0, 1)]                 # (B, nck, CK, N)
    dxd = torch.cat([torch.einsum("cr,bcl->brl", Wdt, dd)]
                    + [q.reshape(B, nck * CK, N)[:, :L].transpose(1, 2) for q in dBC], 1)
    dx = D[None, :, None] * g + dxa.reshape(B, C, -1)[..., :L] + torch.einsum(
        "pc,bpl->bcl", Wx, dxd)
    # sums over L: per chunk, then over chunks and images
    dA = (daa * dt[..., None]).sum(3).sum((0, 2))
    dbias = (ddt * torch.sigmoid(dtr)).sum(3).sum((0, 2))
    dD = (gc * xc).sum(3).sum((0, 2))
    xdbl = torch.einsum("pc,bcl->bpl", Wx, x)
    return (dx, torch.einsum("bpl,bcl->pc", dxd, x),
            torch.einsum("bcl,brl->cr", dd, xdbl[:, :R]), dbias, dA, dD)


def chunked_bwd(xs2, Wx, Wdt, bias, A, D, g):
    """The mirror of the backward's passes: (dxs2, dWx, dWdt, dbias, dA, dD)."""
    B, _, C, L = xs2.shape
    N = A.shape[-1]
    R = Wdt.shape[-1]
    nck = -(-L // CK)
    valid = _chunks(torch.ones(1, 1, L), nck)[..., None]             # (1, 1, nck, CK, 1)
    seqs, summ = {}, {}
    for s in (0, 1):
        for d in (0, 1):  # direction k = s + 2 d; d = 1 scans back to front
            k = s + 2 * d
            x, gs = xs2[:, s].float(), g[:, s].float()
            if d:
                x, gs = x.flip(-1), gs.flip(-1)
            xdbl = torch.einsum("pc,bcl->bpl", Wx[k], x)
            dt = pf._softplus(torch.einsum("cr,brl->bcl", Wdt[k], xdbl[:, :R])
                              + bias[k][None, :, None])
            a = torch.exp(dt[..., None] * A[k][None, :, None])        # (B, C, L, N)
            u = (dt * x)[..., None] * xdbl[:, R:R + N].transpose(1, 2)[:, None]
            # the checkpoints: the state entering each chunk, as the forward writes them
            hfull = scan_plain(a, u, False, dim=2)
            h_in = torch.cat([torch.zeros_like(hfull[:, :, :1]),
                              hfull[:, :, CK - 1:nck * CK - 1:CK]], 2)
            # pass 1: mu from 0 at each chunk's end, over its valid positions
            ac = _chunks(a, nck) * valid + (1 - valid)
            gC = _chunks(gs[..., None] * xdbl[:, R + N:].transpose(1, 2)[:, None], nck)
            m = torch.zeros(B, C, nck, N)
            for t in reversed(range(CK)):
                m = ac[:, :, :, t] * (gC[:, :, :, t] + m)
            decay = torch.exp((_chunks(dt[..., None] * A[k][None, :, None], nck) * valid).sum(3))
            summ[s, d] = [q.permute(0, 2, 1, 3).reshape(B, nck, C * N) for q in (decay, m)]
            seqs[s, d] = (x, gs, h_in)
    # pass 2: one reverse scan over (B*2*2, nck, C*N), row (b, s, d)
    rows = lambda i: torch.stack([torch.stack([summ[s, d][i] for d in (0, 1)], 1)  # noqa: E731
                                  for s in (0, 1)], 1).reshape(B * 4, nck, C * N)
    mu = linear_scan_plain(rows(0), rows(1), True).reshape(B, 2, 2, nck, C, N)
    mu_next = torch.cat([mu[:, :, :, 1:], torch.zeros_like(mu[:, :, :, :1])], 3)
    dxs2 = torch.zeros(B, 2, C, L)
    per_k = [None] * 4
    for (s, d), (x, gs, h_in) in seqs.items():
        k = s + 2 * d
        dx, *dw = _direction(x, gs, Wx[k], Wdt[k], bias[k], A[k], D[k],
                             mu_next[:, s, d].permute(0, 2, 1, 3), h_in, nck)
        dxs2[:, s] += dx.flip(-1) if d else dx
        per_k[k] = dw
    return (dxs2, *(torch.stack(t) for t in zip(*per_k)))


CASES = [  # (B, C, L, R, N, clamp)
    (1, 8, 64, 2, 1, False),     # L a multiple of 32
    (1, 40, 40, 2, 16, True),    # L not a multiple, d_state 16, three channel blocks, clamp probe
    (1, 16, 20, 2, 4, False),    # L shorter than a chunk
    (1, 70, 40, 3, 1, True),     # two channel blocks at N = 1, clamp probe
    (1, 24, 128, 2, 2, True),    # four chunks, clamp probe
]


@pytest.mark.parametrize("B,C,L,R,N,clamp", CASES)
def test_chunked_bwd_matches_plain_and_pallas(B, C, L, R, N, clamp):
    a = make(B, C, L, R, N, seed=L, clamp=clamp)
    g = np.random.default_rng(L + 1).standard_normal((B, 2, C, L)).astype(np.float32)
    ta = [torch.from_numpy(x) for x in a]
    got = chunked_bwd(*ta, torch.from_numpy(g))
    plain = pf.ss2d_dir_fused_bwd_plain(*ta, torch.from_numpy(g))
    _, vjp = jax.vjp(jax_fused, *map(jnp.asarray, a))  # the unclamped function's VJP
    for name, u, p, w in zip(NAMES, got, plain, vjp(jnp.asarray(g)), strict=True):
        assert u.shape == p.shape, name
        _close(u.numpy(), p.numpy(), 2e-4, f"d{name} vs plain")
        _close(u.numpy(), np.asarray(w), 2e-4, f"d{name} vs Pallas")
