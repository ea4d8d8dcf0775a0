"""SS2D 4-direction fused core: kernels 8 and 10 (forward) and 9 (backward).

``ss2d_dir_fused(xs2, Wx, Wdt, bias, A, D, clamp=False)`` is the
counterpart of bem_tpu/ops/ss2d_fused.py::ss2d_dir_fused and, with
``clamp=True``, of ss2d_fused_g.py::ss2d_dir_fused_g (the same function
with the log-decay clamped at -10; the TPU's batch grouping has no
counterpart here). xs2 (B, 2, C, L) holds the row-major and column-major
sequences of a feature map; per stream s, direction k = s scans forward and
k = s + 2 backward over the same sequence:

    xdbl = Wx[k] . x                      (R + 2N rows: dt-rank | B | C)
    dt   = softplus(Wdt[k] . xdbl[:R] + bias[k])
    h_n  = exp(dt * A[k, :, n]) * h_n + dt * x * B_n      (clamp: max(dt*A, -10))
    y_k  = sum_n C_n * h_n + D[k] * x

and y2[:, s] = cast(cast(y_s) + cast(y_{s+2})) in xs2.dtype (each direction
rounds to the stream dtype before their fp32 sum, as the Pallas bodies do).
Weights: Wx (4, P, C), Wdt (4, C, R), bias (4, C), A (4, C, N) (negative,
already -exp(A_logs)), D (4, C).

The wrapper is an autograd.Function. Its backward (kernel 9,
ss2d_fused_bwd.py::run_bwd) runs the lambda recurrence opposite to each
scan as a chunked reverse scan over the CKPT-long chunks whose entering
states the forward checkpoints: a summary pass (each chunk's decay and
mu = a lambda at its first position, from 0), a reverse
:func:`..scan.linear_scan` over the chunks, and a full pass that takes
every chunk at once, h from its checkpoint and lambda from the next
chunk's mu. It differentiates the unclamped function, also after a clamped
forward (ss2d_fused_g.py:323-339 re-runs the unclamped VJP), so a clamped
forward writes no checkpoints and the backward recomputes them.

On the card the forward is a chunked scan over super-chunks of S positions
of each direction's scan order (S from the kernel source,
:func:`fused_chunk`): the projection, then where L > S a summary pass (each
super-chunk's decay and end state from 0) and a forward
:func:`..scan.linear_scan` over the super-chunks, then a full pass that
walks every super-chunk at once from the state entering it and writes y and
the checkpoints. Its launches count the summary and the full pass (1 or 2 a
call); the projection's GEMM and the carry (on ``linear_scan``) do not.

On CPU tensors the wrappers run the plain versions below: the forward as a
composition on the doubling scan, the backward as its formulas written out
(the same lambda recurrence on the same scan). On CUDA tensors they launch
the kernels of ``csrc/ss2d_fused.cu`` or raise.
"""

from __future__ import annotations

import torch

from .. import _build
from ._common import check_stream, on_cuda, ptr, weight
from .scan import linear_scan, scan_plain

W_CLAMP = -10.0  # ss2d_fused_g.py:52
CKPT = 32        # scan positions per state checkpoint (the CUDA kernels' chunk)
N_STATES = (1, 2, 4, 8, 16)


def pick_group(B: int, C: int, max_sublanes: int = 256) -> int:
    """bem_tpu's batch group (ss2d_fused_g.py:345-350): the largest G in
    (8, 4, 2) dividing B with G*C within the budget, else 1. The port folds
    no batch; G > 1 only selects the clamped form, as bem_tpu's SS2D does."""
    for g in (8, 4, 2):
        if B % g == 0 and g * C <= max_sublanes:
            return g
    return 1


def _softplus(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))


def _args(xs2, Wx, Wdt, bias, A, D):
    """The stream checked and the weights as fp32 contiguous copies."""
    check_stream("ss2d_dir_fused", xs2)
    if xs2.dim() != 4 or xs2.shape[1] != 2:
        raise ValueError(f"ss2d_dir_fused: xs2 {tuple(xs2.shape)} is not (B, 2, C, L)")
    C = xs2.shape[2]
    K, P, _ = Wx.shape
    N = A.shape[-1]
    R = P - 2 * N
    if N not in N_STATES or R < 1:
        raise ValueError(f"ss2d_dir_fused: d_state N={N} not in {N_STATES} or rank {R} < 1")
    dev = xs2.device
    return (weight(Wx, dev, (4, P, C), "Wx"), weight(Wdt, dev, (4, C, R), "Wdt"),
            weight(bias, dev, (4, C), "bias"), weight(A, dev, (4, C, N), "A"),
            weight(D, dev, (4, C), "D"))


def _project(x, Wx, Wdt, bias):
    """x (B, C, L) fp32 -> (xdbl (B, P, L), dt pre-activation (B, C, L))."""
    R = Wdt.shape[-1]
    xd = torch.einsum("pc,bcl->bpl", Wx, x)
    return xd, torch.einsum("cr,brl->bcl", Wdt, xd[:, :R]) + bias[None, :, None]


def _dir_operands(x, Wx, Wdt, bias, A, clamp: bool):
    """One direction's projection rows xd (B, P, L), decays a and inputs b
    (B, C, L, N) in fp32 (the log-decay clamped at -10 under ``clamp``)."""
    N = A.shape[-1]
    R = Wdt.shape[-1]
    xd, dtrb = _project(x, Wx, Wdt, bias)
    dt = _softplus(dtrb)
    w = dt[..., None] * A[None, :, None, :]                          # (B, C, L, N)
    if clamp:
        w = torch.clamp(w, min=W_CLAMP)
    b = (dt * x)[..., None] * xd[:, R:R + N].transpose(1, 2)[:, None]
    return xd, torch.exp(w), b


def _dir_plain(x, Wx, Wdt, bias, A, D, reverse: bool, clamp: bool):
    """One direction in fp32 (ss2d_fused.py:297-330 with an optional clamp)."""
    N = A.shape[-1]
    R = Wdt.shape[-1]
    xd, a, b = _dir_operands(x, Wx, Wdt, bias, A, clamp)
    h = scan_plain(a, b, reverse, dim=2)
    y = torch.einsum("bcln,bnl->bcl", h, xd[:, R + N:])
    return y + D[None, :, None] * x


def _fwd_plain(xs2, Wx, Wdt, bias, A, D, clamp: bool):
    out = []
    for s in (0, 1):
        x = xs2[:, s].float()
        y_f = _dir_plain(x, Wx[s], Wdt[s], bias[s], A[s], D[s], False, clamp)
        y_r = _dir_plain(x, Wx[s + 2], Wdt[s + 2], bias[s + 2], A[s + 2], D[s + 2], True, clamp)
        out.append((y_f.to(xs2.dtype).float() + y_r.to(xs2.dtype).float()).to(xs2.dtype))
    return torch.stack(out, 1).contiguous()


def ss2d_dir_fused_plain(xs2, Wx, Wdt, bias, A, D, clamp: bool = False):
    """The plain PyTorch version of :func:`ss2d_dir_fused`, on any device;
    differentiable (through the clamp where it is set)."""
    _args(xs2, Wx, Wdt, bias, A, D)
    dev = xs2.device
    return _fwd_plain(xs2, *(t.to(dev, torch.float32) for t in (Wx, Wdt, bias, A, D)), clamp)


def ss2d_dir_fused_g_plain(xs2, Wx, Wdt, bias, A, D):
    """The plain PyTorch version of :func:`ss2d_dir_fused_g`, on any device."""
    return ss2d_dir_fused_plain(xs2, Wx, Wdt, bias, A, D, clamp=True)


def fused_checkpoints_plain(xs2, Wx, Wdt, bias, A, D, clamp: bool = False):
    """The states the forward kernel checkpoints, plainly: per (image,
    stream, direction) the state entering every CKPT-long chunk of the
    direction's scan order (0 for the first), (B, 2, 2, ceil(L / CKPT), C,
    N) fp32, on any device. For the checks: the port never calls it."""
    Wx, Wdt, bias, A, D = _args(xs2, Wx, Wdt, bias, A, D)
    B, _, C, L = xs2.shape
    N = A.shape[-1]
    nck = -(-L // CKPT)
    out = torch.zeros((B, 2, 2, nck, C, N), dtype=torch.float32, device=xs2.device)
    for s in (0, 1):
        for d in (0, 1):  # direction s + 2 d; d = 1 scans from position L - 1 down
            k = s + 2 * d
            x = xs2[:, s].float()
            _, a, b = _dir_operands(x.flip(-1) if d else x, Wx[k], Wdt[k], bias[k], A[k], clamp)
            h = scan_plain(a, b, False, dim=2)                       # in scan order
            out[:, s, d, 1:] = h[:, :, CKPT - 1:(nck - 1) * CKPT:CKPT].transpose(1, 2)
    return out


def _dir_bwd_plain(x, g, Wx, Wdt, bias, A, D, reverse: bool):
    """Gradients of one direction (ss2d_fused_bwd.py:15-21), unclamped:
    (dx, dWx, dWdt, dbias, dA, dD) for x, g (B, C, L) fp32."""
    N = A.shape[-1]
    R = Wdt.shape[-1]
    xd, dtrb = _project(x, Wx, Wdt, bias)
    dt = _softplus(dtrb)
    du = dt * x
    Bt = xd[:, R:R + N].transpose(1, 2)[:, None]                     # (B, 1, L, N)
    Ct = xd[:, R + N:].transpose(1, 2)[:, None]
    a = torch.exp(dt[..., None] * A[None, :, None, :])               # (B, C, L, N)
    h = scan_plain(a, du[..., None] * Bt, reverse, dim=2)
    zero = torch.zeros_like(h[:, :, :1])
    if reverse:  # scan order runs L-1 .. 0: the previous state is h[t + 1]
        h_prev = torch.cat([h[:, :, 1:], zero], 2)
        a_next = torch.cat([zero, a[:, :, :-1]], 2)
    else:
        h_prev = torch.cat([zero, h[:, :, :-1]], 2)
        a_next = torch.cat([a[:, :, 1:], zero], 2)
    # lambda_t = g_t C_t + a_next(t) lambda_next(t), opposite to the scan
    lam = scan_plain(a_next, g[..., None] * Ct, not reverse, dim=2)
    da = lam * h_prev
    lamB = (lam * Bt).sum(-1)                                         # (B, C, L)
    ddt = (da * a * A[None, :, None, :]).sum(-1) + lamB * x
    ddtr = ddt * torch.sigmoid(dtrb)
    dxd = torch.cat([torch.einsum("cr,bcl->brl", Wdt, ddtr),
                     (lam * du[..., None]).sum(1).transpose(1, 2),    # dB rows
                     (g[..., None] * h).sum(1).transpose(1, 2)], 1)   # dC rows
    dx = D[None, :, None] * g + lamB * dt + torch.einsum("pc,bpl->bcl", Wx, dxd)
    return (dx, torch.einsum("bpl,bcl->pc", dxd, x),
            torch.einsum("bcl,brl->cr", ddtr, xd[:, :R]), ddtr.sum((0, 2)),
            (da * a * dt[..., None]).sum((0, 2)), (g * x).sum((0, 2)))


def ss2d_dir_fused_bwd_plain(xs2, Wx, Wdt, bias, A, D, g):
    """The plain PyTorch version of :func:`ss2d_dir_fused_bwd`, on any device."""
    Wx, Wdt, bias, A, D = _args(xs2, Wx, Wdt, bias, A, D)
    dxs2 = torch.zeros(xs2.shape, dtype=torch.float32, device=xs2.device)
    per_k = [None] * 4
    for s in (0, 1):
        x = xs2[:, s].float()
        gs = g[:, s].float()
        for k, rev in ((s, False), (s + 2, True)):
            dx, *dw = _dir_bwd_plain(x, gs, Wx[k], Wdt[k], bias[k], A[k], D[k], rev)
            dxs2[:, s] += dx
            per_k[k] = dw
    return (dxs2.to(xs2.dtype), *(torch.stack(t).contiguous() for t in zip(*per_k)))


def fused_chunk(B: int, C: int, N: int, L: int) -> int:
    """Positions per super-chunk of the forward's chunked scan at batch B,
    C channels, N states and length L (``fwd_chunk`` of
    csrc/ss2d_fused.cu: the fewest super-chunks that fill the card, each a
    multiple of CKPT)."""
    return _build.load().bem_ss2d_fused_chunk(B, C, N, L)


def _fwd_kernels(xs2, w, clamp: bool, with_ckpt: bool, S: int):
    """The forward's kernels on CUDA tensors at super-chunks of S positions
    (a multiple of CKPT): (y2, checkpoints or None)."""
    B, _, C, L = xs2.shape
    P, N = w[0].shape[1], w[3].shape[-1]
    R = P - 2 * N
    bf16 = int(xs2.dtype == torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=xs2.device)
    counter = ss2d_dir_fused_g if clamp else ss2d_dir_fused
    xdbl = torch.empty((B, 2, 2, P, L), **f32)
    _build.call("bem_ss2d_fused_project", ptr(xs2), ptr(w[0]), ptr(xdbl), B, C, L, P, bf16)
    carry = None
    nsc = -(-L // S)
    if nsc > 1:
        # per (image, stream, direction) and super-chunk: the decay and the
        # end state from 0, then the state leaving each super-chunk
        aprod, hend = (torch.empty((B * 4, nsc, C * N), **f32) for _ in range(2))
        _build.call("bem_ss2d_fused_fwd_sum", ptr(xs2), *map(ptr, w[1:4]), ptr(xdbl), ptr(aprod),
                    ptr(hend), B, C, L, R, N, S, int(clamp), bf16)
        counter.launches += 1
        carry = linear_scan(aprod, hend)
    y = torch.empty_like(xs2)
    ck = torch.empty((B, 2, 2, -(-L // CKPT), C, N), **f32) if with_ckpt else None
    _build.call("bem_ss2d_fused_fwd", ptr(xs2), *map(ptr, w[1:]), ptr(xdbl), ptr(carry), ptr(y),
                ptr(ck), B, C, L, R, N, S, int(clamp), bf16)
    counter.launches += 1
    return y, ck


def _fwd_run(xs2, Wx, Wdt, bias, A, D, clamp: bool, with_ckpt: bool):
    """(y2, checkpoints or None): plain version for CPU tensors, kernels for
    CUDA ones. Checkpoints: (B, 2, 2, ceil(L / CKPT), C, N) fp32, the state
    entering each chunk of each direction in its scan order."""
    w = _args(xs2, Wx, Wdt, bias, A, D)
    if not on_cuda(xs2, "ss2d_dir_fused"):
        return _fwd_plain(xs2, *w, clamp), None
    B, _, C, L = xs2.shape
    return _fwd_kernels(xs2, w, clamp, with_ckpt, fused_chunk(B, C, w[3].shape[-1], L))


def _bwd_run(xs2, Wx, Wdt, bias, A, D, g, ck):
    """The six gradients: plain version for CPU tensors, kernels for CUDA
    ones (after an unclamped checkpointing forward where ``ck`` is None)."""
    if not on_cuda(xs2, "ss2d_dir_fused_bwd"):
        return ss2d_dir_fused_bwd_plain(xs2, Wx, Wdt, bias, A, D, g)
    w = _args(xs2, Wx, Wdt, bias, A, D)
    check_stream("ss2d_dir_fused_bwd", g, xs2.shape)
    if ck is None:
        _, ck = _fwd_run(xs2, *w, clamp=False, with_ckpt=True)
    B, _, C, L = xs2.shape
    P, N = w[0].shape[1], w[3].shape[-1]
    R = P - 2 * N
    nck = -(-L // CKPT)
    nblk = -(-C // _build.load().bem_ss2d_fused_bwd_cb(N))  # channel blocks of the passes
    f32 = dict(dtype=torch.float32, device=xs2.device)
    x = xs2.float().contiguous()
    g = g.float().contiguous()
    xdbl = torch.empty((B, 2, 2, P, L), **f32)        # the projection, recomputed
    # per (image, stream, direction) and chunk: the decay and mu = a lambda
    # at the chunk's first position, walked back from 0 (the carry's a, b)
    aprod, msum = (torch.empty((B * 4, nck, C * N), **f32) for _ in range(2))
    _build.call("bem_ss2d_fused_bwd_sum", ptr(x), ptr(g), *map(ptr, w[:4]), ptr(xdbl),
                ptr(aprod), ptr(msum), B, C, L, R, N)
    ss2d_dir_fused_bwd.launches += 1
    carry = linear_scan(aprod, msum, reverse=True)
    scratch = [torch.empty(s, **f32) for s in (
        (B, 2, 2, C, L),            # ddtr: d loss / d dt pre-activation
        (B, 2, nblk, 2 * N, L),     # per-channel-block dB / dC partial sums
        (B, 2, 2, P, L),            # dxdbl
        (B, 4, P, C),               # per-image dWx
        (B, 4, C, R),               # per-image dWdt
        (4, B, nck, C, N + 2),      # per-chunk (dA | dbias | dD)
        (4, B, C, N + 2))]          # per-image (dA | dbias | dD)
    dx = torch.empty((B, 2, C, L), **f32)
    dWx = torch.empty((4, P, C), **f32)
    dWdt = torch.empty((4, C, R), **f32)
    v = torch.empty((4, C, N + 2), **f32)
    _build.call("bem_ss2d_fused_bwd", ptr(x), ptr(g), *map(ptr, w), ptr(ck), ptr(carry),
                ptr(xdbl), *map(ptr, scratch), ptr(dx), ptr(dWx), ptr(dWdt), ptr(v), B, C, L, R, N)
    ss2d_dir_fused_bwd.launches += 1
    return (dx.to(xs2.dtype), dWx, dWdt, v[..., N].contiguous(), v[..., :N].contiguous(),
            v[..., N + 1].contiguous())


class _DirFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs2, Wx, Wdt, bias, A, D, clamp):
        keep = any(ctx.needs_input_grad[:6])
        y, ck = _fwd_run(xs2, Wx, Wdt, bias, A, D, clamp,
                         with_ckpt=keep and not clamp and xs2.is_cuda)
        if keep:
            ctx.save_for_backward(xs2, Wx, Wdt, bias, A, D, ck)
        return y

    @staticmethod
    def backward(ctx, g):
        xs2, Wx, Wdt, bias, A, D, ck = ctx.saved_tensors
        grads = _bwd_run(xs2, Wx, Wdt, bias, A, D, g.contiguous(), ck)
        return (*(d if n else None for d, n in zip(grads, ctx.needs_input_grad)), None)


def ss2d_dir_fused(xs2, Wx, Wdt, bias, A, D, clamp: bool = False):
    """Fused SS2D directional core (see the module docstring). Returns y2
    (B, 2, C, L) in xs2.dtype; with ``clamp`` the -10 log-decay clamp of
    ss2d_dir_fused_g (its launches count on :func:`ss2d_dir_fused_g`).
    Differentiable; the gradient is of the unclamped function."""
    return _DirFused.apply(xs2, Wx, Wdt, bias, A, D, bool(clamp))


def ss2d_dir_fused_g(xs2, Wx, Wdt, bias, A, D):
    """The clamped form: bem_tpu's ss2d_dir_fused_g on the ungrouped layout."""
    return _DirFused.apply(xs2, Wx, Wdt, bias, A, D, True)


def ss2d_dir_fused_bwd(xs2, Wx, Wdt, bias, A, D, g):
    """The VJP of the unclamped core for cotangent g (B, 2, C, L): (dxs2 in
    xs2.dtype, dWx, dWdt, dbias, dA, dD) fp32, the weights' gradients summed
    over batch and sequence. On CUDA: one checkpointing forward, then the
    backward kernels."""
    return _bwd_run(xs2, Wx, Wdt, bias, A, D, g, None)


ss2d_dir_fused.launches = 0
ss2d_dir_fused_g.launches = 0
ss2d_dir_fused_bwd.launches = 0
