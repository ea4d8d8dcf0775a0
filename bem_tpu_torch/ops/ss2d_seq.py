"""SS2D scan pairs: kernels 2 (row pair), 5 and 6 (transpose-free column pair).

``ss2d_seq_pair(xseq, Wx, Wdt, bias, A, D, pair)`` runs both scan
directions of one sequence (row-major: cross2d directions 0/2; col-major,
i.e. the transposed feature map: 1/3) with in-kernel dt/B/C projections
and returns y_fwd + y_rev in the original positions. It is the ungrouped
(G=1) form of bem_tpu/ops/ss2d_seq.py::ss2d_seq_pair_g; the TPU's
sublane grouping has no counterpart here. On the card it runs as a
chunked, parallel-in-L scan (``csrc/ss2d_seq.cu``): one summary pass over
both directions writes every chunk's decay exp(sum of log-decays) and end
state from 0, two :func:`..scan.linear_scan` over the chunks (forward for
the forward direction, reverse for the reverse one) carry the state from
chunk to chunk, and one full pass re-walks every chunk of both directions
from its entry state and writes round(y_f) + y_r + (D_f + D_r) * x, with
y_f rounded to the stream dtype first, as the Pallas pair does.

``ss2d_col_pair(xrow, Wx, Wdt, bias, A, D, y0, H, W)`` runs both column
directions (1/3) on the ROW-major stream, the function of
ss2d_col_pair_g, as a chunked, parallel-in-H scan (``csrc/ss2d_col.cu``):
one summary pass over both directions writes every chunk's decay and end
state from 0 (:func:`ss2d_col_sum`), two :func:`..scan.linear_scan` over
the column-major sequence of chunks carry the state across chunks and
columns, and one full pass (:func:`ss2d_col_dir`) walks both directions
of every chunk from its entry state and writes
round(y_r + round(y_f + (D_f + D_r) x + y0)), bem_tpu's rounding points.
The chunk length comes from the kernel source (:func:`col_chunk`); the
plain pair walks one chunk per column.

Each pass is a ``torch.library`` operator (ops/_common.py): the row pair
``bem::ss2d_seq_pair`` (its two carries inside), the column pair's
``bem::ss2d_col_sum`` and ``bem::ss2d_col_dir`` around two
``bem::linear_scan`` carries.

The forward passes clamp the log-decay at -10 (``W_CLAMP`` of the TPU
kernels), and so do their plain versions, which match the kernels and not
bem_tpu's unclamped ``_seq_pair_ref``. The backward of both pairs
recomputes through the unclamped composition :func:`_seq_pair_ref` on
``linear_scan``, as bem_tpu's custom VJPs do.
"""

from __future__ import annotations

import torch

from .. import _build
from ._common import (check_stream, counted_as, need_cuda, on_cuda, operator, ptr, ref_grads,
                      weight)
from .scan import linear_scan, linear_scan_plain, scan_cuda, scan_plain

PAIRS = {"row": (0, 2), "col": (1, 3)}
W_CLAMP = -10.0


def _softplus(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))


def _decay_input(x, Wx, Wdt, bias, A, clamp: bool = True):
    """Per-position scan operands of one direction in fp32. x (B, C, ...)
    fp32; Wx (P, C); Wdt (C, R); bias (C,); A (C, N). Returns the
    projection rows xdbl (B, P, ...), the log-decays w (clamped at -10
    unless ``clamp`` is False) and the inputs b, each a list of N tensors
    shaped like x."""
    N = A.shape[-1]
    R = Wx.shape[0] - 2 * N
    ex = (1,) * (x.dim() - 2)
    xdbl = torch.einsum("pc,bc...->bp...", Wx, x)
    dt = _softplus(torch.einsum("cr,br...->bc...", Wdt, xdbl[:, :R])
                   + bias.reshape(1, -1, *ex))
    du = dt * x
    w = [dt * A[:, n].reshape(1, -1, *ex) for n in range(N)]
    if clamp:
        w = [torch.clamp(wn, min=W_CLAMP) for wn in w]
    b = [du * xdbl[:, R + n:R + n + 1] for n in range(N)]
    return xdbl, w, b


def _dir_plain(x, Wx, Wdt, bias, A, D, reverse: bool):
    """One direction in fp32. x (B, C, L) fp32; Wx (P, C); Wdt (C, R);
    bias (C,); A (C, N); D (C,) or None."""
    N = A.shape[-1]
    R = Wx.shape[0] - 2 * N
    xdbl, w, b = _decay_input(x, Wx, Wdt, bias, A)
    y = D.reshape(1, -1, 1) * x if D is not None else torch.zeros_like(x)
    for n in range(N):
        h = scan_plain(torch.exp(w[n]), b[n], reverse, dim=-1)
        y = y + xdbl[:, R + N + n:R + N + n + 1] * h
    return y


def pair_flops(B: int, C: int, L: int, P: int, R: int) -> int:
    """What ``count_flops`` counts for one pass over both directions of a
    pair: each direction's x and dt projections (two FLOPs a multiply-add),
    as the plain version's einsums; the recurrence is elementwise work."""
    return 2 * 2 * B * L * C * (P + R)


def _dir_weights(Wx, Wdt, bias, A, D, dev, C):
    """Per-direction weights as fp32 contiguous copies on ``dev``."""
    K, P, _ = Wx.shape
    N = A.shape[-1]
    R = P - 2 * N
    if N not in (1, 2, 4):
        raise ValueError(f"ss2d scan: d_state N={N} not in (1, 2, 4)")
    return (weight(Wx, dev, (4, P, C), "Wx"), weight(Wdt, dev, (4, C, R), "Wdt"),
            weight(bias, dev, (4, C), "bias"), weight(A, dev, (4, C, N), "A"),
            weight(D, dev, (4, C), "D"))


def _pair_args(xseq, Wx, Wdt, bias, A, D, pair):
    check_stream("ss2d_seq_pair", xseq)
    d_f, d_r = PAIRS[pair]
    Wx, Wdt, bias, A, D = _dir_weights(Wx, Wdt, bias, A, D, xseq.device, xseq.shape[1])
    fwd = (Wx[d_f], Wdt[d_f], bias[d_f], A[d_f], None)
    # both directions scan the same x, so their D*x skip terms are one
    # combined term applied by the reverse pass
    rev = (Wx[d_r], Wdt[d_r], bias[d_r], A[d_r], (D[d_r] + D[d_f]).contiguous())
    return xseq, fwd, rev


def _pair_plain(xseq, fwd, rev):
    x = xseq.float()
    y_f = _dir_plain(x, *fwd, reverse=False).to(xseq.dtype)
    y = _dir_plain(x, *rev, reverse=True) + y_f.float()
    return y.to(xseq.dtype).contiguous()


def ss2d_seq_pair_plain(xseq, Wx, Wdt, bias, A, D, pair: str):
    """The plain PyTorch version of :func:`ss2d_seq_pair`, on any device."""
    return _pair_plain(*_pair_args(xseq, Wx, Wdt, bias, A, D, pair))


def _seq_pair_cpu(xseq, Wx, Wdt, bias, A, D, pair):
    """bem::ss2d_seq_pair on the CPU: the plain version."""
    return _pair_plain(*_pair_args(xseq, Wx, Wdt, bias, A, D, pair))


def _seq_pair_cuda(xseq, Wx, Wdt, bias, A, D, pair):
    """bem::ss2d_seq_pair on the card: the summary pass, the two carries
    (kernel 7) and the full pass."""
    need_cuda(xseq, "ss2d_seq_pair")
    xseq, fwd, rev = _pair_args(xseq, Wx, Wdt, bias, A, D, pair)
    B, C, L = xseq.shape
    N = fwd[3].shape[-1]
    R = fwd[0].shape[0] - 2 * N
    bf16 = int(xseq.dtype == torch.bfloat16)
    nch = -(-L // _build.load().bem_ss2d_seq_chunk(C, R, N))
    # per (image, chunk, channel * N + n): decay and end state, forward then reverse
    a_f, b_f, a_r, b_r = (torch.empty((B, nch, C * N), dtype=torch.float32, device=xseq.device)
                          for _ in range(4))
    wts = [*map(ptr, fwd[:4]), *map(ptr, rev[:4])]
    _build.call("bem_ss2d_seq_sum", ptr(xseq), *wts, ptr(a_f), ptr(b_f), ptr(a_r), ptr(b_r),
                B, C, L, R, N, bf16)
    ss2d_seq_pair.launches += 1
    h_f = scan_cuda(a_f, b_f, False)
    h_r = scan_cuda(a_r, b_r, True)
    y = torch.empty_like(xseq)
    _build.call("bem_ss2d_seq_full", ptr(xseq), *wts, ptr(rev[4]), ptr(h_f), ptr(h_r), ptr(y),
                B, C, L, R, N, bf16)
    ss2d_seq_pair.launches += 1
    return y


def _seq_pair_fake(xseq, Wx, Wdt, bias, A, D, pair):
    _pair_args(xseq, Wx, Wdt, bias, A, D, pair)
    return xseq.new_empty(xseq.shape)


_seq_pair_op = operator(
    "ss2d_seq_pair", "(Tensor xseq, Tensor Wx, Tensor Wdt, Tensor bias, Tensor A, Tensor D, "
    "str pair) -> Tensor", _seq_pair_cpu, _seq_pair_cuda, _seq_pair_fake)


# ---------------------------------------------------------------------------
# transpose-free column pair


def _pick_col_rows(H: int, W: int, cap: int = 1536):
    """Rows per column-scan block of the TPU kernel (ss2d_seq.py:164-177):
    the largest t <= 8 dividing H with t*W <= cap and t*W divisible by 128;
    small images (H*W <= 4096) take the whole image; else None."""
    best = None
    for t in range(1, min(H, 8) + 1):
        if H % t == 0 and t * W <= cap and (t * W) % 128 == 0:
            best = t
    if best is None and H * W <= 4096:
        return H
    return best


def col_pair_supported(H: int, W: int) -> bool:
    """Whether bem_tpu runs the transpose-free column pair at (H, W); the
    SS2D takes the same dispatch."""
    return _pick_col_rows(H, W) is not None


def _col_check(name, x, H, W, *dirs):
    """The stream's shape and each direction's (Wx, Wdt, bias, A[, D])
    weights: fp32, contiguous, on x's device, shaped for x's channels."""
    check_stream(name, x)
    if x.shape[-1] != H * W:
        raise ValueError(f"{name}: L={x.shape[-1]} != {H}*{W}")
    C = x.shape[1]
    for wts in dirs:
        P, N = wts[0].shape[0], wts[3].shape[-1]
        if N not in (1, 2, 4):
            raise ValueError(f"{name}: d_state N={N} not in (1, 2, 4)")
        for t, shape in zip(wts, ((P, C), (C, P - 2 * N), (C,), (C, N), (C,))):
            if t is not None and (t.dtype != torch.float32 or t.device != x.device
                                  or not t.is_contiguous() or tuple(t.shape) != shape):
                raise ValueError(f"{name}: weight {tuple(t.shape)} {t.dtype} on {t.device}, "
                                 f"expected fp32 contiguous {shape} on {x.device}")


def col_chunk(C: int, R: int, N: int, dtype) -> int:
    """Rows per chunk of the column pair's kernels at C channels, R dt-rank
    rows, N states and the stream dtype (``kColChunk`` of csrc/ss2d_col.cu,
    halved there where the full pass's shared memory needs it)."""
    return _build.load().bem_ss2d_col_chunk(C, R, N, int(dtype == torch.bfloat16))


def _chunked(t, T: int):
    """(B, C, H, W, ...) -> (B, C, nch, T, W, ...), zero rows past H."""
    H = t.shape[2]
    nch = -(-H // T)
    pad = [0, 0] * (t.dim() - 3) + [0, nch * T - H]
    return torch.nn.functional.pad(t, pad).reshape(*t.shape[:2], nch, T, *t.shape[3:])


def _chunk_layout(t):
    """(B, C, nch, W, N) -> the summaries' (B, W*nch, C*N): the column-major
    sequence of chunks, index w*nch + k."""
    B, C, nch, W, N = t.shape
    return t.permute(0, 3, 2, 1, 4).reshape(B, W * nch, C * N).contiguous()


def _chunk_operands(x, Wx, Wdt, bias, A, T: int, clamp: bool):
    """One direction's log-decays w and inputs b per row, (B, C, nch, T, W,
    N), zero on the rows past H, and its projection rows."""
    xdbl, w, b = _decay_input(x, Wx, Wdt, bias, A, clamp)
    return _chunked(torch.stack(w, -1), T), _chunked(torch.stack(b, -1), T), xdbl


def ss2d_col_sum_plain(x, fwd, rev, H: int, W: int, T: int, clamp: bool = True):
    """The plain PyTorch version of :func:`ss2d_col_sum`, on any device
    (``clamp`` False: the same without the -10 clamp, for the checks)."""
    _col_check("ss2d_col_sum", x, H, W, fwd, rev)
    B, C, _ = x.shape
    xi = x.float().reshape(B, C, H, W)
    out = []
    for (Wx, Wdt, bias, A), reverse in ((fwd, False), (rev, True)):
        w, b, _ = _chunk_operands(xi, Wx, Wdt, bias, A, T, clamp)
        # each chunk from 0: forward its bottom row's state, reverse (walked
        # bottom-up) its top row's; the decay summed in log space
        end = scan_plain(torch.exp(w), b, reverse, dim=3)[:, :, :, 0 if reverse else T - 1]
        out += [_chunk_layout(torch.exp(w.sum(3))), _chunk_layout(end)]
    return tuple(out)


def _col_sum_cpu(x, fwd, rev, H, W, T):
    """bem::ss2d_col_sum on the CPU: the plain version."""
    return tuple(ss2d_col_sum_plain(x, fwd, rev, H, W, T))


def _col_sum_shape(x, fwd, H, W, T):
    return (x.shape[0], W * -(-H // T), x.shape[1] * fwd[3].shape[-1])


def _col_sum_cuda(x, fwd, rev, H, W, T):
    """bem::ss2d_col_sum on the card: one launch of the summary pass."""
    need_cuda(x, "ss2d_col_sum")
    _col_check("ss2d_col_sum", x, H, W, fwd, rev)
    B, C, _ = x.shape
    N = fwd[3].shape[-1]
    R = fwd[0].shape[0] - 2 * N
    out = [torch.empty(_col_sum_shape(x, fwd, H, W, T), dtype=torch.float32, device=x.device)
           for _ in range(4)]
    _build.call("bem_ss2d_col_sum", ptr(x), *map(ptr, fwd), *map(ptr, rev), *map(ptr, out),
                B, C, H, W, R, N, T, int(x.dtype == torch.bfloat16))
    ss2d_col_sum.launches += 1
    return tuple(out)


def _col_sum_fake(x, fwd, rev, H, W, T):
    _col_check("ss2d_col_sum", x, H, W, fwd, rev)
    return tuple(x.new_empty(_col_sum_shape(x, fwd, H, W, T), dtype=torch.float32)
                 for _ in range(4))


_col_sum_op = operator(
    "ss2d_col_sum", "(Tensor x, Tensor[] fwd, Tensor[] rev, SymInt H, SymInt W, SymInt T) -> "
    "(Tensor, Tensor, Tensor, Tensor)", _col_sum_cpu, _col_sum_cuda, _col_sum_fake)


def ss2d_col_sum(x, fwd, rev, H: int, W: int, T: int):
    """Both column directions' chunk summaries in one top-down walk
    (the operator bem::ss2d_col_sum).

    x (B, C, H*W) row-major stream; fwd / rev = (Wx (P, C), Wdt (C, R),
    bias (C,), A (C, N)) fp32 of directions 1 and 3; T rows per chunk
    (:func:`col_chunk` on the card). Returns (a_f, b_f, a_r, b_r), each
    (B, W*nch, C*N) fp32 with nch = ceil(H / T), at [b, w*nch + k, c*N + n]:
    chunk k of column w's decay exp(sum of clamped log-decays) and its end
    state from 0 (forward: at the chunk's bottom row; reverse: at its top)."""
    return _col_sum_op(x, list(fwd), list(rev), H, W, T)


def ss2d_col_dir_plain(x, fwd, rev, h_f, h_r, y0, H: int, W: int, T: int,
                       clamp: bool = True):
    """The plain PyTorch version of :func:`ss2d_col_dir`, on any device
    (``clamp`` False: the same without the -10 clamp, for the checks)."""
    _col_check("ss2d_col_dir", x, H, W, fwd, rev)
    B, C, _ = x.shape
    N = fwd[3].shape[-1]
    R = fwd[0].shape[0] - 2 * N
    nch = -(-H // T)
    xi = x.float().reshape(B, C, H, W)
    zero = torch.zeros_like(h_f[:, :1])
    ys = []
    for (Wx, Wdt, bias, A, _), h_inc, reverse in ((fwd, h_f, False), (rev, h_r, True)):
        # the entry state: the inclusive state of the chunk walked just before
        hin = (torch.cat([h_inc[:, 1:], zero], 1) if reverse
               else torch.cat([zero, h_inc[:, :-1]], 1))
        hin = hin.float().reshape(B, W, nch, C, N).permute(0, 3, 2, 1, 4)  # (B, C, nch, W, N)
        w, b, xdbl = _chunk_operands(xi, Wx, Wdt, bias, A, T, clamp)
        a = torch.exp(w)
        row = T - 1 if reverse else 0  # it folds into the first row walked
        b[:, :, :, row] = b[:, :, :, row] + a[:, :, :, row] * hin
        h = scan_plain(a, b, reverse, dim=3)
        cq = _chunked(xdbl[:, R + N:], T).permute(0, 2, 3, 4, 1)   # (B, nch, T, W, N)
        y = (h * cq[:, None]).sum(-1).reshape(B, C, nch * T, W)[:, :, :H]
        ys.append(y.reshape(B, C, H * W))
    y_f, y_r = ys
    # bem_tpu's rounding points: round(y_f + (D_f + D_r) x + y0), then round(y_r + that)
    y1 = y_f + fwd[4].reshape(1, -1, 1) * x.float()
    if y0 is not None:
        y1 = y1 + y0.float()
    return (y_r + y1.to(x.dtype).float()).to(x.dtype).contiguous()


def _col_dir_check(x, fwd, rev, h_f, h_r, y0, H, W, T):
    _col_check("ss2d_col_dir", x, H, W, fwd, rev)
    if y0 is not None:
        check_stream("ss2d_col_dir", y0, x.shape)
        if y0.dtype != x.dtype:
            raise TypeError("ss2d_col_dir: y0 dtype differs from x")
    shape = _col_sum_shape(x, fwd, H, W, T)
    for h in (h_f, h_r):
        if h.shape != shape or h.dtype != torch.float32 or not h.is_contiguous():
            raise ValueError(f"ss2d_col_dir: chunk states {tuple(h.shape)} {h.dtype}, "
                             f"expected fp32 contiguous {shape}")


def _col_dir_cpu(x, fwd, rev, D, h_f, h_r, y0, H, W, T):
    """bem::ss2d_col_dir on the CPU: the plain version."""
    return ss2d_col_dir_plain(x, (*fwd, D), (*rev, None), h_f, h_r, y0, H, W, T)


def _col_dir_cuda(x, fwd, rev, D, h_f, h_r, y0, H, W, T):
    """bem::ss2d_col_dir on the card: one launch of the full pass."""
    need_cuda(x, "ss2d_col_dir")
    _col_dir_check(x, (*fwd, D), (*rev, None), h_f, h_r, y0, H, W, T)
    B, C, L = x.shape
    N = fwd[3].shape[-1]
    R = fwd[0].shape[0] - 2 * N
    y = torch.empty_like(x)
    _build.call("bem_ss2d_col_full", ptr(x), *map(ptr, fwd), *map(ptr, rev),
                ptr(D), ptr(h_f), ptr(h_r), ptr(y0), ptr(y), B, C, H, W, R, N, T,
                int(x.dtype == torch.bfloat16))
    ss2d_col_dir.launches += 1
    return y


def _col_dir_fake(x, fwd, rev, D, h_f, h_r, y0, H, W, T):
    _col_dir_check(x, (*fwd, D), (*rev, None), h_f, h_r, y0, H, W, T)
    return x.new_empty(x.shape)


_col_dir_op = operator(
    "ss2d_col_dir", "(Tensor x, Tensor[] fwd, Tensor[] rev, Tensor D, Tensor h_f, Tensor h_r, "
    "Tensor? y0, SymInt H, SymInt W, SymInt T) -> Tensor", _col_dir_cpu, _col_dir_cuda,
    _col_dir_fake)


def ss2d_col_dir(x, fwd, rev, h_f, h_r, y0, H: int, W: int, T: int):
    """Both column directions' full scans from the carry's chunk states, in
    one pass (the operator bem::ss2d_col_dir).

    x (B, C, H*W); fwd = (Wx, Wdt, bias, A, D_f + D_r), rev = (Wx, Wdt,
    bias, A, None) fp32 of directions 1 and 3; h_f / h_r (B, W*nch, C*N)
    fp32, the inclusive state of every chunk (the carry scans over
    :func:`ss2d_col_sum`'s summaries, same T); y0 (B, C, H*W) in x.dtype or
    None. Returns round(y_r + round(y_f + (D_f + D_r) x + y0)) in x.dtype."""
    return _col_dir_op(x, list(fwd[:4]), list(rev[:4]), fwd[4], h_f, h_r, y0, H, W, T)


def _col_args(xrow, Wx, Wdt, bias, A, D, y0, H, W):
    _col_check("ss2d_col_pair", xrow, H, W)
    if y0 is not None:
        check_stream("ss2d_col_pair", y0, xrow.shape)
        if y0.dtype != xrow.dtype:
            raise TypeError("ss2d_col_pair: y0 dtype differs from xrow")
    d_f, d_r = PAIRS["col"]
    Wx, Wdt, bias, A, D = _dir_weights(Wx, Wdt, bias, A, D, xrow.device, xrow.shape[1])
    # both directions scan the same x: the D*x terms fold into the first
    # rounding point, as in ss2d_col_pair_g
    fwd = (Wx[d_f], Wdt[d_f], bias[d_f], A[d_f], (D[d_f] + D[d_r]).contiguous())
    rev = (Wx[d_r], Wdt[d_r], bias[d_r], A[d_r], None)
    return fwd, rev


def _col_pair(xrow, fwd, rev, y0, H, W, T, col_sum, col_dir, scan):
    """Summaries, the two carries over the column-major chunk sequence, the
    full pass."""
    a_f, b_f, a_r, b_r = col_sum(xrow, fwd[:4], rev[:4], H, W, T)
    h_f = scan(a_f, b_f, False)
    h_r = scan(a_r, b_r, True)
    return col_dir(xrow, fwd, rev, h_f, h_r, y0, H, W, T)


def ss2d_col_pair_plain(xrow, Wx, Wdt, bias, A, D, y0, H: int, W: int):
    """The plain PyTorch version of :func:`ss2d_col_pair`, on any device
    (one chunk per column)."""
    fwd, rev = _col_args(xrow, Wx, Wdt, bias, A, D, y0, H, W)
    return _col_pair(xrow, fwd, rev, y0, H, W, H, ss2d_col_sum_plain, ss2d_col_dir_plain,
                     linear_scan_plain)


def _col_pair_run(xrow, Wx, Wdt, bias, A, D, y0, H, W):
    """The column pair as three operators: bem::ss2d_col_sum, two
    bem::linear_scan carries, bem::ss2d_col_dir. The chunk length is a
    Python int: H on the CPU (one chunk a column), the kernel source's on
    the card (asked of the built library, also when tracing)."""
    fwd, rev = _col_args(xrow, Wx, Wdt, bias, A, D, y0, H, W)
    if not on_cuda(xrow, "ss2d_col_pair"):
        T = H
    else:
        N = fwd[3].shape[-1]
        T = col_chunk(xrow.shape[1], fwd[0].shape[0] - 2 * N, N, xrow.dtype)
    return _col_pair(xrow, fwd, rev, y0, H, W, T, ss2d_col_sum, ss2d_col_dir, linear_scan)


# ---------------------------------------------------------------------------
# backward: the unclamped composition on linear_scan


def _seq_pair_ref(xseq, Wx, Wdt, bias, A, D, d_f: int, d_r: int, scan=linear_scan):
    """Composition oracle for one sequence pair (ss2d_seq.py:451-486):
    fp32 math, no log-decay clamp, directions d_f (forward) and d_r
    (reverse) scanned by ``scan`` on (B, L, C*N). Returns xseq.dtype."""
    B, C, L = xseq.shape
    N = A.shape[-1]
    R = Wx.shape[1] - 2 * N
    x = xseq.float()
    out = torch.zeros((B, C, L), dtype=torch.float32, device=x.device)
    for k, rev in ((d_f, False), (d_r, True)):
        xdbl = torch.einsum("pc,bcl->bpl", Wx[k].float(), x)
        dt = _softplus(torch.einsum("cr,brl->bcl", Wdt[k].float(), xdbl[:, :R])
                       + bias[k].float()[None, :, None])
        a = torch.exp(dt[..., None] * A[k].float()[None, :, None, :])       # (B, C, L, N)
        b = (dt * x)[..., None] * xdbl[:, R:R + N].transpose(1, 2)[:, None]  # (B, C, L, N)
        a2 = a.permute(0, 2, 1, 3).reshape(B, L, C * N)
        b2 = b.permute(0, 2, 1, 3).reshape(B, L, C * N)
        h = scan(a2, b2, rev).reshape(B, L, C, N)
        y = torch.einsum("blcn,bln->bcl", h, xdbl[:, R + N:].transpose(1, 2))
        out = out + y + D[k].float()[None, :, None] * x
    return out.to(xseq.dtype)


def _transpose_hw(t, H, W):
    """(B, C, H*W) row-major <-> (B, C, W*H) column-major."""
    B, C, _ = t.shape
    return t.reshape(B, C, H, W).transpose(2, 3).reshape(B, C, H * W)


class _SeqPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xseq, Wx, Wdt, bias, A, D, pair):
        ctx.pair = pair
        ctx.save_for_backward(xseq, Wx, Wdt, bias, A, D)
        return _seq_pair_op(xseq, Wx, Wdt, bias, A, D, pair)

    @staticmethod
    def backward(ctx, g):
        d_f, d_r = PAIRS[ctx.pair]
        grads = ref_grads(ctx.needs_input_grad[:6], lambda *a: _seq_pair_ref(*a, d_f, d_r),
                          g.contiguous(), ctx.saved_tensors)
        return (*grads, None)


class _ColPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xrow, Wx, Wdt, bias, A, D, y0, H, W):
        ctx.hw = (H, W)
        ctx.save_for_backward(xrow, Wx, Wdt, bias, A, D)
        return _col_pair_run(xrow, Wx, Wdt, bias, A, D, y0, H, W)

    @staticmethod
    def backward(ctx, g):
        H, W = ctx.hw
        xrow, *w = ctx.saved_tensors
        d_f, d_r = PAIRS["col"]
        # recompute on the column-major view (ss2d_seq.py:588-609)
        grads = ref_grads(ctx.needs_input_grad[:6], lambda *a: _seq_pair_ref(*a, d_f, d_r),
                           _transpose_hw(g, H, W).contiguous(),
                           [_transpose_hw(xrow, H, W)] + w)
        dx = None if grads[0] is None else _transpose_hw(grads[0], W, H)
        # the y0 merge is a plain add: its cotangent is g itself
        dy0 = g if ctx.needs_input_grad[6] else None
        return (dx, *grads[1:], dy0, None, None)


def ss2d_seq_pair(xseq, Wx, Wdt, bias, A, D, pair: str):
    """Both scan directions of one sequence, direction-merged.

    xseq (B, C, L); Wx (4, R+2N, C), Wdt (4, C, R), bias (4, C), A (4, C, N)
    (negative), D (4, C): per-direction weights in cross2d order; ``pair``
    "row" runs directions 0/2, "col" 1/3. Returns (B, C, L) in xseq.dtype.
    Differentiable (backward through the unclamped composition).
    ``count_flops`` counts it as :func:`pair_flops`.
    """
    B, C, L = xseq.shape
    with counted_as(pair_flops(B, C, L, Wx.shape[1], Wdt.shape[-1])):
        return _SeqPair.apply(xseq, Wx, Wdt, bias, A, D, pair)


ss2d_seq_pair.launches = 0


def ss2d_col_pair(xrow, Wx, Wdt, bias, A, D, y0, H: int, W: int):
    """Both COLUMN scan directions (cross2d 1/3) on the row-major stream.

    xrow (B, C, H*W); weights as :func:`ss2d_seq_pair`; y0 (B, C, H*W) in
    xrow.dtype or None, merged into the output (the row pair's result, so
    the tail reads one stream). Returns (B, C, H*W) in xrow.dtype: y0 +
    y_dir1 + y_dir3 in row-major positions. Differentiable.
    ``count_flops`` counts it as :func:`pair_flops`.
    """
    B, C, L = xrow.shape
    with counted_as(pair_flops(B, C, L, Wx.shape[1], Wdt.shape[-1])):
        return _ColPair.apply(xrow, Wx, Wdt, bias, A, D, y0, H, W)


ss2d_col_sum.launches = 0
ss2d_col_dir.launches = 0
