"""Per-sequence SS2D scan pair: kernel 2 of the serving path.

``ss2d_seq_pair(xseq, Wx, Wdt, bias, A, D, pair)`` runs both scan
directions of one sequence (row-major: cross2d directions 0/2; col-major,
i.e. the transposed feature map: 1/3) with in-kernel dt/B/C projections
and returns y_fwd + y_rev in the original positions. It is the ungrouped
(G=1) form of bem_tpu/ops/ss2d_seq.py::ss2d_seq_pair_g; the TPU's
sublane grouping has no counterpart here.

The CUDA kernel (``csrc/ss2d_seq.cu``) runs one direction per launch: the
forward launch writes y_f in the stream dtype, the reverse launch adds it
and applies the combined skip term (D_f + D_r) * x, as the Pallas pair
does. The log-decay is clamped at -10 (``W_CLAMP`` of the TPU kernels);
the plain version clamps too, so it matches the kernel and not
bem_tpu's unclamped ``_seq_pair_ref``.
"""

from __future__ import annotations

import torch

from .. import _build
from ._common import check_stream, on_cuda, ptr, weight

PAIRS = {"row": (0, 2), "col": (1, 3)}
W_CLAMP = -10.0


def _softplus(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))


def _linear_scan(a: torch.Tensor, b: torch.Tensor, reverse: bool = False):
    """h_t = a_t * h_{t-1} + b_t along the last dim (h_{-1} = 0), by
    doubling: log2(L) elementwise passes instead of an L-step loop."""
    if reverse:
        a, b = a.flip(-1), b.flip(-1)
    L = a.shape[-1]
    s = 1
    while s < L:
        b = torch.cat([b[..., :s], a[..., s:] * b[..., :-s] + b[..., s:]], -1)
        a = torch.cat([a[..., :s], a[..., s:] * a[..., :-s]], -1)
        s *= 2
    return b.flip(-1) if reverse else b


def _dir_plain(x, Wx, Wdt, bias, A, D, reverse: bool):
    """One direction in fp32. x (B, C, L) fp32; Wx (P, C); Wdt (C, R);
    bias (C,); A (C, N); D (C,) or None."""
    N = A.shape[-1]
    R = Wx.shape[0] - 2 * N
    xdbl = torch.einsum("pc,bcl->bpl", Wx, x)
    dt = _softplus(torch.einsum("cr,brl->bcl", Wdt, xdbl[:, :R])
                   + bias.reshape(1, -1, 1))
    du = dt * x
    y = D.reshape(1, -1, 1) * x if D is not None else torch.zeros_like(x)
    for n in range(N):
        a = torch.exp(torch.clamp(dt * A[:, n].reshape(1, -1, 1), min=W_CLAMP))
        h = _linear_scan(a, du * xdbl[:, R + n:R + n + 1], reverse)
        y = y + xdbl[:, R + N + n:R + N + n + 1] * h
    return y


def _pair_args(xseq, Wx, Wdt, bias, A, D, pair):
    B, C, L = xseq.shape
    check_stream("ss2d_seq_pair", xseq)
    d_f, d_r = PAIRS[pair]
    dev = xseq.device
    K, P, _ = Wx.shape
    N = A.shape[-1]
    R = P - 2 * N
    if N not in (1, 2, 4):
        raise ValueError(f"ss2d_seq_pair: d_state N={N} not in (1, 2, 4)")
    Wx = weight(Wx, dev, (4, P, C), "Wx")
    Wdt = weight(Wdt, dev, (4, C, R), "Wdt")
    bias = weight(bias, dev, (4, C), "bias")
    A = weight(A, dev, (4, C, N), "A")
    D = weight(D, dev, (4, C), "D")
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


def ss2d_seq_pair(xseq, Wx, Wdt, bias, A, D, pair: str):
    """Both scan directions of one sequence, direction-merged.

    xseq (B, C, L); Wx (4, R+2N, C), Wdt (4, C, R), bias (4, C), A (4, C, N)
    (negative), D (4, C): per-direction weights in cross2d order; ``pair``
    "row" runs directions 0/2, "col" 1/3. Returns (B, C, L) in xseq.dtype.
    """
    xseq, fwd, rev = _pair_args(xseq, Wx, Wdt, bias, A, D, pair)
    if not on_cuda(xseq, "ss2d_seq_pair"):
        return _pair_plain(xseq, fwd, rev)
    B, C, L = xseq.shape
    N = fwd[3].shape[-1]
    R = fwd[0].shape[0] - 2 * N
    bf16 = int(xseq.dtype == torch.bfloat16)
    y_f = torch.empty_like(xseq)
    y = torch.empty_like(xseq)
    for (Wx_d, Wdt_d, b_d, A_d, D_d), yin, out, is_rev in (
            (fwd, None, y_f, 0), (rev, y_f, y, 1)):
        _build.call("bem_ss2d_seq_dir", ptr(xseq), ptr(Wx_d), ptr(Wdt_d),
                    ptr(b_d), ptr(A_d), ptr(D_d), ptr(yin), ptr(out),
                    B, C, L, R, N, is_rev, bf16)
        ss2d_seq_pair.launches += 1
    return y


ss2d_seq_pair.launches = 0
