"""First-order linear recurrence: kernel 7, counterpart of bem_tpu/ops/scan.py.

``linear_scan(a, b, reverse=False)`` computes the inclusive scan of
``h_t = a_t * h_{t-1} + b_t`` (``h_t = a_t * h_{t+1} + b_t`` when reverse)
along axis -2 of channels-last ``(..., L, D)`` fp32 tensors. It carries
the SS2D column pair's cross-column state and, forward and reverse, the
backward recompute of both scan pairs.

The CUDA kernel (``csrc/scan.cu``) is one launch a call, planned by
:func:`scan_plan`: a walk (one thread per sequence and channel) where L is
short or the sequences alone fill the card, else a single-pass chunked
scan whose chunks fold their predecessors' published aggregates in a
fixed order (anchors every ``SCAN_ANCHOR`` chunks), so that every run
gives the same bits. Its workspace is cached per device and stream and
never cleared (the flags carry each call's epoch, kept on the device): a
call allocates only h. The plain version (:func:`scan_plain`, shared with
``ss2d_seq``) is the doubling scan: log2(L) elementwise passes. The
backward is the same primitive run in the opposite direction over the
shifted ``a`` and ``h``
(bem_tpu/ops/scan.py:225-254): with lambda_t = g_t + a_{t+1} lambda_{t+1},
db = lambda and da_t = lambda_t h_{t-1}.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ._common import on_cuda, ptr

SCAN_THREADS = 256  # threads of a block of either form
SCAN_SEG = 16       # positions a thread of the look-back form holds (kScanSeg)
SCAN_ANCHOR = 32    # chunks between the look-back form's anchors (at most 32)
WALK_L = 64         # sequences this short are walked
WALK_FILL = 132 * 1024  # (sequence, channel) pairs that fill the card as walkers


class ScanPlan(NamedTuple):
    """How the kernel runs a (M, L, D) scan: ``walk``, or the look-back
    form over nch chunks of P * SCAN_SEG positions x DT channels (P
    threads a channel), with anchors every SCAN_ANCHOR chunks."""
    walk: bool
    DT: int = 0
    P: int = 0
    nch: int = 0


def scan_plan(M: int, L: int, D: int) -> ScanPlan:
    """The walk where L <= WALK_L or M * D >= WALK_FILL; else chunks of
    all D channels (up to SCAN_THREADS of them a block), as many threads a
    channel as a block holds."""
    if L <= WALK_L or M * D >= WALK_FILL:
        return ScanPlan(True)
    DT = min(D, SCAN_THREADS)
    P = SCAN_THREADS // DT
    return ScanPlan(False, DT, P, -(-L // (P * SCAN_SEG)))


# (device index, stream) -> [data (fp32), flags (int32)]
_WORKSPACE: dict = {}


def _workspace(device, M, D, plan):
    """The look-back form's workspace on ``device`` for the current stream,
    cached, each buffer grown when too small (the flags zeroed: the kernel
    keeps its epochs there and never needs them cleared again)."""
    lib = _build.load()
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ws = _WORKSPACE.setdefault(key, [None, None])
    for i, dtype in ((0, torch.float32), (1, torch.int32)):
        n = lib.bem_linear_scan_ws(M, D, plan.DT, plan.nch, SCAN_ANCHOR, i) // 4
        if ws[i] is None or ws[i].numel() < n:
            ws[i] = torch.zeros(n, dtype=dtype, device=device)
    return ws


def scan_plain(a: torch.Tensor, b: torch.Tensor, reverse: bool = False, dim: int = -2):
    """Inclusive scan of h = a * h_prev + b along ``dim`` (h before the
    first position = 0) by doubling; differentiable, any device/dtype."""
    L = a.shape[dim]
    s = 1
    while s < L:
        if reverse:
            b = torch.cat([a.narrow(dim, 0, L - s) * b.narrow(dim, s, L - s)
                           + b.narrow(dim, 0, L - s), b.narrow(dim, L - s, s)], dim)
            a = torch.cat([a.narrow(dim, 0, L - s) * a.narrow(dim, s, L - s),
                           a.narrow(dim, L - s, s)], dim)
        else:
            b = torch.cat([b.narrow(dim, 0, s), a.narrow(dim, s, L - s)
                           * b.narrow(dim, 0, L - s) + b.narrow(dim, s, L - s)], dim)
            a = torch.cat([a.narrow(dim, 0, s), a.narrow(dim, s, L - s)
                           * a.narrow(dim, 0, L - s)], dim)
        s *= 2
    return b


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor, reverse: bool = False):
    """The plain PyTorch version of :func:`linear_scan`, on any device."""
    return scan_plain(a, b, reverse, dim=-2)


def _run(a: torch.Tensor, b: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One scan: the plain version for CPU tensors, the kernel for CUDA ones."""
    if a.shape != b.shape or a.dim() < 2:
        raise ValueError(f"linear_scan: shapes {tuple(a.shape)} / {tuple(b.shape)}")
    if not on_cuda(a, "linear_scan"):
        return linear_scan_plain(a, b, reverse)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"linear_scan: the kernel takes fp32 ({a.dtype}, {b.dtype})")
    if b.device != a.device:
        raise ValueError("linear_scan: a and b on different devices")
    L, D = a.shape[-2:]
    a3 = a.contiguous().reshape(-1, L, D)
    b3 = b.contiguous().reshape(-1, L, D)
    M = a3.shape[0]
    h = torch.empty_like(a3)
    if h.numel() == 0:
        return h.reshape(a.shape)
    plan = scan_plan(M, L, D)
    data, flags = (None, None) if plan.walk else _workspace(a.device, M, D, plan)
    _build.call("bem_linear_scan", ptr(a3), ptr(b3), ptr(h), ptr(data), ptr(flags), M, L, D,
                int(plan.walk), plan.DT, plan.P, plan.nch, SCAN_ANCHOR, int(reverse))
    linear_scan.launches += 1
    return h.reshape(a.shape)


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, reverse):
        h = _run(a, b, reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        ones = torch.ones_like(a.narrow(-2, 0, 1))
        zeros = torch.zeros_like(h.narrow(-2, 0, 1))
        if ctx.reverse:
            # h_t = a_t h_{t+1} + b_t: lambda_t = g_t + a_{t-1} lambda_{t-1}
            # (a forward scan over a shifted down), da_t = lambda_t h_{t+1}
            a_adj = torch.cat([ones, a.narrow(-2, 0, a.shape[-2] - 1)], -2)
            h_adj = torch.cat([h.narrow(-2, 1, h.shape[-2] - 1), zeros], -2)
        else:
            a_adj = torch.cat([a.narrow(-2, 1, a.shape[-2] - 1), ones], -2)
            h_adj = torch.cat([zeros, h.narrow(-2, 0, h.shape[-2] - 1)], -2)
        lam = _run(a_adj, g.contiguous(), not ctx.reverse)
        return lam * h_adj, lam, None


def linear_scan(a: torch.Tensor, b: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` along axis -2
    (``h_t = a_t * h_{t+1} + b_t`` when ``reverse``), walked natively in
    either direction. a, b: (..., L, D), fp32 for CUDA tensors. Returns h
    with the same shape. Differentiable in a and b."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _LinearScan.apply(a, b, bool(reverse))
    return _run(a, b, bool(reverse))


linear_scan.launches = 0
