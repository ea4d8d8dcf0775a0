"""First-order linear recurrence: kernel 7, counterpart of bem_tpu/ops/scan.py.

``linear_scan(a, b, reverse=False)`` computes the inclusive scan of
``h_t = a_t * h_{t-1} + b_t`` (``h_t = a_t * h_{t+1} + b_t`` when reverse)
along axis -2 of channels-last ``(..., L, D)`` fp32 tensors. It carries
the SS2D column pair's cross-column state and, forward and reverse, the
backward recompute of both scan pairs.

The CUDA kernel (``csrc/scan.cu``) is a chunked three-pass scan; the plain
version (:func:`scan_plain`, shared with ``ss2d_seq``) is the doubling
scan: log2(L) elementwise passes. The backward is the same primitive run
in the opposite direction over the shifted ``a`` and ``h``
(bem_tpu/ops/scan.py:225-254): with lambda_t = g_t + a_{t+1} lambda_{t+1},
db = lambda and da_t = lambda_t h_{t-1}.
"""

from __future__ import annotations

import torch

from .. import _build
from ._common import on_cuda, ptr

SCAN_CHUNK = 64  # positions per chunk of the CUDA kernel


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
    nch = -(-L // SCAN_CHUNK)
    aprod = torch.empty((M, nch, D), dtype=torch.float32, device=a.device)
    hend = torch.empty_like(aprod)
    _build.call("bem_linear_scan", ptr(a3), ptr(b3), ptr(h), ptr(aprod), ptr(hend),
                M, L, D, SCAN_CHUNK, int(reverse))
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
    return _LinearScan.apply(a, b, bool(reverse))


linear_scan.launches = 0
