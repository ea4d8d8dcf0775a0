"""Fused selective scan over precomputed dt, B, C: kernel 11.

``selective_scan_fused(u, delta, A, B, C, D=None, delta_bias=None,
delta_softplus=True)`` is the counterpart of
bem_tpu/ops/scan_fused.py::selective_scan_fused, with its layout: u and
delta (Bt, K, C, L), B and C (Bt, K, N, L), all in the stream dtype; A
(K*C, N), D and delta_bias (K*C,), fp32. Per (image, direction k, channel)
and state n, from h = 0:

    dt  = softplus(delta + bias)            (softplus optional)
    h_n = exp(dt * A[k, c, n]) * h_n + dt * u * B_n
    y   = sum_n C_n * h_n + D[k, c] * u     (summed n = 0 .. N-1)

rounded once to u's dtype (bem_tpu's code returns u's dtype,
scan_fused.py:125, though its docstring says fp32). There is no -10
clamp on this function, unlike the SS2D scan pairs and the clamped core.

The plain version (:func:`selective_scan_fused_plain`) is bem_tpu's
``_reference_unfolded`` (scan_fused.py:132-155): the decays and inputs
materialized as (Bt*K, L, C*N) fp32 and scanned along L. The wrapper is an
autograd.Function whose backward recomputes through that composition on
:func:`linear_scan` (kernel 7, forward and reverse on the card), as
bem_tpu's custom VJP does (scan_fused.py:168-173); the gradients of A, D
and delta_bias sum over the batch, since bem_tpu broadcasts them
(scan_fused.py:198-210). On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches ``csrc/scan_fused.cu`` or raises,
through the operator ``bem::selective_scan_fused`` (ops/_common.py).

On the card the scan is chunked along L: super-chunks of S positions (S
from the kernel source, :func:`scan_chunk`); where L > S a summary pass
(each super-chunk's decay and end state from 0) and a forward
:func:`..scan.linear_scan` over the super-chunks, then a full pass that
walks every super-chunk at once from the state entering it. Its launches
count the summary and the full pass (1 or 2 a call); the carry counts on
``linear_scan``.
"""

from __future__ import annotations

import torch

from .. import _build
from ._common import STREAM_DTYPES, fresh, need_cuda, operator, ptr, ref_grads, weight
from .scan import linear_scan, linear_scan_plain, scan_cuda
from .ss2d_fused import N_STATES, W_CLAMP, _softplus


def _check(u, delta, A, B, C, D, delta_bias):
    """(Bt, K, C, L, N) after checking shapes and dtypes."""
    if u.dim() != 4:
        raise ValueError(f"selective_scan_fused: u {tuple(u.shape)} is not (Bt, K, C, L)")
    Bt, K, Cd, L = u.shape
    N = A.shape[-1]
    if N not in N_STATES:
        raise ValueError(f"selective_scan_fused: d_state N={N} not in {N_STATES}")
    if u.dtype not in STREAM_DTYPES:
        raise TypeError(f"selective_scan_fused: stream dtype {u.dtype} is not fp32/bf16")
    for name, t, shape in (("delta", delta, u.shape), ("B", B, (Bt, K, N, L)),
                           ("C", C, (Bt, K, N, L))):
        if tuple(t.shape) != tuple(shape) or t.dtype != u.dtype:
            raise ValueError(f"selective_scan_fused: {name} {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(shape)} {u.dtype}")
    for name, t, shape in (("A", A, (K * Cd, N)), ("D", D, (K * Cd,)),
                           ("delta_bias", delta_bias, (K * Cd,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"selective_scan_fused: {name} {tuple(t.shape)} != {shape}")
    return Bt, K, Cd, L, N


def _unfolded(u, delta, A, B, C, D, delta_bias, delta_softplus, scan, clamp=False):
    """bem_tpu's _reference_unfolded on (Bt, K, C, L): fp32 y, differentiable.
    ``scan`` runs the (Bt*K, L, C*N) recurrence; ``clamp`` caps dt*A at -10
    (not the function: the checks' counter-example)."""
    Bt, K, Cd, L = u.shape
    N = A.shape[-1]
    u = u.float()
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float().reshape(K, Cd, 1)
    if delta_softplus:
        delta = _softplus(delta)
    w = delta[..., None] * A.float().reshape(K, Cd, 1, N)              # (Bt, K, C, L, N)
    if clamp:
        w = torch.clamp(w, min=W_CLAMP)
    b = (delta * u)[..., None] * B.float().transpose(2, 3)[:, :, None]
    a2 = torch.exp(w).permute(0, 1, 3, 2, 4).reshape(Bt * K, L, Cd * N)
    b2 = b.permute(0, 1, 3, 2, 4).reshape(Bt * K, L, Cd * N)
    h = scan(a2, b2).reshape(Bt, K, L, Cd, N)
    y = (h * C.float().transpose(2, 3)[:, :, :, None]).sum(-1).transpose(2, 3)
    if D is not None:
        y = y + u * D.float().reshape(K, Cd, 1)
    return y


def selective_scan_fused_plain(u, delta, A, B, C, D=None, delta_bias=None,
                               delta_softplus: bool = True, clamp: bool = False):
    """The plain PyTorch version of :func:`selective_scan_fused`, on any
    device (the doubling scan); y in u's dtype. ``clamp`` gives the
    function with dt*A capped at -10, which the kernel must not compute."""
    _check(u, delta, A, B, C, D, delta_bias)
    y = _unfolded(u, delta, A, B, C, D, delta_bias, delta_softplus, linear_scan_plain, clamp)
    return y.to(u.dtype)


def scan_chunk(M: int, C: int, N: int, L: int) -> int:
    """Positions per super-chunk of the card's chunked scan for M = Bt*K
    sequences of C channels, N states and length L (``super_chunk`` of
    csrc/common.cuh: the fewest super-chunks that fill the card, each a
    multiple of 32 positions)."""
    return _build.load().bem_selective_scan_chunk(M, C, N, L)


def _kernels(u, delta, A, B, C, D, delta_bias, delta_softplus, S):
    """The kernels on checked CUDA tensors (A, D, delta_bias fp32 on u's
    device) at super-chunks of S positions (a multiple of 32): y."""
    Bt, K, Cd, L = u.shape
    N = A.shape[-1]
    M = Bt * K
    args = (int(delta_softplus), int(u.dtype == torch.bfloat16))
    carry = None
    nsc = -(-L // S)
    if nsc > 1:
        # per (sequence, super-chunk): the decay and the end state from 0,
        # then the state leaving each super-chunk
        aprod, hend = (torch.empty((M, nsc, Cd * N), dtype=torch.float32, device=u.device)
                       for _ in range(2))
        _build.call("bem_selective_scan_sum", ptr(u), ptr(delta), ptr(A), ptr(B),
                    ptr(delta_bias), ptr(aprod), ptr(hend), M, K, Cd, L, N, S, *args)
        selective_scan_fused.launches += 1
        carry = scan_cuda(aprod, hend, False)
    y = torch.empty_like(u)
    _build.call("bem_selective_scan_fused", ptr(u), ptr(delta), ptr(A), ptr(B), ptr(C),
                ptr(D), ptr(delta_bias), ptr(carry), ptr(y), M, K, Cd, L, N, S, *args)
    selective_scan_fused.launches += 1
    return y


def _cuda_args(u, delta, A, B, C, D, delta_bias):
    """The inputs checked for the kernels, A / D / delta_bias as fp32
    contiguous copies on u's device."""
    dev = u.device
    for name, t in (("u", u), ("delta", delta), ("B", B), ("C", C)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"selective_scan_fused: {name} must be contiguous on {dev}")
    return (u, delta, weight(A, dev), B, C, weight(D, dev), weight(delta_bias, dev))


def _scan_cpu(u, delta, A, B, C, D, delta_bias, delta_softplus):
    """bem::selective_scan_fused on the CPU: the plain version."""
    return fresh(selective_scan_fused_plain(u, delta, A, B, C, D, delta_bias, delta_softplus),
                 u, delta)


def _scan_cuda(u, delta, A, B, C, D, delta_bias, delta_softplus):
    """bem::selective_scan_fused on the card: the summary pass and its
    carry (kernel 7) where L > S, the full pass."""
    need_cuda(u, "selective_scan_fused")
    Bt, K, Cd, L, N = _check(u, delta, A, B, C, D, delta_bias)
    args = _cuda_args(u, delta, A, B, C, D, delta_bias)
    if u.numel() == 0:
        return torch.empty_like(u)
    return _kernels(*args, delta_softplus, scan_chunk(Bt * K, Cd, N, L))


def _scan_fake(u, delta, A, B, C, D, delta_bias, delta_softplus):
    _check(u, delta, A, B, C, D, delta_bias)
    return u.new_empty(u.shape)


_run = operator(
    "selective_scan_fused", "(Tensor u, Tensor delta, Tensor A, Tensor B, Tensor C, Tensor? D, "
    "Tensor? delta_bias, bool delta_softplus) -> Tensor", _scan_cpu, _scan_cuda, _scan_fake)


class _ScanFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, delta_softplus):
        ctx.delta_softplus = delta_softplus
        if any(ctx.needs_input_grad[:7]):
            ctx.save_for_backward(u, delta, A, B, C, D, delta_bias)
        return _run(u, delta, A, B, C, D, delta_bias, delta_softplus)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.delta_softplus
        grads = ref_grads(ctx.needs_input_grad[:7],
                          lambda *t: _unfolded(*t, sp, linear_scan), g.float(),
                          ctx.saved_tensors)
        return (*grads, None)


def selective_scan_fused(u, delta, A, B, C, D=None, delta_bias=None,
                         delta_softplus: bool = True):
    """Fused selective scan (see the module docstring): y (Bt, K, C, L) in
    u's dtype. Differentiable in every tensor argument."""
    return _ScanFused.apply(u, delta, A, B, C, D, delta_bias, bool(delta_softplus))


selective_scan_fused.launches = 0
