"""Fused SS2D tail: kernel 3 of the serving path.

``ss2d_tail_cf(y_row, y_colT, scale, bias, Wout, bout, res=None)``:
y = y_row (+ y_colT) in fp32 -> per-pixel LN over C (centred two-pass
variance, eps 1e-5) -> out_proj (C -> C_out) (+ bout) (+ res). The
ungrouped (G=1) form of bem_tpu/ops/ss2d_tail.py::ss2d_tail_cf; the CUDA
kernel is ``csrc/ss2d_tail.cu``.

On the bf16 stream the LN output is rounded to bf16 before out_proj and
Wout is rounded to bf16, as the Pallas kernel does. Differentiable: the
backward recomputes through :func:`_tail_ref` (ss2d_tail.py:248-273).
"""

from __future__ import annotations

import torch

from .. import _build
from ._common import (check_stream, layer_norm_c, on_cuda, ptr, ref_grads, round_bf16,
                      weight)


def _tail_args(y_row, y_colT, scale, bias, Wout, bout, res):
    B, C, L = y_row.shape
    check_stream("ss2d_tail_cf", y_row)
    if y_colT is not None:
        check_stream("ss2d_tail_cf", y_colT, y_row.shape)
        if y_colT.dtype != y_row.dtype:
            raise TypeError("ss2d_tail_cf: y_row / y_colT dtypes differ")
    dev = y_row.device
    Cout = Wout.shape[1]
    if res is not None:
        check_stream("ss2d_tail_cf", res, (B, Cout, L))
        if res.dtype != y_row.dtype:
            raise TypeError("ss2d_tail_cf: residual dtype differs")
    Wout = weight(Wout, dev, (C, Cout), "Wout")
    if y_row.dtype == torch.bfloat16:
        Wout = round_bf16(Wout)
    return (y_row, y_colT, weight(scale, dev, (C,), "scale"),
            weight(bias, dev, (C,), "bias"), Wout,
            weight(bout, dev, (Cout,), "bout"), res)


def _tail_plain(y_row, y_colT, scale, bias, Wout, bout, res):
    y = y_row.float()
    if y_colT is not None:
        y = y + y_colT.float()
    yn = layer_norm_c(y, scale, bias)
    if y_row.dtype == torch.bfloat16:
        yn = round_bf16(yn)
    out = torch.einsum("cd,bcl->bdl", Wout, yn)
    if bout is not None:
        out = out + bout.reshape(1, -1, 1)
    if res is not None:
        out = out + res.float()
    return out.to(y_row.dtype).contiguous()


def ss2d_tail_cf_plain(y_row, y_colT, scale, bias, Wout, bout, res=None):
    """The plain PyTorch version of :func:`ss2d_tail_cf`, on any device."""
    return _tail_plain(*_tail_args(y_row, y_colT, scale, bias, Wout, bout, res))


def _tail_run(y_row, y_colT, scale, bias, Wout, bout, res):
    args = _tail_args(y_row, y_colT, scale, bias, Wout, bout, res)
    if not on_cuda(y_row, "ss2d_tail_cf"):
        return _tail_plain(*args)
    y_row, y_colT, scale, bias, Wout, bout, res = args
    B, C, L = y_row.shape
    Cout = Wout.shape[1]
    out = torch.empty((B, Cout, L), dtype=y_row.dtype, device=y_row.device)
    _build.call("bem_ss2d_tail", ptr(y_row), ptr(y_colT), ptr(scale),
                ptr(bias), ptr(Wout), ptr(bout), ptr(res), ptr(out),
                B, C, Cout, L, int(y_row.dtype == torch.bfloat16))
    ss2d_tail_cf.launches += 1
    return out


def _tail_ref(y_row, y_colT, scale, bias, Wout, bout, res=None):
    """Oracle of the tail (ss2d_tail.py:125-153, G=1), differentiable in
    every argument: the backward path. It is the plain version with Wout
    rounded to bf16 on the bf16 stream, as the wrapper rounds it."""
    w = round_bf16(Wout.float()) if y_row.dtype == torch.bfloat16 else Wout.float()
    return _tail_plain(y_row, y_colT, scale.float(), bias.float(), w,
                       None if bout is None else bout.float(), res)


class _Tail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_row, y_colT, scale, bias, Wout, bout, res):
        ctx.save_for_backward(y_row, y_colT, scale, bias, Wout, bout, res)
        return _tail_run(y_row, y_colT, scale, bias, Wout, bout, res)

    @staticmethod
    def backward(ctx, g):
        return tuple(ref_grads(ctx.needs_input_grad, _tail_ref, g.contiguous(),
                               ctx.saved_tensors))


def ss2d_tail_cf(y_row, y_colT, scale, bias, Wout, bout, res=None):
    """Merge + LN + out_proj [+ residual]. y_row / y_colT (B, C, L) (y_colT may
    be None); scale/bias (C,); Wout (C, C_out); bout (C_out,) or None; res
    (B, C_out, L) or None. Returns (B, C_out, L) in y_row.dtype. Differentiable."""
    return _Tail.apply(y_row, y_colT, scale, bias, Wout, bout, res)


ss2d_tail_cf.launches = 0
