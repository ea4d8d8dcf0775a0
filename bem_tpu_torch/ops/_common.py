"""Argument handling and math shared by the kernel wrappers.

A wrapper runs its kernel's plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import torch

STREAM_DTYPES = (torch.float32, torch.bfloat16)


def on_cuda(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: unsupported device {x.device}")


def check_stream(name: str, x: torch.Tensor, shape=None) -> None:
    if x.dtype not in STREAM_DTYPES:
        raise TypeError(f"{name}: stream dtype {x.dtype} is not fp32/bf16")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: stream tensor must be contiguous")


def weight(t, device, shape=None, name="weight"):
    """fp32 contiguous copy of a small parameter on ``device`` (None passes)."""
    if t is None:
        return None
    t = t.detach().to(device=device, dtype=torch.float32).contiguous()
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    return t


def ptr(t):
    return None if t is None else t.data_ptr()


def layer_norm_c(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over dim 1 of an fp32 tensor (centred variance)."""
    m = x.mean(dim=1, keepdim=True)
    v = (x - m).square().mean(dim=1, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - m) * torch.rsqrt(v + eps) * scale.reshape(shape) + bias.reshape(shape)


def softplus(v: torch.Tensor) -> torch.Tensor:
    """log(1 + e^v) as jax.nn.softplus computes it (logaddexp(v, 0))."""
    return torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """The fp32 value a bf16 cast keeps (round-to-nearest-even)."""
    return t.to(torch.bfloat16).to(torch.float32)


def ref_grads(need, fn, g, inputs):
    """Gradients of ``fn(*inputs)`` for cotangent g with respect to each
    input whose ``need`` flag is set (None elsewhere): the backward of an
    autograd.Function that recomputes through a differentiable oracle."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(bool(n)) if t is not None else None
               for t, n in zip(inputs, need)]
        wrt = [t for t, n in zip(ins, need) if t is not None and n]
        grads = iter(torch.autograd.grad(fn(*ins), wrt, g) if wrt else ())
    return [next(grads) if t is not None and n else None for t, n in zip(ins, need)]
