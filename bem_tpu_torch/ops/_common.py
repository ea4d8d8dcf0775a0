"""Argument handling, math and operator registration shared by the kernel
wrappers.

A wrapper runs its kernel's plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. Nothing falls back.

Each kernel row's launch sequence is a ``torch.library`` operator in the
``bem`` namespace (:func:`operator`): its CUDA implementation launches the
kernels, its CPU implementation is the plain version, and its fake
implementation gives the outputs' shapes and dtypes only, so that
``torch.export`` can trace a net on any machine without building the
kernels. Importing ``bem_tpu_torch.ops`` registers every operator.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils import flop_counter

STREAM_DTYPES = (torch.float32, torch.bfloat16)


def on_cuda(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: unsupported device {x.device}")


def need_cuda(x: torch.Tensor, name: str) -> None:
    """A CUDA implementation's guard: its stream tensor lies on the card
    (the dispatcher picks it where any argument does)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes a CUDA stream, not one on {x.device}")


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


# the port's operators: bem::<name>
OPS = torch.library.Library("bem", "DEF")


def _device_type(args) -> str:
    """The device type of the first tensor among ``args`` (or in a list)."""
    for a in args:
        if isinstance(a, (list, tuple)):
            a = next((t for t in a if isinstance(t, torch.Tensor)), None)
        if isinstance(a, torch.Tensor):
            return a.device.type
    raise ValueError("a bem operator was called without a tensor")


def operator(name: str, schema: str, cpu, cuda, fake):
    """Define ``bem::<name><schema>`` with its CPU (plain version), CUDA
    (kernels) and fake (shapes only) implementations; returns the overload.

    FlopCounterMode would see an operator's call and nothing of its work:
    under it the implementation runs with the mode active, so that
    ``count_flops`` sees what the plain version or the kernels do, as it did
    before the operator existed (the wrappers' ``counted_as`` statements
    then replace what it saw)."""
    OPS.define(name + schema)
    OPS.impl(name, cpu, "CPU")
    OPS.impl(name, cuda, "CUDA")
    qualname = f"bem::{name}"

    def shapes_only(*args):  # the Meta kernel too: a meta tensor is refused
        device = _device_type(args)
        if device not in ("cpu", "cuda"):
            raise RuntimeError(f"{name}: unsupported device {device}")
        return fake(*args)

    torch.library.register_fake(qualname, shapes_only, lib=OPS)

    def under_flop_counter(mode, func, types, args, kwargs):
        impl = cuda if _device_type(args) == "cuda" else cpu
        with mode:
            return impl(*args, **kwargs)

    torch.library.register_torch_dispatch(qualname, flop_counter._FlopCounterMode,
                                          under_flop_counter, lib=OPS)
    return getattr(torch.ops.bem, name).default


def fresh(out, *inputs):
    """``out``, contiguous and sharing no tensor object with ``inputs`` (an
    operator's output may not alias its inputs)."""
    out = out.contiguous()
    return out.clone() if any(out is t for t in inputs) else out


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


class FlopTally:
    """What ``analysis.count_flops`` counts of the kernel wrappers' work:
    ``seen``, the FLOPs its FlopCounterMode ``counter`` saw inside them
    (their plain versions' matmuls on the CPU, none where a kernel runs),
    and ``stated``, the FLOPs the wrappers state for the same work."""

    def __init__(self, counter):
        self.counter, self.seen, self.stated = counter, 0, 0
        self.depth = 0  # open statements: only the outermost counts


FLOP_TALLIES: list = []  # the open tallies, innermost last


@contextlib.contextmanager
def counted_as(flops: int):
    """Count the enclosed work as ``flops`` in the open tally, if any, in
    place of what FlopCounterMode sees of it: the count then does not
    depend on whether a kernel or its plain version ran."""
    if not FLOP_TALLIES or FLOP_TALLIES[-1].depth:
        yield  # no tally, or a wrapper already stated the enclosing work
        return
    tally = FLOP_TALLIES[-1]
    before = tally.counter.get_total_flops()
    tally.depth += 1
    try:
        yield
    finally:
        tally.depth -= 1
    tally.seen += tally.counter.get_total_flops() - before
    tally.stated += flops
