"""Initializers with the distributions of bem_tpu/nn/init.py.

Every draw takes an explicit ``torch.Generator``. The distributions match
the JAX package's (torch-default kaiming-uniform a=sqrt(5), the mamba
dt/A/D inits, trunc-normal, kaiming-normal); the values do not, since the
two frameworks' generators differ. Fans are computed on the JAX layout of
each shape, so e.g. the (4, R+2N, d_inner) x_proj weight gets the same
bound it gets in bem_tpu.
"""

from __future__ import annotations

import math

import torch


def jax_fans(shape):
    """bem_tpu's _conv_fans on a JAX-layout shape (HWIO, (in, out), ...)."""
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)
    return t


def torch_default_(t, fan_in: int, gen):
    """kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in)); also the bias init."""
    return uniform_(t, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, gen)


@torch.no_grad()
def kaiming_normal_(t, fan: int, gain: float, gen):
    t.copy_(torch.randn(t.shape, generator=gen) * (gain / math.sqrt(fan)))
    return t


@torch.no_grad()
def trunc_normal_(t, std=0.02, mean=0.0, a=-2.0, b=2.0, gen=None):
    """timm trunc_normal_ (a, b absolute bounds), by inverse CDF."""
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    lo, hi = cdf((a - mean) / std), cdf((b - mean) / std)
    u = torch.rand(t.shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    t.copy_((mean + std * z).clamp(a, b))
    return t


def dt_proj_weight_(t, dt_rank: int, gen):
    """U(+-dt_rank^-0.5) (dt_scale 1, dt_init "random")."""
    return uniform_(t, dt_rank ** -0.5, gen)


@torch.no_grad()
def dt_proj_bias_(t, gen, dt_min, dt_max, dt_init_floor):
    """softplus(bias) ~ LogUniform(dt_min, dt_max), floored."""
    u = torch.rand(t.shape, generator=gen)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp(min=dt_init_floor)
    t.copy_(dt + torch.log(-torch.expm1(-dt)))
    return t


@torch.no_grad()
def a_log_(t):
    """S4D-real: A_log[..., n] = log(n + 1)."""
    n = t.shape[-1]
    t.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(t.shape))
    return t


def initialize(module: torch.nn.Module, gen: torch.Generator):
    """Draw every parameter of ``module`` from ``gen`` (a CPU generator):
    each submodule with a ``reset_parameters(gen)`` initializes its own."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(gen)
    return module
