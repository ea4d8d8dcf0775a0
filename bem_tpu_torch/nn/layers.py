"""Core layers, channel-first, with the Bayesian (mean-field Gaussian) form.

Counterpart of bem_tpu/nn/layers.py. A layer built with ``bayesian=True``
holds ``mu_<name>`` / ``rho_<name>`` pairs instead of ``<name>`` and runs
on ``mu`` (deterministic mode). A weight sample ``w = mu + softplus(rho) *
eps`` is drawn only when a generator or an injected ``eps`` is given, by
:func:`sample_bayes`, and applied with ``torch.func.functional_call``:
K-sample inference is K samples and K calls.

Parameter names mirror the flax tree (``bem_tpu_torch.convert`` maps them);
the layouts are PyTorch's: conv weights OIHW, dense weights (out, in).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops._common import layer_norm_c
from . import init


def rho_from_sigma(sigma: float) -> float:
    """Inverse softplus used for the rho init (bem_tpu layers.rho_from_sigma)."""
    return math.log(math.expm1(abs(sigma)) + 1e-20)


class BayesLayer(nn.Module):
    """Declares ``<name>`` or, when Bayesian, ``mu_<name>`` + ``rho_<name>``."""

    def __init__(self, bayesian: bool, sigma_init: float):
        super().__init__()
        self.bayesian = bayesian
        self.sigma_init = sigma_init

    def _declare(self, name: str, shape) -> None:
        names = (f"mu_{name}", f"rho_{name}") if self.bayesian else (name,)
        for n in names:
            self.register_parameter(n, nn.Parameter(torch.empty(shape)))

    def value(self, name: str):
        """The weight in use: ``mu_<name>`` (possibly swapped for a sample by
        functional_call) or the plain ``<name>``; None if not declared."""
        return getattr(self, f"mu_{name}" if self.bayesian else name, None)

    def weights(self):
        """(weight, bias) in use; bias is None for a layer without one."""
        return self.value("weight"), self.value("bias")

    @torch.no_grad()
    def _init(self, name: str, draw) -> None:
        draw(self.value(name))
        if self.bayesian:
            getattr(self, f"rho_{name}").fill_(rho_from_sigma(self.sigma_init))


def sample_bayes(module: nn.Module, gen=None, eps=None) -> dict:
    """One weight sample of every Bayesian parameter pair in ``module``.

    Returns ``{name of mu_*: mu + softplus(rho) * eps}`` for
    ``torch.func.functional_call``; ``eps`` is drawn from ``gen`` in
    ``named_parameters`` order, on the generator's device (so a CPU
    generator gives the same sample to a module on any device), or taken
    from the injected ``eps`` dict under the same names. With neither,
    returns {} and the module runs on mu.
    """
    if gen is None and eps is None:
        return {}
    params = dict(module.named_parameters())
    out = {}
    for name, mu in params.items():
        head, _, leaf = name.rpartition(".")
        if not leaf.startswith("mu_"):
            continue
        rho = params[(head + "." if head else "") + "rho_" + leaf[3:]]
        e = eps[name] if eps is not None else torch.randn(
            mu.shape, generator=gen, device=gen.device, dtype=mu.dtype)
        out[name] = mu + F.softplus(rho) * e.to(mu.device)
    return out


class Conv2d(BayesLayer):
    """NCHW conv with bem_tpu Conv2d's init and Bayesian form; runs in the
    input's dtype (weights cast at use, as the JAX layer does)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 padding: int = 0, groups: int = 1,
                 bias: bool = True, bayesian: bool = False,
                 sigma_init: float = 0.05, weight_init: str = "default",
                 zero_bias: bool = False, stride: int = 1):
        super().__init__(bayesian, sigma_init)
        self.padding, self.groups, self.stride = padding, groups, stride
        self.weight_init, self.zero_bias = weight_init, zero_bias
        self.fan_in = in_ch // groups * kernel_size * kernel_size
        self.fan_out = out_ch * kernel_size * kernel_size
        self._declare("weight", (out_ch, in_ch // groups, kernel_size, kernel_size))
        if bias:
            self._declare("bias", (out_ch,))

    def reset_parameters(self, gen):
        if self.weight_init == "kaiming_normal_fan_out":
            self._init("weight", lambda t: init.kaiming_normal_(t, self.fan_out, 1.0, gen))
        elif self.weight_init == "kaiming_normal_fan_in":
            self._init("weight", lambda t: init.kaiming_normal_(t, self.fan_in, 1.0, gen))
        elif self.weight_init == "kaiming_uniform_relu":
            self._init("weight", lambda t: init.uniform_(t, math.sqrt(6.0 / self.fan_in), gen))
        elif self.weight_init == "laplacian":
            # the QD sharpening conv: the Laplacian on every channel pair / C
            lap = torch.tensor([[0., -1., 0.], [-1., 4., -1.], [0., -1., 0.]])
            self._init("weight", lambda t: t.copy_((lap / t.shape[0]).expand(t.shape)))
        else:
            self._init("weight", lambda t: init.torch_default_(t, self.fan_in, gen))
        if self.value("bias") is not None:
            if self.zero_bias:
                self._init("bias", lambda t: t.zero_())
            else:
                self._init("bias", lambda t: init.torch_default_(t, self.fan_in, gen))

    def forward(self, x):
        w, b = self.weights()
        return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                        self.stride, self.padding, 1, self.groups)


class ConvTranspose2d(nn.Module):
    """Transposed conv with kernel == stride (bem_tpu ConvTranspose2d, the
    Decomp family's k2 s2 up-sampling), NCHW.

    ``weight`` is (out, in, kh, kw) in the flax kernel's tap order: the
    layout the conv rule of ``bem_tpu_torch.convert`` gives the flax
    (kh, kw, in, out) kernel. ``lax.conv_transpose`` (no
    ``transpose_kernel``) places the taps mirrored against torch's
    ``conv_transpose2d``, so the forward mirrors them and swaps in / out:
    torch's weight is ``kernel[::-1, ::-1].transpose(2, 3, 0, 1)``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 2):
        super().__init__()
        self.stride = kernel_size
        self.fan_in = in_ch * kernel_size * kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch))

    def reset_parameters(self, gen):
        init.torch_default_(self.weight, self.fan_in, gen)
        init.torch_default_(self.bias, self.fan_in, gen)

    def forward(self, x):
        w = self.weight.flip(2, 3).transpose(0, 1).to(x.dtype)
        return F.conv_transpose2d(x, w, self.bias.to(x.dtype), self.stride)


class Dense(BayesLayer):
    """Linear over the channel axis (dim 1); weight (out, in). ``weight_init``
    "trunc_normal" (trunc_normal(0.02), the VSSM head, vssm.py:161-162),
    "kaiming_uniform_relu" (U(+-sqrt(6 / in))) and "xavier_uniform"
    (U(+-sqrt(6 / (in + out)))) zero the bias."""

    _BOUNDS = {"kaiming_uniform_relu": lambda i, o: math.sqrt(6.0 / i),
               "xavier_uniform": lambda i, o: math.sqrt(6.0 / (i + o))}

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 bayesian: bool = False, sigma_init: float = 0.05,
                 weight_init: str = "default"):
        super().__init__(bayesian, sigma_init)
        self.in_features, self.out_features = in_features, out_features
        self.weight_init = weight_init
        self._declare("weight", (out_features, in_features))
        if bias:
            self._declare("bias", (out_features,))

    def reset_parameters(self, gen):
        if self.weight_init in self._BOUNDS:
            bound = self._BOUNDS[self.weight_init](self.in_features, self.out_features)
            self._init("weight", lambda t: init.uniform_(t, bound, gen))
            if self.value("bias") is not None:
                self._init("bias", lambda t: t.zero_())
            return
        if self.weight_init == "trunc_normal":
            self._init("weight", lambda t: init.trunc_normal_(t, 0.02, gen=gen))
            if self.value("bias") is not None:
                self._init("bias", lambda t: t.zero_())
            return
        self._init("weight", lambda t: init.torch_default_(t, self.in_features, gen))
        if self.value("bias") is not None:
            self._init("bias", lambda t: init.torch_default_(t, self.in_features, gen))

    def forward(self, x):
        w, b = self.weights()
        y = torch.einsum("oc,bc...->bo...", w.to(x.dtype), x)
        if b is not None:
            y = y + b.to(x.dtype).reshape((1, -1) + (1,) * (x.dim() - 2))
        return y


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel axis of NCHW / (B, C, L); eps 1e-5, the VSS
    blocks' (flax's ``nn.LayerNorm`` default, 1e-6, where a module keeps it)."""

    def __init__(self, C: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(C))
        self.bias = nn.Parameter(torch.empty(C))

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return layer_norm_c(x.float(), self.weight, self.bias, self.eps).to(x.dtype)


def dropout_mask(shape, rate: float, gen) -> torch.Tensor:
    """The keep mask of elementwise dropout at ``rate``: uniform < 1 - rate,
    drawn from ``gen`` on its device (bool, ``shape``)."""
    return torch.rand(shape, generator=gen, device=gen.device) < 1.0 - rate


def dropout(x, rate: float, gen=None, mask=None):
    """Elementwise dropout (bem_tpu/nn/ss2d.py:604-607): x / keep where the
    keep mask is set, 0 elsewhere; the mask (bool, x's shape) drawn from
    ``gen`` or given; with neither, or at rate 0, x passes unchanged."""
    if rate == 0.0 or (gen is None and mask is None):
        return x
    if mask is None:
        mask = dropout_mask(x.shape, rate, gen)
    return torch.where(mask.to(x.device), x / (1.0 - rate), torch.zeros_like(x))


def drop_path(x, rate: float, gen=None, mask=None):
    """Per-sample stochastic depth (layers.py:359-371): with keep = 1 - rate,
    each sample is x / keep where its mask is set and 0 elsewhere. The mask
    (B,) bool is drawn as uniform < keep from ``gen`` (on its device) or
    given; with neither, or at rate 0, x passes unchanged (eval)."""
    if rate == 0.0 or (gen is None and mask is None):
        return x
    if mask is None:
        mask = dropout_mask((x.shape[0],), rate, gen)
    mask = mask.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


class DropPath(nn.Module):
    """:func:`drop_path` at a fixed rate; no parameters."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, gen=None, mask=None):
        return drop_path(x, self.rate, gen, mask)


class PReLU(nn.Module):
    """Channel-shared PReLU, slope 0.25 at init."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.weight.fill_(0.25)

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def pixel_shuffle_cf(x, factor: int):
    """(B, C*r^2, H, W) -> (B, C, H*r, W*r), torch PixelShuffle channel order."""
    return F.pixel_shuffle(x, factor)
