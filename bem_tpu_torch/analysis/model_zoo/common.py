"""Shared blocks of the baseline model zoo, channel-first (counterpart of
bem_tpu/analysis/model_zoo/common.py).

Module and parameter names are bem_tpu's, so ``bem_tpu_torch.convert``
carries its variables across; where bem_tpu keeps a leaf in its own
layout (MeanShift's HWIO ``weight``), the port keeps that layout too. A
class whose leaves the converter passes as they are names the renames it
needs in ``flax_leaf_names``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...archs.arch_util import resize_bilinear_cf
from ...nn.layers import Conv2d, Dense


class Linear(Dense):
    """Dense over the last axis of a token tensor (B, ..., C): bem_tpu's
    ``Dense`` as the zoo's attention and Mamba blocks apply it."""

    def forward(self, x):
        w, b = self.weights()
        return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


class MeanShift(nn.Module):
    """RGB mean shift as a 1x1 conv (common.py:20-38). ``weight`` stays in
    bem_tpu's HWIO (1, 1, 3, 3) layout."""

    flax_leaf_names: dict = {}

    def __init__(self, rgb_range: float = 255.0,
                 rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040),
                 rgb_std: Sequence[float] = (1.0, 1.0, 1.0), sign: int = -1):
        super().__init__()
        std = np.asarray(rgb_std, np.float32)
        self._w0 = (np.eye(3, dtype=np.float32) / std[:, None]).T.reshape(1, 1, 3, 3)
        self._b0 = sign * rgb_range * np.asarray(rgb_mean, np.float32) / std
        self.weight = nn.Parameter(torch.empty(1, 1, 3, 3))
        self.bias = nn.Parameter(torch.empty(3))

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.weight.copy_(torch.from_numpy(self._w0))
        self.bias.copy_(torch.from_numpy(self._b0))

    def forward(self, x):
        y = torch.einsum("bihw,io->bohw", x, self.weight[0, 0].to(x.dtype))
        return y + self.bias.to(x.dtype)[None, :, None, None]


class CALayer(nn.Module):
    """Channel attention: squeeze, 1x1 down, ReLU, 1x1 up, sigmoid gate
    (common.py:41-58)."""

    def __init__(self, channel: int, reduction: int = 16, use_bias: bool = True):
        super().__init__()
        self.du1 = Conv2d(channel, channel // reduction, 1, bias=use_bias)
        self.du2 = Conv2d(channel // reduction, channel, 1, bias=use_bias)

    def forward(self, x):
        y = self.du2(F.relu(self.du1(x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(y)


class SALayer(nn.Module):
    """Spatial attention over the channel max and mean (common.py:61-74)."""

    def __init__(self, kernel_size: int = 5):
        super().__init__()
        self.conv = Conv2d(2, 1, kernel_size, padding=(kernel_size - 1) // 2, bias=False)

    def forward(self, x):
        y = torch.cat([x.amax(1, keepdim=True), x.mean(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.conv(y))


def dwt_haar(x):
    """HWMNet's Haar DWT (common.py:77-89): (B, C, H, W) -> (B, 4C, H/2,
    W/2), channel blocks [LL, HL, LH, HH]."""
    x01 = x[:, :, 0::2] / 2
    x02 = x[:, :, 1::2] / 2
    x1, x3 = x01[..., 0::2], x01[..., 1::2]
    x2, x4 = x02[..., 0::2], x02[..., 1::2]
    return torch.cat([x1 + x2 + x3 + x4, -x1 - x2 + x3 + x4,
                      -x1 + x2 - x3 + x4, x1 - x2 - x3 + x4], 1)


def iwt_haar(x):
    """Inverse of :func:`dwt_haar` (common.py:92-103)."""
    b, c4, h, w = x.shape
    x1, x2, x3, x4 = (t / 2 for t in x.chunk(4, 1))
    out = x.new_zeros(b, c4 // 4, 2 * h, 2 * w)
    out[:, :, 0::2, 0::2] = x1 - x2 - x3 + x4
    out[:, :, 1::2, 0::2] = x1 - x2 + x3 - x4
    out[:, :, 0::2, 1::2] = x1 + x2 - x3 - x4
    out[:, :, 1::2, 1::2] = x1 + x2 + x3 + x4
    return out


def resize_bilinear_torch(x, size, align_corners: bool = False):
    """Bilinear resize of (B, C, H, W) to ``size`` (common.py:106-133):
    half-pixel centres, antialiased where it shrinks (bem_tpu's
    ``resize_bilinear``), or corner-aligned."""
    if not align_corners:
        return resize_bilinear_cf(x, size)
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class LayerNormLast(nn.Module):
    """LayerNorm over the channels (common.py:136-148): statistics in fp32,
    eps 1e-5, leaves ``weight`` / ``bias``. On channel-first maps (dim 1),
    or, with ``channels_last``, on the last axis of a token tensor."""

    flax_leaf_names: dict = {}

    def __init__(self, C: int, use_bias: bool = True, channels_last: bool = False):
        super().__init__()
        self.dim = -1 if channels_last else 1
        self.weight = nn.Parameter(torch.empty(C))
        self.bias = nn.Parameter(torch.empty(C)) if use_bias else None

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        m = xf.mean(self.dim, keepdim=True)
        v = (xf - m).square().mean(self.dim, keepdim=True)
        shape = (-1,) if self.dim == -1 else (1, -1) + (1,) * (x.dim() - 2)
        y = (xf - m) * torch.rsqrt(v + 1e-5) * self.weight.reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y.to(x.dtype)


class BatchNormInference(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)`` on (B, C, H, W):
    (x - running_mean) * rsqrt(running_var + 1e-5) * weight + bias. Its
    leaves are flax's ``scale`` / ``bias`` and the ``batch_stats``
    collection's ``mean`` / ``var`` (the running buffers)."""

    flax_leaf_names: dict = {"weight": "scale"}

    def __init__(self, C: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(C))
        self.bias = nn.Parameter(torch.empty(C))
        self.register_buffer("running_mean", torch.zeros(C))
        self.register_buffer("running_var", torch.ones(C))

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x - self.running_mean[:, None, None]) * mul[:, None, None]
        return y + self.bias[:, None, None]


def add_blocks(module: nn.Module, name: str, make, n: int) -> list:
    """Register ``n`` blocks ``make(i)`` as ``<name>_<i>`` (bem_tpu's flat
    block names) and return them in order."""
    blocks = [make(i) for i in range(n)]
    for i, blk in enumerate(blocks):
        module.add_module(f"{name}_{i}", blk)
    return blocks


def seeded(net: nn.Module, gen: torch.Generator = None, device="cuda") -> nn.Module:
    """``net`` with every parameter drawn from ``gen`` (a CPU generator;
    seed 0 when omitted), on ``device`` (the card unless the caller asks
    for the CPU), as the zoo's builders return it; a net built under
    ``torch.device("meta")`` (to count it) is returned as it is."""
    from ...nn.init import initialize

    if any(p.is_meta for p in net.parameters()):
        return net
    return initialize(net, gen if gen is not None else torch.Generator().manual_seed(0)).to(device)
