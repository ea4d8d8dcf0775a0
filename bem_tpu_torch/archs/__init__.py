"""Architectures of the port (counterpart of bem_tpu/archs)."""

from __future__ import annotations

from copy import deepcopy

import torch

from ..nn.init import initialize
from .decomp_archs import DECOMP_ARCHS
from .unet_arch import BasicBlock, Network, SubNetwork

_ARCHS = {"Network": Network, **DECOMP_ARCHS}


def build_network(opt: dict, gen: torch.Generator = None):
    """Build ``opt['type']`` from the remaining keys and draw its weights
    from ``gen`` (a CPU generator; seed 0 when omitted)."""
    opt = deepcopy(opt)
    net = _ARCHS[opt.pop("type")](**opt)
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    return initialize(net, gen)
