"""flax params <-> the port's state_dict, for bem_tpu's ``Network`` and ``VSSM``.

The port's modules carry the flax tree's names, so the map is mechanical:
a path ``a/b/leaf`` becomes ``a.b.<leaf'>`` with the layout rules of
bem_tpu/archs/convert_network.py applied in reverse:

- conv ``kernel`` HWIO -> ``weight`` OIHW (depthwise (3,3,1,C) -> (C,1,3,3));
- dense ``kernel`` (in, out) -> ``weight`` (out, in);
- ``mu_kernel`` / ``rho_kernel`` pairs -> ``mu_weight`` / ``rho_weight``, same rules;
- LayerNorm ``scale`` and PReLU ``slope`` -> ``weight``;
- ``mask_token`` (1,1,1,C) -> (1,C,1,1); everything else as it is.

Reference PyTorch checkpoints reach the port by composing with
``bem_tpu.archs.convert_network.convert_network_state`` (torch -> flax).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .nn.layers import LayerNorm2d, PReLU

_KERNELS = {"kernel": "weight", "mu_kernel": "mu_weight", "rho_kernel": "rho_weight"}


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:
        return a.T
    raise ValueError(f"kernel of rank {a.ndim}")


def _to_flax_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2:
        return a.T
    raise ValueError(f"kernel of rank {a.ndim}")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):  # dict or flax FrozenDict
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_state_dict(params) -> dict:
    """flax ``params`` (nested dict of arrays; a ``{"params": ...}`` wrapper
    is unwrapped) -> {torch name: numpy array} in the port's layouts."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    sd = {}
    for path, a in _flatten(params):
        *mods, leaf = path
        a = np.asarray(a, np.float32)
        if leaf in _KERNELS:
            leaf, a = _KERNELS[leaf], _to_torch_layout(a)
        elif leaf in ("scale", "slope"):
            leaf = "weight"
        elif leaf == "mask_token":
            a = a.transpose(0, 3, 1, 2)
        sd[".".join(mods + [leaf])] = np.ascontiguousarray(a)
    return sd


def state_dict_to_flax(module: nn.Module, state=None, subset: bool = False) -> dict:
    """The port's parameters (or ``state``, a {name: tensor} mapping over the
    same names, e.g. a Bayesian weight sample or Adam's moments) -> a nested
    flax params dict; with ``subset``, only the names of ``state`` (e.g. the
    Bayesian prior's)."""
    kinds = {name: type(m) for name, m in module.named_modules()}
    state = dict(state or {}) if subset else dict(module.named_parameters(), **(state or {}))
    tree: dict = {}
    for name, t in state.items():
        a = t.detach().float().cpu().numpy()
        head, _, leaf = name.rpartition(".")
        kind = kinds.get(head)
        if leaf in ("weight", "mu_weight", "rho_weight") and kind is LayerNorm2d:
            leaf = "scale"
        elif leaf == "weight" and kind is PReLU:
            leaf = "slope"
        elif leaf in ("weight", "mu_weight", "rho_weight"):
            leaf, a = leaf.replace("weight", "kernel"), _to_flax_layout(a)
        elif leaf == "mask_token":
            a = a.transpose(0, 2, 3, 1)
        node = tree
        for part in head.split(".") if head else []:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def load_flax_params(module: nn.Module, params) -> nn.Module:
    """Load a JAX module's params (numpy arrays) into the port's module, in
    place; every parameter must be matched."""
    sd = {k: torch.tensor(v) for k, v in flax_to_state_dict(params).items()}
    module.load_state_dict(sd, strict=True)
    return module
