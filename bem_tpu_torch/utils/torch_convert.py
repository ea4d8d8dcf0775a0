"""Reference PyTorch state_dict -> flax-layout params primitives (counterpart
of bem_tpu/utils/torch_convert.py), numpy only.

The released reference checkpoints (``ckpt.pth``) hold torch layouts;
bem_tpu's converters turn them into its flax tree, and the port loads
that tree with ``convert.load_flax_params``. The layout rules:

- Conv2d weight OIHW -> HWIO: ``transpose(2, 3, 1, 0)``
- ConvTranspose2d weight (I, O, kh, kw) -> HWIO with both spatial axes
  flipped
- Linear weight (out, in) -> (in, out)
- LayerNorm / GroupNorm weight -> scale
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

def conv_kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def conv_transpose_kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])


def linear_kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def torch_load(path: str):
    """A ``.pth`` file's object, read on the CPU with ``weights_only``."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def to_numpy(sd) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def assemble(mapping: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """'/'-joined flat paths -> nested params dict."""
    tree: Dict[str, Any] = {}
    for path, v in mapping.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.asarray(v)
    return tree
