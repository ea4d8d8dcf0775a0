"""Perceptual (VGG19-feature) loss, the counterpart of bem_tpu/losses/perceptual.py.

The VGG19 feature stack runs NCHW on plain ``F.conv2d`` (bem_tpu computes
these convolutions outside any Pallas kernel); the loss takes the trainer's
NHWC images. Weights come from, in order:

  1. ``BEM_VGG19_WEIGHTS`` (a .npz of HWIO conv kernels, tools/convert_vgg19.py's
     layout: ``conv1_1.kernel``, ``conv1_1.bias``, ...), or
  2. ``~/.cache/bem_tpu/vgg19_features.npz``;
  3. otherwise construction raises ``FileNotFoundError``, unless
     ``BEM_ALLOW_RANDOM_VGG=1`` opts into He-initialised random features drawn
     from ``np.random.default_rng(19)`` in bem_tpu's order (the two packages
     then hold the same weights). Random features are for smoke runs, never
     for results.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.logger import get_root_logger

# VGG19's feature layers: (name, out_channels), a 2x2 max-pool after each block
VGG19_LAYERS = [
    ("conv1_1", 64), ("conv1_2", 64), ("pool1", 0),
    ("conv2_1", 128), ("conv2_2", 128), ("pool2", 0),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), ("pool3", 0),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512), ("pool4", 0),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512), ("pool5", 0),
]

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _load_vgg_weights() -> Dict[str, np.ndarray]:
    """{``<layer>.kernel`` HWIO, ``<layer>.bias``} as numpy arrays."""
    paths = []
    if os.environ.get("BEM_VGG19_WEIGHTS"):
        paths.append(os.environ["BEM_VGG19_WEIGHTS"])
    paths.append(os.path.expanduser("~/.cache/bem_tpu/vgg19_features.npz"))
    for p in paths:
        if os.path.exists(p):
            with np.load(p) as data:
                return {k: data[k] for k in data.files}
    if os.environ.get("BEM_ALLOW_RANDOM_VGG") != "1":
        raise FileNotFoundError(
            "VGG19 feature weights not found. Convert them once with "
            "tools/convert_vgg19.py (needs torchvision / egress) and point "
            "BEM_VGG19_WEIGHTS at the .npz, or set BEM_ALLOW_RANDOM_VGG=1 to "
            "explicitly opt into fixed-seed random features (NOT parity).")
    get_root_logger().warning(
        "BEM_ALLOW_RANDOM_VGG=1: using fixed-seed random VGG features for "
        "the perceptual loss — results will not match the reference.")
    rng = np.random.default_rng(19)
    weights = {}
    in_ch = 3
    for name, out_ch in VGG19_LAYERS:
        if name.startswith("pool"):
            continue
        weights[f"{name}.kernel"] = (rng.standard_normal((3, 3, in_ch, out_ch))
                                     * np.sqrt(2.0 / (in_ch * 9))).astype(np.float32)
        weights[f"{name}.bias"] = np.zeros((out_ch,), np.float32)
        in_ch = out_ch
    return weights


class VGGFeatureExtractor:
    """VGG19 through the deepest requested layer; each requested feature is
    taken before its ReLU."""

    def __init__(self, layer_name_list: Sequence[str], vgg_type: str = "vgg19",
                 use_input_norm: bool = True, range_norm: bool = False, device="cuda"):
        if vgg_type != "vgg19":
            raise NotImplementedError("only vgg19 is wired (all BEM configs use it)")
        self.layer_name_list = list(layer_name_list)
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        names = [n for n, _ in VGG19_LAYERS]
        self.layers = VGG19_LAYERS[: max(names.index(n) for n in self.layer_name_list) + 1]
        w = _load_vgg_weights()
        dev = torch.device(device)
        # HWIO -> OIHW
        self.weights = {n: (torch.from_numpy(np.ascontiguousarray(
                                w[f"{n}.kernel"].transpose(3, 2, 0, 1))).float().to(dev),
                            torch.from_numpy(np.asarray(w[f"{n}.bias"])).float().to(dev))
                        for n, _ in self.layers if not n.startswith("pool")}
        self.mean = torch.tensor(_MEAN, device=dev).reshape(1, 3, 1, 1)
        self.std = torch.tensor(_STD, device=dev).reshape(1, 3, 1, 1)

    def __call__(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: NHWC RGB in [0, 1] (or [-1, 1] with range_norm) -> {name: NCHW feature}."""
        h = x.permute(0, 3, 1, 2)
        if self.range_norm:
            h = (h + 1.0) / 2.0
        if self.use_input_norm:
            h = (h - self.mean) / self.std
        feats = {}
        for name, _ in self.layers:
            if name.startswith("pool"):
                h = F.max_pool2d(h, 2, 2)
                continue
            k, b = self.weights[name]
            h = F.conv2d(h, k.to(h.dtype), b.to(h.dtype), padding=1)
            if name in self.layer_name_list:
                feats[name] = h
            h = F.relu(h)
        return feats


class PerceptualLoss:
    """Weighted VGG feature distance and the optional Gram style loss;
    returns (perceptual or None, style or None)."""

    def __init__(self, layer_weights: Dict[str, float], vgg_type: str = "vgg19",
                 use_input_norm: bool = True, range_norm: bool = False,
                 perceptual_weight: float = 1.0, style_weight: float = 0.0,
                 criterion: str = "l1", device="cuda"):
        if criterion not in ("l1", "l2", "mse", "fro"):
            raise NotImplementedError(criterion)
        self.layer_weights = layer_weights
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion_type = criterion
        self.vgg = VGGFeatureExtractor(list(layer_weights), vgg_type, use_input_norm,
                                       range_norm, device)

    def _dist(self, a, b):
        if self.criterion_type == "l1":
            return (a - b).abs().mean()
        if self.criterion_type == "fro":
            return torch.linalg.vector_norm(a - b)
        return (a - b).square().mean()

    @staticmethod
    def _gram(x):
        """(n, c, c) Gram matrix / (c h w), bem_tpu's (c, d) order."""
        n, c, h, w = x.shape
        f = x.reshape(n, c, h * w)
        return f @ f.transpose(1, 2) / (c * h * w)

    def __call__(self, x, gt):
        xf = self.vgg(x)
        with torch.no_grad():
            gtf = self.vgg(gt)
        percep = style = None
        if self.perceptual_weight > 0:
            percep = sum(self._dist(xf[k], gtf[k]) * w
                         for k, w in self.layer_weights.items()) * self.perceptual_weight
        if self.style_weight > 0:
            style = sum(self._dist(self._gram(xf[k]), self._gram(gtf[k])) * w
                        for k, w in self.layer_weights.items()) * self.style_weight
        return percep, style


def build_perceptual(opt: dict, device="cuda") -> PerceptualLoss:
    opt = dict(opt)
    opt.pop("type", None)
    return PerceptualLoss(**opt, device=device)
