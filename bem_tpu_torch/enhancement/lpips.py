"""LPIPS perceptual distance (counterpart of bem_tpu/enhancement/lpips_jax.py;
the reference uses lpips.LPIPS(net='alex'), Enhancement/eval.py:144).

AlexNet's five feature convolutions (ReLU after each, 3x3 / 2 max-pool
after the first two), each feature map unit-normalised over channels,
the squared difference weighted by the calibrated ``lin`` heads and
averaged. The weights come from the npz at ``BEM_LPIPS_WEIGHTS``
(bem_tpu's tools/convert_lpips.py layout: ``conv{i}.kernel`` HWIO,
``conv{i}.bias``, ``lin{i}.kernel`` (1, 1, C, 1)); without it
construction raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# (name, stride, padding) of AlexNet's feature convolutions
_LAYERS = (("conv1", 4, 2), ("conv2", 1, 2), ("conv3", 1, 1), ("conv4", 1, 1), ("conv5", 1, 1))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS:
    def __init__(self, device="cuda"):
        path = os.environ.get("BEM_LPIPS_WEIGHTS")
        if not path or not os.path.exists(path):
            raise RuntimeError(
                "LPIPS needs trained AlexNet weights: set BEM_LPIPS_WEIGHTS to a converted "
                ".npz (see tools/convert_lpips.py). Zero-egress machines cannot download "
                "them; omit --lpips.")
        self.device = torch.device(device)
        with np.load(path) as data:
            # kernels HWIO -> OIHW
            self.weights = {k: torch.from_numpy(np.ascontiguousarray(
                data[k].transpose(3, 2, 0, 1) if data[k].ndim == 4 else data[k]))
                .float().to(self.device) for k in data.files}

    def _features(self, x):
        h = (x - x.new_tensor(_SHIFT)[:, None, None]) / x.new_tensor(_SCALE)[:, None, None]
        feats = []
        for name, stride, pad in _LAYERS:
            h = F.relu(F.conv2d(h, self.weights[f"{name}.kernel"], self.weights[f"{name}.bias"],
                                stride, pad))
            feats.append(h)
            if name in ("conv1", "conv2"):
                h = F.max_pool2d(h, 3, 2)
        return feats

    @torch.inference_mode()
    def __call__(self, img0: np.ndarray, img1: np.ndarray) -> float:
        """img0 / img1: (H, W, 3) RGB in [0, 1]."""
        x0, x1 = (torch.as_tensor(np.asarray(a, np.float32)).permute(2, 0, 1)[None]
                  .to(self.device) * 2.0 - 1.0 for a in (img0, img1))
        total = 0.0
        for i, (a, b) in enumerate(zip(self._features(x0), self._features(x1))):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            d = F.conv2d((a - b) ** 2, self.weights[f"lin{i}.kernel"])
            total = total + d.mean()
        return float(total)
