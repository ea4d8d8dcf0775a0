"""The QD paired dataset (counterpart of bem_tpu/qd/dataset.py): low / high
folders, each training sample a random crop (reflect-padded up to the patch
first), a horizontal and a vertical flip and a rot90, drawn from a seeded
numpy Generator in bem_tpu's order. Images are HWC RGB float32 in [0, 1].
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.img_util import imread

_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def _listed(folder):
    return sorted(os.path.join(folder, f) for f in os.listdir(folder)
                  if f.lower().endswith(_EXTS))


class PairDataset:
    def __init__(self, low_dir: str, high_dir: str, patch_size: int = 256,
                 train: bool = True, seed=None):
        self.low_paths = _listed(low_dir)
        self.high_paths = _listed(high_dir)
        if len(self.low_paths) != len(self.high_paths):
            raise ValueError(f"{low_dir} holds {len(self.low_paths)} images, {high_dir} "
                             f"{len(self.high_paths)}")
        self.patch_size = patch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.opt = {"name": "QDPair"}  # the loader's dataset name

    def __len__(self):
        return len(self.low_paths)

    def __getitem__(self, idx):
        low = imread(self.low_paths[idx])
        high = imread(self.high_paths[idx])
        if self.train:
            p = self.patch_size
            h, w = low.shape[:2]
            if h < p or w < p:
                pad = ((0, max(0, p - h)), (0, max(0, p - w)), (0, 0))
                low, high = np.pad(low, pad, mode="reflect"), np.pad(high, pad, mode="reflect")
                h, w = low.shape[:2]
            top = int(self.rng.integers(0, h - p + 1))
            left = int(self.rng.integers(0, w - p + 1))
            low = low[top:top + p, left:left + p]
            high = high[top:top + p, left:left + p]
            if self.rng.random() < 0.5:
                low, high = low[:, ::-1], high[:, ::-1]
            if self.rng.random() < 0.5:
                low, high = low[::-1], high[::-1]
            k = int(self.rng.integers(0, 4))
            low, high = np.rot90(low, k), np.rot90(high, k)
        return {"low": np.ascontiguousarray(low), "high": np.ascontiguousarray(high),
                "low_path": self.low_paths[idx], "high_path": self.high_paths[idx]}
