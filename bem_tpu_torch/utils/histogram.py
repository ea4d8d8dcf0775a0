"""Per-patch Gaussian-KDE histograms, the "histogram" condition mode
(counterpart of bem_tpu/utils/histogram.py): bandwidth 0.1 (variance
0.01), bins on linspace(0, 1, bins), +1e-5, normalised per patch. Host
code: the native library's threaded kernel (``bem_tpu_torch.native``)
where it builds, else numpy, one patch row at a time, so the (patches,
pixels, 3, bins) kernel values never exist for the whole image at once.
"""

from __future__ import annotations

import numpy as np


def compute_histograms(image: np.ndarray, patch_size: int = 8, bin_count: int = 256) -> np.ndarray:
    """(H, W, 3) in [0,1] -> (C, H//p, W//p, bins) KDE histograms: the
    native kernel when the library is available, else numpy."""
    from ..native import kde_histograms

    out = kde_histograms(np.ascontiguousarray(image, np.float32), patch_size, bin_count)
    if out is not None:
        return out
    return _compute_histograms_np(image, patch_size, bin_count)


def _compute_histograms_np(image: np.ndarray, patch_size: int = 8,
                           bin_count: int = 256) -> np.ndarray:
    """The numpy route of :func:`compute_histograms`."""
    H, W, C = image.shape
    if C != 3:
        raise ValueError(f"compute_histograms: the image must have 3 channels, has {C}")
    pad_h = (patch_size - H % patch_size) % patch_size
    pad_w = (patch_size - W % patch_size) % patch_size
    if pad_h or pad_w:
        image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
    H, W, _ = image.shape
    nh, nw = H // patch_size, W // patch_size
    patches = image.reshape(nh, patch_size, nw, patch_size, C).transpose(0, 2, 1, 3, 4)
    flat = patches.reshape(nh, nw, patch_size * patch_size, C)
    bins = np.linspace(0.0, 1.0, bin_count, dtype=np.float32)
    kde = np.empty((nh, nw, C, bin_count), np.float32)
    for i in range(nh):  # kde[i,j,c,b] = mean_pix exp(-0.5 (x - b)^2 / 0.01)
        d = flat[i, ..., None] - bins  # (nw, P, C, bins)
        kde[i] = np.exp(-0.5 * d.astype(np.float32) ** 2 / 0.01).mean(axis=1)
    kde = kde + 1e-5
    kde = kde / kde.sum(axis=-1, keepdims=True)
    return kde.transpose(2, 0, 1, 3)


def histogram_condition(image: np.ndarray, patch_size: int, bin_count: int) -> np.ndarray:
    """(H//p, W//p, bins*C) channels-last, bin-major channel order
    (paired_image_dataset.py:356-364)."""
    kde = compute_histograms(image, patch_size, bin_count)  # (C, nh, nw, B)
    stacked = kde.transpose(3, 0, 1, 2)  # (B, C, nh, nw)
    B, C, nh, nw = stacked.shape
    return stacked.reshape(B * C, nh, nw).transpose(1, 2, 0)
