"""Effective receptive field (counterpart of bem_tpu/analysis/erf.py).

The ERF is the mean over images of |d(centre feature) / d(input)|,
summed over the input's channels.
"""

from __future__ import annotations

import numpy as np
import torch


def effective_receptive_field(fn, images, device="cuda") -> np.ndarray:
    """``fn`` (B, H, W, 3) -> (B, H', W', C) features, or a list of them
    (the last is used); images (N, H, W, 3), fed one at a time on
    ``device`` (the card unless the caller asks for the CPU). Returns the (H, W) map: the
    mean over images of |gradient| of the centre feature's channel sum
    with respect to each input pixel, summed over the pixel's channels."""
    acc = None
    for img in images:
        x = torch.as_tensor(np.asarray(img, np.float32), device=device)[None].requires_grad_()
        feats = fn(x)
        if isinstance(feats, (list, tuple)):
            feats = feats[-1]
        H, W = feats.shape[1], feats.shape[2]
        (g,) = torch.autograd.grad(feats[0, H // 2, W // 2].sum(), x)
        g = g[0].abs().sum(-1).cpu().numpy()
        acc = g if acc is None else acc + g
    return acc / len(images)


def erf_high_contribution_ratio(erf: np.ndarray, thresholds=(0.2, 0.3, 0.5, 0.99)):
    """The fraction of the input area holding each cumulative share of the
    ERF's energy (the reference's high-contribution-area statistic)."""
    flat = np.sort(erf.ravel())[::-1]
    cum = np.cumsum(flat) / flat.sum()
    return {t: float(np.searchsorted(cum, t) + 1) / flat.size for t in thresholds}
