"""The Reflectance Consistency Index (counterpart of bem_tpu/qd/rci.py)."""

from __future__ import annotations

import numpy as np
import torch


def _nchw(img, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(img, np.float32), device=device)
    if t.dim() == 3:
        t = t[None]
    return t.permute(0, 3, 1, 2)


@torch.no_grad()
def compute_rci(decomp_fn, input_low, input_high, num_steps: int = 10,
                return_variance_map: bool = False, device="cuda"):
    """RCI in [0, 1]: 1 - (the largest per-pixel variance of the reflectance
    over the num_steps + 1 blends from low to high) / 0.25, clipped.

    ``decomp_fn``: (B, 3, H, W) -> (Q1, Q2), each (B, 4, H, W); the inputs are
    (H, W, 3) or (1, H, W, 3) RGB arrays. The blends run one at a time;
    the variance is the population variance over the blends. With
    ``return_variance_map``, also the (H, W) numpy map of the variance's
    maximum over the channels.
    """
    low, high = _nchw(input_low, device), _nchw(input_high, device)
    alphas = torch.arange(num_steps + 1, dtype=torch.float32, device=low.device) / num_steps
    Rs = torch.stack([decomp_fn((1.0 - a) * low + a * high)[0][:, 1:] for a in alphas])
    variance = Rs.var(dim=0, unbiased=False)[0]  # (3, H, W)
    metric = torch.clamp(1.0 - variance.max() / 0.25, 0.0, 1.0)
    if return_variance_map:
        return metric, variance.amax(dim=0).cpu().numpy()
    return metric
