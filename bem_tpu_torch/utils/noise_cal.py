"""Noise-map estimation, channels-last (counterpart of
bem_tpu/utils/noise_cal.py; reference basicsr/utils/noise_cal.py): the
colour-ratio map's central differences along H and W, the larger
magnitude per pixel."""

from __future__ import annotations

import torch


def _sub_gradient(t: torch.Tensor) -> torch.Tensor:
    """0.5 (t[:, i+1] - t[:, i-1]) along dim 1, the missing neighbour 0."""
    left = torch.zeros_like(t)
    left[:, :-1] = t[:, 1:]
    right = torch.zeros_like(t)
    right[:, 1:] = t[:, :-1]
    return 0.5 * (left - right)


def calculate_noise_map(x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> the noise map (B, H, W, C)."""
    low_after_awb = torch.exp(x)
    color_map = low_after_awb / (low_after_awb.sum(dim=-1, keepdim=True) + 1e-4)
    dx = _sub_gradient(color_map)
    dy = _sub_gradient(color_map.transpose(1, 2)).transpose(1, 2)
    return torch.maximum(dx.abs(), dy.abs())
