"""Quaternion ops of the QD Retinex decomposition, NCHW: counterpart of
bem_tpu/ops/quaternion.py (the Hamilton product and the RGB -> (Q1, Q2)
encoding shared by the QD models)."""

from __future__ import annotations

import torch


def hamilton_product(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternion maps (B, 4, H, W), components (r, i, j, k)."""
    r1, i1, j1, k1 = q1.chunk(4, dim=1)
    r2, i2, j2, k2 = q2.chunk(4, dim=1)
    r = r1 * r2 - i1 * i2 - j1 * j2 - k1 * k2
    i = r1 * i2 + i1 * r2 + j1 * k2 - k1 * j2
    j = r1 * j2 - i1 * k2 + j1 * r2 + k1 * i2
    k = r1 * k2 + i1 * j2 - j1 * i2 + k1 * r2
    return torch.cat([r, i, j, k], dim=1)


def rgb_to_quaternions(img: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """RGB (B, 3, H, W) -> the interleaved 8-channel quaternion encoding:
    Q1 = (0, R, G, B) / (max + eps), Q2 = (0, R, G, B), in the channel
    order (q1_r, q2_r, q1_i, q2_i, ...)."""
    r, g, b = img[:, 0:1], img[:, 1:2], img[:, 2:3]
    m = img.amax(dim=1, keepdim=True)
    zero = torch.zeros_like(m)
    q1 = (zero, r / (m + eps), g / (m + eps), b / (m + eps))
    q2 = (zero, r, g, b)
    return torch.cat([c for pair in zip(q1, q2) for c in pair], dim=1)
