"""Bilinear resize, channels-last, the counterpart of bem_tpu/ops/resize.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size):
    """(B, H, W, C) -> (B, *size, C) with half-pixel centres (align_corners=False)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()
