"""Haar 2D DWT / IWT, NCHW: counterpart of bem_tpu/ops/wavelet.py.

The orthonormal-Haar pair of the QD decomposition models, reused by the
wavelet Decomp arch. Subbands lie along the channels in the order (LL,
HL, LH, HH), each carrying the original C channels. Strided slices and
adds in bem_tpu's order of operations; no kernel.
"""

from __future__ import annotations

import torch


def dwt2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2) Haar analysis."""
    x01 = x[:, :, 0::2, :] / 2.0
    x02 = x[:, :, 1::2, :] / 2.0
    x1 = x01[:, :, :, 0::2]
    x2 = x02[:, :, :, 0::2]
    x3 = x01[:, :, :, 1::2]
    x4 = x02[:, :, :, 1::2]
    ll = x1 + x2 + x3 + x4
    hl = -x1 - x2 + x3 + x4
    lh = -x1 + x2 - x3 + x4
    hh = x1 - x2 - x3 + x4
    return torch.cat([ll, hl, lh, hh], dim=1)


def iwt2(x: torch.Tensor) -> torch.Tensor:
    """(B, 4C, H, W) -> (B, C, 2H, 2W) Haar synthesis (the inverse of dwt2)."""
    B, C4, H, W = x.shape
    C = C4 // 4
    x1 = x[:, 0 * C:1 * C] / 2.0
    x2 = x[:, 1 * C:2 * C] / 2.0
    x3 = x[:, 2 * C:3 * C] / 2.0
    x4 = x[:, 3 * C:4 * C] / 2.0
    # pixel (row, col) within each 2x2 cell
    p00 = x1 - x2 - x3 + x4
    p10 = x1 - x2 + x3 - x4
    p01 = x1 + x2 - x3 - x4
    p11 = x1 + x2 + x3 + x4
    top = torch.stack([p00, p01], dim=-1).reshape(B, C, H, 2 * W)
    bot = torch.stack([p10, p11], dim=-1).reshape(B, C, H, 2 * W)
    return torch.stack([top, bot], dim=3).reshape(B, C, 2 * H, 2 * W)
