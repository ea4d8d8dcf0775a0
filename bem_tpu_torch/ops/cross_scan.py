"""Cross-scan / cross-merge on the channel-first layout (scans 0, 1, 2).

A copy of bem_tpu/ops/cross_scan.py's channel-first forms (:42-117) for
the port. Plain tensor code: in bem_tpu these are XLA data movement, not
Pallas kernels. Sequences are (B, K=4, C, L) with L = H*W:

- scans 0 ("cross2d"): row-major, column-major, and both reversed;
- scans 1 ("unidi", v051d): the row-major sequence four times;
- scans 2 ("bidi", v052d): row-major twice, then reversed twice.

The merge sums the four directions back onto the map in the dtype of the
sequences: y0 + flip(y2) + colT(y1 + flip(y3)) for scans 0, the sum over K
for scans 1, y0 + y1 + flip(y2 + y3) for scans 2.
"""

from __future__ import annotations

import torch


def _check(scans: int) -> None:
    if scans not in (0, 1, 2):
        raise ValueError(f"unsupported scans mode: {scans}")


def cross_scan_cf_input(x_cf: torch.Tensor, scans: int = 0) -> torch.Tensor:
    """(B, C, H, W) channel-first map -> (B, 4, C, L) sequences."""
    _check(scans)
    B, C, H, W = x_cf.shape
    row = x_cf.reshape(B, C, H * W)
    if scans == 0:
        col = x_cf.transpose(2, 3).reshape(B, C, H * W)
        return torch.stack([row, col, row.flip(-1), col.flip(-1)], 1)
    if scans == 1:
        return row[:, None].expand(B, 4, C, H * W).contiguous()
    rev = row.flip(-1)
    return torch.stack([row, row, rev, rev], 1)


def cross_scan_cf(x: torch.Tensor, scans: int = 0) -> torch.Tensor:
    """(B, H, W, C) channels-last map -> (B, 4, C, L) sequences."""
    return cross_scan_cf_input(x.permute(0, 3, 1, 2), scans)


def cross_merge_cf_output(y: torch.Tensor, H: int, W: int, scans: int = 0) -> torch.Tensor:
    """(B, 4, C, L) sequences -> (B, C, H, W), summed, staying channel-first."""
    _check(scans)
    B, K, C, L = y.shape
    if K != 4 or L != H * W:
        raise ValueError(f"cross_merge: {tuple(y.shape)} is not (B, 4, C, {H}*{W})")
    if scans == 0:
        fwd = y[:, 0] + y[:, 2].flip(-1)
        colv = y[:, 1] + y[:, 3].flip(-1)
        out = fwd + colv.reshape(B, C, W, H).transpose(2, 3).reshape(B, C, L)
    elif scans == 1:
        out = y.sum(1)
    else:
        out = y[:, 0] + y[:, 1] + (y[:, 2] + y[:, 3]).flip(-1)
    return out.reshape(B, C, H, W)


def cross_merge_cf(y: torch.Tensor, H: int, W: int, scans: int = 0) -> torch.Tensor:
    """(B, 4, C, L) sequences -> (B, H, W, C), summed."""
    return cross_merge_cf_output(y, H, W, scans).permute(0, 2, 3, 1)
