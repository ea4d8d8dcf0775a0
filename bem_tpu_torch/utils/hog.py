"""HOG (Histogram of Oriented Gradients) features, channels-last
(counterpart of bem_tpu/utils/hog.py, the reference's conv-based HOG of
basicsr/utils/hog.py:14-113, the MaskFeat-style feature target).

Per-channel 3x3 Sobel gradients on a reflect-padded image, signed hard
binning of ``atan2(gx, gy)`` into ``nbins`` orientation bins over the full
2*pi range, an optional tiled Gaussian window on the magnitudes, sums over
``pool x pool`` cells and L2 normalisation across the bins (eps 1e-12).
The binning is a scatter of each pixel's magnitude into its one bin, as
the reference's ``scatter_add``; bem_tpu's one-hot product is a TPU layout
and is not copied. On 8-bit-quantized images the Sobel sums are exact in
fp32, so the bins do not depend on the convolution's summation order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _gaussian_kernel2d(kernlen: int, std: int, dtype, device) -> torch.Tensor:
    """2D Gaussian window, normalized to sum 1 (hog.py:43-56)."""
    n = torch.arange(kernlen, dtype=torch.float32, device=device)
    n = (n - n.mean()) / std
    w = torch.exp(-0.5 * n ** 2)
    g = w[:, None] * w[None, :]
    return (g / g.sum()).to(dtype)


def hog_features(x: torch.Tensor, nbins: int = 9, pool: int = 8,
                 gaussian_window: int = 16) -> torch.Tensor:
    """x (B, H, W, C) -> (B, H/pool, W/pool, C, nbins).

    The reference's ``HOG(nbins, pool, gaussian_window)(x_nchw)`` in
    channels-last order: its output ``[b, c, k, i, j]`` is ``[b, i, j, c,
    k]`` here. The square window tiles H // gaussian_window times in both
    dimensions (hog.py:96-101), so it needs H == W with the window on."""
    B, H, W, C = x.shape
    # the Sobel pair (hog.py:32-36); conv2d cross-correlates, as the reference
    wx = torch.tensor([[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]],
                      dtype=x.dtype, device=x.device)
    k = torch.stack([wx, wx.t()])[:, None].repeat(C, 1, 1, 1)        # (2C, 1, 3, 3)
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    g = F.conv2d(xp, k, groups=C)                                   # (B, 2C, H, W)
    gx, gy = g[:, 0::2], g[:, 1::2]
    norm = torch.sqrt(gx ** 2 + gy ** 2)
    # signed phase, the reference's argument order atan2(gx, gy) (hog.py:84)
    phase = torch.atan2(gx, gy) / math.pi * nbins
    bins = torch.remainder(torch.floor(phase).to(torch.int64), nbins)
    if gaussian_window:
        win = _gaussian_kernel2d(gaussian_window, gaussian_window // 2, x.dtype, x.device)
        if H != gaussian_window:
            if H % gaussian_window:
                raise ValueError(f"hog_features: h {H} gw {gaussian_window}")
            win = win.repeat(H // gaussian_window, H // gaussian_window)
        if tuple(win.shape) != (H, W):
            raise ValueError("hog_features: the reference tiles its square window by "
                             f"H//gw in both dims; window {tuple(win.shape)}, image {(H, W)}")
        norm = norm * win
    hist = torch.zeros((B, C, nbins, H, W), dtype=norm.dtype, device=x.device)
    hist.scatter_add_(2, bins[:, :, None], norm[:, :, None])
    pooled = hist.reshape(B, C, nbins, H // pool, pool, W // pool, pool).sum((4, 6))
    pooled = pooled.permute(0, 3, 4, 1, 2)                          # (B, h, w, C, nbins)
    l2 = torch.sqrt((pooled * pooled).sum(-1, keepdim=True))
    return pooled / torch.clamp(l2, min=1e-12)   # F.normalize(p=2, dim=bins), hog.py:111
