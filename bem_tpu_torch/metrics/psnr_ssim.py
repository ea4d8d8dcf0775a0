"""PSNR / SSIM (counterpart of bem_tpu/metrics/psnr_ssim.py): on the host,
MATLAB-compatible (``calculate_psnr`` / ``calculate_ssim``: [0, 255] HWC
arrays, an 11x11 Gaussian window with sigma 1.5, valid-crop borders), and
batched on the device (``calculate_psnr_torch`` / ``calculate_ssim_torch``:
NHWC tensors in [0, 1], the QD trainer's validation).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from numpy.lib.stride_tricks import sliding_window_view

from .metric_util import reorder_image, to_y_channel


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    # cv2.getGaussianKernel; the 2-D window is its outer product
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_valid(img: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Valid 2-D correlation with the window outer(g, g), by rows then columns
    (bem_tpu's sliding_window_view path, split: the window is separable)."""
    n = g.shape[0]
    rows = sliding_window_view(img, n, axis=1) @ g
    return sliding_window_view(rows, n, axis=0) @ g


def _ssim_channel(img: np.ndarray, img2: np.ndarray) -> float:
    if min(img.shape[:2]) < 11:  # no whole window: bem_tpu's empty mean, NaN
        return float("nan")
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    g = _gaussian_1d(11, 1.5)
    mu1 = _filter2d_valid(img, g)
    mu2 = _filter2d_valid(img2, g)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter2d_valid(img ** 2, g) - mu1_sq
    sigma2_sq = _filter2d_valid(img2 ** 2, g) - mu2_sq
    sigma12 = _filter2d_valid(img * img2, g) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


def _prepare(img, img2, crop_border, input_order, test_y_channel):
    assert img.shape == img2.shape, f"shapes differ: {img.shape} vs {img2.shape}"
    img = reorder_image(np.asarray(img), input_order)
    img2 = reorder_image(np.asarray(img2), input_order)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    return img.astype(np.float64), img2.astype(np.float64)


def calculate_psnr(img, img2, crop_border, input_order="HWC", test_y_channel=False, **kwargs):
    """PSNR on [0,255] images (psnr_ssim.py:11-51)."""
    img, img2 = _prepare(img, img2, crop_border, input_order, test_y_channel)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)


def calculate_ssim(img, img2, crop_border, input_order="HWC", test_y_channel=False, **kwargs):
    """MATLAB-compatible SSIM on [0,255] images (psnr_ssim.py:87-131)."""
    img, img2 = _prepare(img, img2, crop_border, input_order, test_y_channel)
    return float(np.mean([_ssim_channel(img[..., i], img2[..., i])
                          for i in range(img.shape[2])]))


# ---------------------------------------------------------------------------
# Batched device versions (NHWC in [0, 1]), bem_tpu's calculate_psnr_jax /
# calculate_ssim_jax (psnr_ssim.py:99-140)
# ---------------------------------------------------------------------------


def _crop(img, crop_border: int):
    if crop_border != 0:
        return img[:, crop_border:-crop_border, crop_border:-crop_border]
    return img


def calculate_psnr_torch(img, img2, crop_border=0):
    """PSNR of each image of two (B, H, W, C) tensors in [0, 1]: 10 log10(1 /
    (mse + 1e-8)), shape (B,)."""
    img, img2 = _crop(img, crop_border).float(), _crop(img2, crop_border).float()
    mse = (img - img2).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / (mse + 1e-8))


def calculate_ssim_torch(img, img2, crop_border=0):
    """SSIM of each image of two (B, H, W, C) tensors in [0, 1], scaled by 255
    inside: a depthwise 11x11 Gaussian (sigma 1.5) over the VALID windows,
    the map's mean over H, W and C, shape (B,)."""
    img = _crop(img, crop_border).float().permute(0, 3, 1, 2) * 255.0
    img2 = _crop(img2, crop_border).float().permute(0, 3, 1, 2) * 255.0
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    C = img.shape[1]
    g = _gaussian_1d(11, 1.5)
    win = torch.tensor(np.outer(g, g), dtype=torch.float32, device=img.device)
    kernel = win.expand(C, 1, 11, 11)

    def conv(t):
        return F.conv2d(t, kernel, groups=C)

    mu1, mu2 = conv(img), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = conv(img * img) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img * img2) - mu1_mu2
    cs = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs
    return ssim_map.mean(dim=(1, 2, 3))
