"""PSNR / SSIM on the host, MATLAB-compatible (counterpart of the numpy
``calculate_psnr`` / ``calculate_ssim`` of bem_tpu/metrics/psnr_ssim.py):
[0, 255] HWC arrays, an 11x11 Gaussian window with sigma 1.5, valid-crop
borders.
"""

from __future__ import annotations

import numpy as np
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
