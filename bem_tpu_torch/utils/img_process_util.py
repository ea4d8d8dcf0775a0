"""Unsharp masking (counterpart of bem_tpu/utils/img_process_util.py), in
two forms: ``usm_sharp`` on one host image with cv2's float32 Gaussian
blur (reflect-101 border), and ``usm_sharp_torch`` on a batch on the
tensor's device, a depthwise convolution with zero padding, as bem_tpu's
``usm_sharp_jax``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .cv_ops import gaussian_blur


def usm_sharp(img: np.ndarray, weight: float = 0.5, radius: int = 50,
              threshold: int = 10) -> np.ndarray:
    """Unsharp masking with a soft mask of one HWC float32 image in [0, 1]
    (img_process_util.py:14): the residual against a (radius | 1)-tap
    Gaussian blur (cv2's sigma from the size), a mask where |residual| *
    255 > threshold, blurred alike; sharp = clip(img + weight residual)
    blended by the mask. :func:`.cv_ops.gaussian_blur` sums in float64,
    cv2 in float32: the two differ by float32 ulps."""
    if radius % 2 == 0:
        radius += 1
    img = np.asarray(img, np.float32)
    blur = gaussian_blur(img, radius)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype(np.float32)
    soft_mask = gaussian_blur(mask, radius)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def gaussian_blur_torch(img: torch.Tensor, sigma: float = 8.0, ksize: int = 51) -> torch.Tensor:
    """An (N, H, W, C) batch blurred on its device as ``usm_sharp_jax``
    blurs it: the ``ksize`` x ``ksize`` Gaussian of ``sigma`` (float32,
    normalized, the outer product of its 1-D taps) as a depthwise NCHW
    convolution with zero padding."""
    x = torch.arange(ksize, dtype=torch.float32, device=img.device) - (ksize - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    C = img.shape[-1]
    kern = torch.outer(g, g).to(img.dtype).expand(C, 1, ksize, ksize)
    out = F.conv2d(img.permute(0, 3, 1, 2), kern, padding=ksize // 2, groups=C)
    return out.permute(0, 2, 3, 1)


def usm_sharp_torch(img: torch.Tensor, weight: float = 0.5, sigma: float = 8.0,
                    threshold: int = 10, ksize: int = 51) -> torch.Tensor:
    """``usm_sharp_jax`` (img_process_util.py:27) on an (N, H, W, C) batch
    on its device: :func:`gaussian_blur_torch`, then the same mask and
    blend."""

    def blur_fn(t):
        return gaussian_blur_torch(t, sigma, ksize)

    blur = blur_fn(img)
    residual = img - blur
    mask = ((residual.abs() * 255) > threshold).to(img.dtype)
    soft = blur_fn(mask)
    sharp = torch.clamp(img + weight * residual, 0, 1)
    return soft * sharp + (1 - soft) * img
