"""Resizes, channels-last: the bilinear one of bem_tpu/ops/resize.py, and
Pillow's bicubic ``Image.resize`` on uint8 images (the UIQM selector's,
bem_tpu/enhancement/eval.py)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size, antialias: bool = False):
    """(B, H, W, C) -> (B, *size, C) with half-pixel centres (align_corners=False);
    ``antialias`` widens the filter where it shrinks, as jax.image.resize does."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1).contiguous()


_PRECISION_BITS = 22  # Pillow's resample.c: 32 - 8 (bits a sample) - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter, a = -0.5."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def pil_bicubic_taps(n_in: int, n_out: int) -> np.ndarray:
    """The (n_out, n_in) fixed-point weights of Pillow's ``precompute_coeffs``
    and ``normalize_coeffs_8bpc`` for a bicubic resize of one axis (float64,
    integer-valued)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    taps = np.zeros((n_out, n_in), np.float64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) / filterscale)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        taps[xx, xmin:xmin + xmax] = w
    fixed = taps * (1 << _PRECISION_BITS)
    # rounded half away from zero, as the C casts do
    return np.where(fixed < 0, np.trunc(fixed - 0.5), np.trunc(fixed + 0.5))


def _pil_pass(x: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """One Pillow pass along ``dim`` of a float64 tensor of uint8 values:
    every partial sum is an integer below 2^40, so the float64 products and
    sums are exact, and the result is ``clip8``'s."""
    k = torch.from_numpy(taps).to(x.device)
    y = torch.movedim(torch.movedim(x, dim, -1) @ k.t(), -1, dim)
    y = torch.floor((y + float(1 << (_PRECISION_BITS - 1))) / float(1 << _PRECISION_BITS))
    return y.clamp_(0.0, 255.0)


def pil_bicubic_resize_u8(x: torch.Tensor, size) -> torch.Tensor:
    """``PIL.Image.fromarray(x).resize(size)`` (its default BICUBIC, no
    reducing gap) of uint8 images (..., H, W, C), on their device; ``size``
    is Pillow's (width, height). The horizontal pass runs first and its
    uint8 result feeds the vertical pass, as in Pillow."""
    w_out, h_out = int(size[0]), int(size[1])
    h_in, w_in = x.shape[-3], x.shape[-2]
    y = x.to(torch.float64)
    if w_out != w_in:
        y = _pil_pass(y, pil_bicubic_taps(w_in, w_out), -2)
    if h_out != h_in:
        y = _pil_pass(y, pil_bicubic_taps(h_in, h_out), -3)
    return y.to(torch.uint8)
