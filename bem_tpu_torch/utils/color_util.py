"""Colour conversions: BT.601 (counterpart of bem_tpu/utils/color_util.py
``bgr2ycbcr``), numpy on the host; and cv2's uint8 RGB -> Lab (the
UCIQE metric's), on a tensor's device."""

from __future__ import annotations

import numpy as np


def _convert_input(img):
    img_type = img.dtype
    img = img.astype(np.float32)
    if img_type != np.uint8:
        img *= 255.0
    return img, img_type


def _convert_output(img, img_type):
    if img_type == np.uint8:
        return img.round().astype(np.uint8)
    return (img / 255.0).astype(np.float32)


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """BGR (uint8 [0, 255] or float [0, 1]) -> YCbCr in the same range."""
    img, img_type = _convert_input(img)
    img = img / 255.0
    if y_only:
        out = np.dot(img, [24.966, 128.553, 65.481]) + 16.0
    else:
        out = np.matmul(
            img,
            [[24.966, 112.0, -18.214],
             [128.553, -74.203, -93.786],
             [65.481, -37.797, 112.0]],
        ) + [16, 128, 128]
    return _convert_output(out, img_type)


_LAB_SHIFT, _GAMMA_SHIFT, _LAB_SHIFT2 = 12, 3, 15
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_WHITE = np.array([0.950456, 1.0, 1.088754])


def _lab_tables():
    """OpenCV's uint8 RGB -> Lab tables: the sRGB gamma table (x 2^3), the
    cube-root table (x 2^15, 3072 entries) and the XYZ coefficients over
    the white point (x 2^12), rounded half to even as ``cvRound`` does."""
    x = np.arange(256).astype(np.float32) / np.float32(255)
    lin = np.where(x <= np.float32(0.04045), x / np.float32(12.92),
                   np.power((x.astype(np.float64) + 0.055) / 1.055, 2.4).astype(np.float32))
    gamma = np.rint(np.float32(255 << _GAMMA_SHIFT) * lin.astype(np.float32))
    t = np.arange(3072).astype(np.float32) * (np.float32(1) / np.float32(255 << _GAMMA_SHIFT))
    f = np.where(t < np.float32(0.008856), t * np.float32(7.787) + np.float32(16.0 / 116.0),
                 np.cbrt(t)).astype(np.float32)
    cbrt = np.rint(np.float32(1 << _LAB_SHIFT2) * f)
    coeffs = np.rint(_RGB2XYZ * (1 << _LAB_SHIFT) / _WHITE[:, None])
    return gamma.astype(np.int32), cbrt.astype(np.int32), coeffs.astype(np.int32)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def rgb2lab_u8(rgb):
    """cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB) of a uint8 tensor (..., 3), bit for
    bit: OpenCV's fixed-point path, in int32 on the tensor's device."""
    import torch

    gamma, cbrt, coeffs = (torch.from_numpy(t).to(rgb.device) for t in _lab_tables())
    g = gamma[rgb.long()]
    r, gg, b = g[..., 0], g[..., 1], g[..., 2]
    fx, fy, fz = (cbrt[_descale(r * c[0] + gg * c[1] + b * c[2], _LAB_SHIFT).long()]
                  for c in coeffs.tolist())
    lscale = (116 * 255 + 50) // 100
    lshift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    L = _descale(lscale * fy + lshift, _LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = _descale(200 * (fy - fz) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    return torch.stack([L, a, bb], dim=-1).clamp_(0, 255).to(torch.uint8)
