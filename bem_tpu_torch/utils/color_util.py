"""BT.601 colour conversion (counterpart of bem_tpu/utils/color_util.py
``bgr2ycbcr``), numpy on the host."""

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
