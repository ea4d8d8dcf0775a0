"""Metric helpers (counterpart of bem_tpu/metrics/metric_util.py)."""

from __future__ import annotations

import numpy as np

from ..utils.color_util import bgr2ycbcr


def reorder_image(img: np.ndarray, input_order: str = "HWC") -> np.ndarray:
    if input_order not in ("HWC", "CHW"):
        raise ValueError(f"Wrong input_order {input_order}")
    if img.ndim == 2:
        return img[..., None]
    if input_order == "CHW":
        return img.transpose(1, 2, 0)
    return img


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """[0,255] BGR HWC -> Y channel [0,255] (metric_util.py:32-45)."""
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)
        img = img[..., None]
    return img * 255.0
