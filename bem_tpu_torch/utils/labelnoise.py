"""GT label-noise jitter (counterpart of bem_tpu/utils/labelnoise.py), on RGB
images: bem_tpu scales cv2's BGR channels by (t, 1, 1/t), so the RGB
channels here take (1/t, 1, t)."""

from __future__ import annotations

import numpy as np


def adjust_color_temperature(image, temperature_factor):
    adj = np.array([1.0 / temperature_factor, 1.0, temperature_factor], np.float32)
    return np.clip(image.astype(np.float32) * adj, 0, 1)


def adjust_contrast(image, contrast_factor):
    return np.clip(contrast_factor * (image.astype(np.float32) - 0.5) + 0.5, 0, 1)


def adjust_brightness(image, factor=1.0):
    return np.clip(image.astype(np.float32) * factor, 0, 1)


def add_label_noise(image_np, tem_mean=1, tem_var=0.03, bright_mean=1.15, bright_var=0.15,
                    contrast_mean=1.15, contrast_var=0.15, rng: np.random.Generator = None):
    """Colour temperature, brightness, then contrast, each factor a normal
    draw from ``rng`` in that order, each step skipped where its mean is 1
    and its spread 0 (labelnoise.py:27)."""
    rng = rng or np.random.default_rng()
    if tem_mean != 1 or tem_var != 0:
        image_np = adjust_color_temperature(image_np, rng.normal(tem_mean, tem_var))
    if bright_mean != 1 or bright_var != 0:
        image_np = adjust_brightness(image_np, rng.normal(bright_mean, bright_var))
    if contrast_mean != 1 or contrast_var != 0:
        image_np = adjust_contrast(image_np, rng.normal(contrast_mean, contrast_var))
    return image_np
