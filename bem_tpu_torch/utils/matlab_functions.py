"""MATLAB-compatible bicubic ``imresize`` (counterpart of
bem_tpu/utils/matlab_functions.py; reference
basicsr/utils/matlab_functions.py), numpy in float64.

The cubic kernel with a = -0.5, widened by 1/scale when shrinking with
antialiasing, each output pixel's weights normalised to sum 1, and the
indices outside the image mirrored (MATLAB's symmetric padding). NIQE's
second scale depends on this resampling (metrics/niqe.py).
"""

from __future__ import annotations

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return (1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2))


def _contributions(in_length: int, out_length: int, scale: float, antialiasing: bool = True):
    """(weights, indices), each (out_length, taps): the taps of every
    output pixel along one axis, zero-weight columns trimmed, the indices
    mirrored into [0, in_length)."""
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_length + 1, dtype=np.float64)
    # input-space centre of each output pixel (MATLAB's convention)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :] - 1  # 0-based candidates
    dist = u[:, None] - (indices + 1)
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    nz = np.nonzero(np.any(weights != 0, axis=0))[0]
    weights = weights[:, nz[0]:nz[-1] + 1]
    indices = indices[:, nz[0]:nz[-1] + 1]
    aux = np.concatenate([np.arange(in_length), np.arange(in_length - 1, -1, -1)])
    return weights, aux[np.mod(indices.astype(np.int64), 2 * in_length)]


def imresize(img: np.ndarray, scale: float = None, out_shape=None,
             antialiasing: bool = True) -> np.ndarray:
    """MATLAB imresize with the 'bicubic' kernel. img (H, W) or (H, W, C),
    float (any range) or uint8; returns float64 in the input's range.
    ``out_shape`` (h, w) sets each axis's scale, else ``scale`` both and
    the size is ceil(scale * size)."""
    img = np.asarray(img, np.float64)
    squeeze2d = img.ndim == 2
    if squeeze2d:
        img = img[:, :, None]
    in_h, in_w, _ = img.shape
    if out_shape is not None:
        out_h, out_w = out_shape
        scale_h, scale_w = out_h / in_h, out_w / in_w
    else:
        scale_h = scale_w = scale
        out_h, out_w = int(np.ceil(in_h * scale_h)), int(np.ceil(in_w * scale_w))
    wh, ih = _contributions(in_h, out_h, scale_h, antialiasing)
    ww, iw = _contributions(in_w, out_w, scale_w, antialiasing)
    # along H: out[o] = sum_k wh[o, k] img[ih[o, k]]; then along W the same
    tmp = np.einsum("ok,okwc->owc", wh, img[ih])
    out = np.einsum("ok,hokc->hoc", ww, tmp[:, iw])
    return out[:, :, 0] if squeeze2d else out
