"""Optical-flow files (counterpart of bem_tpu/utils/flow_util.py), host
numpy: Middlebury ``.flo`` files and quantized flows, the dx and dy maps
as one uint8 grey PNG concatenated along ``concat_axis``. Quantization
floors onto ``levels`` buckets over [-max_val, max_val]; dequantization
returns the buckets' centres (the mmcv formulas bem_tpu follows).
"""

from __future__ import annotations

import numpy as np

from .img_util import imread, imwrite


def _check_levels(min_val, max_val, levels):
    if not (isinstance(levels, int) and levels > 1):
        raise ValueError(f"levels must be a positive integer, but got {levels}")
    if min_val >= max_val:
        raise ValueError(f"min_val ({min_val}) must be smaller than max_val ({max_val})")


def quantize(arr, min_val, max_val, levels, dtype=np.int64):
    """(-inf, inf) -> [0, levels - 1] (flow_util.py:16)."""
    _check_levels(min_val, max_val, levels)
    arr = np.clip(arr, min_val, max_val) - min_val
    return np.minimum(np.floor(levels * arr / (max_val - min_val)).astype(dtype), levels - 1)


def dequantize(arr, min_val, max_val, levels, dtype=np.float64):
    """The bucket centres of :func:`quantize`'s output (flow_util.py:28)."""
    _check_levels(min_val, max_val, levels)
    return (arr + 0.5).astype(dtype) * (max_val - min_val) / levels + min_val


def quantize_flow(flow, max_val=0.02, norm=True):
    """(H, W, 2) flow -> (dx, dy) uint8 maps on 255 levels, so 0 stays 0
    after dequantization; ``norm`` divides dx by W and dy by H first
    (flow_util.py:38)."""
    h, w, _ = flow.shape
    dx, dy = flow[..., 0], flow[..., 1]
    if norm:
        dx, dy = dx / w, dy / h
    return tuple(quantize(d, -max_val, max_val, 255, np.uint8) for d in (dx, dy))


def dequantize_flow(dx, dy, max_val=0.02, denorm=True):
    """(dx, dy) quantized maps -> (H, W, 2) float64 flow; ``denorm``
    multiplies dx by W and dy by H (flow_util.py:50)."""
    assert dx.shape == dy.shape
    assert dx.ndim == 2 or (dx.ndim == 3 and dx.shape[-1] == 1)
    dx, dy = (dequantize(d, -max_val, max_val, 255) for d in (dx, dy))
    if denorm:
        dx *= dx.shape[1]
        dy *= dx.shape[0]
    return np.dstack((dx, dy))


def flowread(flow_path, quantize=False, concat_axis=0, *args, **kwargs):
    """A ``.flo`` file, or with ``quantize`` a quantized flow image, ->
    (H, W, 2) float32 flow (flow_util.py:62)."""
    if quantize:
        assert concat_axis in (0, 1)
        cat_flow = imread(str(flow_path), float32=False, flag="unchanged")
        if cat_flow.ndim != 2:
            raise IOError(f"{flow_path} is not a valid quantized flow file, "
                          f"its dimension is {cat_flow.ndim}.")
        assert cat_flow.shape[concat_axis] % 2 == 0
        dx, dy = np.split(cat_flow, 2, axis=concat_axis)
        return dequantize_flow(dx, dy, *args, **kwargs).astype(np.float32)
    with open(flow_path, "rb") as f:
        header = f.read(4)
        if header != b"PIEH":
            raise IOError(f"Invalid flow file: {flow_path} (header {header!r})")
        w = np.fromfile(f, np.int32, 1).item()
        h = np.fromfile(f, np.int32, 1).item()
        return np.fromfile(f, np.float32, w * h * 2).reshape(h, w, 2)


def flowwrite(flow, filename, quantize=False, concat_axis=0, *args, **kwargs):
    """(H, W, 2) flow -> a ``.flo`` file, or with ``quantize`` a grey PNG of
    the quantized dx and dy concatenated along ``concat_axis``
    (flow_util.py:84)."""
    if quantize:
        assert concat_axis in (0, 1)
        dx, dy = quantize_flow(flow, *args, **kwargs)
        imwrite(np.concatenate((dx, dy), axis=concat_axis), str(filename))
        return
    with open(filename, "wb") as f:
        f.write(b"PIEH")
        h, w = flow.shape[:2]
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)
