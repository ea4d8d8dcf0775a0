"""Image reading, writing and conversion (counterpart of
bem_tpu/utils/img_util.py), on the codecs of :mod:`.image_codec`.

The port works in RGB throughout: ``imread`` / ``imfrombytes`` return RGB
and ``imwrite`` takes RGB, where bem_tpu goes through cv2's BGR, so the
BGR <-> RGB flips of bem_tpu's ``img2tensor`` collapse. ``tensor2img``
keeps its ``rgb2bgr`` flag: bem_tpu's host metrics read its output, and
their Y channel expects BGR.
"""

from __future__ import annotations

import os

import numpy as np

from .image_codec import PNG_SIGNATURE, decode_bmp, decode_png, encode_png

_UNSUPPORTED = ((b"\xff\xd8\xff", "JPEG"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def imdecode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8 RGB, by content as cv2.imdecode does."""
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, name)
    if data[:2] == b"BM":
        return decode_bmp(data, name)
    for magic, kind in _UNSUPPORTED:
        if data.startswith(magic):
            raise ValueError(f"{name}: {kind} decoding is not supported (PNG and 24-bit BMP "
                             f"are); convert the image to PNG")
    raise ValueError(f"{name}: unknown image format (PNG and 24-bit BMP are supported)")


def imfrombytes(content: bytes, float32: bool = False, name: str = "<bytes>") -> np.ndarray:
    """Image bytes -> RGB HWC, uint8 or float32 in [0, 1] (img_util.py:21)."""
    img = imdecode(content, name)
    return img.astype(np.float32) / 255.0 if float32 else img


def imread(file_path: str, float32: bool = True) -> np.ndarray:
    """Read from disk -> RGB HWC, float32 in [0, 1] (``float32``) or uint8."""
    if not os.path.isfile(file_path):
        raise FileNotFoundError(file_path)
    with open(file_path, "rb") as f:
        return imfrombytes(f.read(), float32=float32, name=file_path)


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True) -> bool:
    """Write an (H, W, 3) uint8 RGB image as PNG."""
    if os.path.splitext(file_path)[1].lower() != ".png":
        raise ValueError(f"{file_path}: imwrite writes PNG only")
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    with open(file_path, "wb") as f:
        f.write(encode_png(img))
    return True


def img2tensor(img: np.ndarray, float32: bool = True) -> np.ndarray:
    """HWC image -> contiguous HWC (a channel axis added to a 2-D image),
    float32 when asked (img_util.py:45; the image is RGB already)."""
    if img.ndim == 2:
        img = img[..., None]
    img = np.ascontiguousarray(img)
    return img.astype(np.float32) if float32 else img


def tensor2img(img: np.ndarray, rgb2bgr: bool = True) -> np.ndarray:
    """HWC float RGB in [0, 1] -> HWC uint8, clipped; BGR when ``rgb2bgr``
    (img_util.py:55)."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    if rgb2bgr and img.ndim == 3 and img.shape[2] == 3:
        img = img[..., ::-1]
    return (img * 255.0).round().astype(np.uint8)


def padding(img_lq: np.ndarray, img_gt: np.ndarray, gt_size: int):
    """Pad both HWC images at the bottom and right up to ``gt_size``
    (img_util.py:89): cv2.BORDER_REFLECT, numpy's "symmetric" (the edge
    pixel repeats: fedcba|abcdef|fedcba)."""
    h, w = img_lq.shape[:2]
    h_pad, w_pad = max(0, gt_size - h), max(0, gt_size - w)
    if h_pad == 0 and w_pad == 0:
        return img_lq, img_gt
    pad = ((0, h_pad), (0, w_pad)) + ((0, 0),) * (img_lq.ndim - 2)
    return np.pad(img_lq, pad, mode="symmetric"), np.pad(img_gt, pad, mode="symmetric")


def _linear_taps(n_in: int, n_out: int, scale: float):
    """cv2's INTER_LINEAR taps along one axis: source coordinate
    (x + 0.5) * scale - 0.5 in float32, floored, clamped at both edges
    (the weight of a clamped tap is 1)."""
    x = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    x0 = np.floor(x)
    frac = (x - x0).astype(np.float32)
    x0 = x0.astype(np.int64)
    low, high = x0 < 0, x0 >= n_in - 1
    frac[low | high] = 0.0
    x0 = np.clip(x0, 0, n_in - 1)
    x1 = np.minimum(x0 + 1, n_in - 1)
    return x0, x1, (1.0 - frac).astype(np.float32), frac


def downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """``cv2.resize(img, None, fx=1/factor, fy=1/factor, INTER_LINEAR)`` on an
    (H, W, C) float image: output size round(n / factor) (cv2 rounds half to
    even, as Python does), source coordinate (x + 0.5) * factor - 0.5 with
    the edges clamped, no antialiasing; along the rows first (cv2's
    horizontal pass), then down the columns, in float32."""
    inv = 1.0 / factor
    scale = 1.0 / inv  # cv2 keeps 1/fx, not the ratio of sizes
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    oh, ow = round(h * inv), round(w * inv)
    if oh == 0 or ow == 0:
        raise ValueError(f"downsample: {h}x{w} / {factor} is empty")
    c0, c1, cw0, cw1 = _linear_taps(w, ow, scale)
    r0, r1, rw0, rw1 = _linear_taps(h, oh, scale)
    shape = (1, -1) + (1,) * (img.ndim - 2)
    rows = img[:, c0] * cw0.reshape(shape) + img[:, c1] * cw1.reshape(shape)
    shape = (-1,) + (1,) * (img.ndim - 1)
    return rows[r0] * rw0.reshape(shape) + rows[r1] * rw1.reshape(shape)
