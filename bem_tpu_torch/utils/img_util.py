"""Image reading, writing and conversion (counterpart of
bem_tpu/utils/img_util.py), on the codecs of :mod:`.image_codec`.

The port works in RGB throughout: ``imread`` / ``imfrombytes`` return RGB
(RGBA where bem_tpu's cv2 gives BGRA) and ``imwrite`` takes RGB, where
bem_tpu goes through cv2's BGR, so the BGR <-> RGB flips of bem_tpu's
``img2tensor`` collapse. ``tensor2img`` keeps its ``rgb2bgr`` flag:
bem_tpu's host metrics read its output, and their Y channel expects BGR.

``imfrombytes`` takes bem_tpu's three flags: ``"color"`` ((H, W, 3)
uint8), ``"grayscale"`` ((H, W) uint8, each codec's own grey) and
``"unchanged"`` (the file's channels and depth: 2-D grey, RGB, RGBA,
uint16 kept; no EXIF orientation). PNG, BMP, TIFF, JPEG and WebP are read
by content, as cv2.imdecode does (what each decoder reads and refuses:
:mod:`.image_codec`, :mod:`.webp_codec`); AVIF, JPEG 2000, PNM, Sun
raster, GIF and HDR, which cv2 also reads by content but no glob of
bem_tpu takes, raise a ``ValueError`` naming the file.
"""

from __future__ import annotations

import os

import numpy as np

from .image_codec import (PNG_SIGNATURE, decode_bmp, decode_jpeg, decode_png, decode_tiff,
                          encode_png)
from .webp_codec import decode_webp

# formats cv2 reads by content that the port does not: (magic, offset, name)
_UNSUPPORTED = ((b"ftyp", 4, "AVIF / HEIF"),
                (b"\x00\x00\x00\x0cjP  ", 0, "JPEG 2000"), (b"\xffO\xffQ", 0, "JPEG 2000"),
                (b"GIF8", 0, "GIF"), (b"#?RADIANCE", 0, "HDR"), (b"#?RGBE", 0, "HDR"),
                (b"\x59\xa6\x6a\x95", 0, "Sun raster"), (b"P", 0, "PNM / PFM"))
_READ = "PNG, BMP, TIFF, JPEG and WebP are read"


def imdecode(data: bytes, name: str = "<bytes>", flag: str = "color") -> np.ndarray:
    """Image bytes -> the array cv2.imdecode gives for ``flag`` (RGB order),
    by content as cv2.imdecode does."""
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, name, flag)
    if data[:2] == b"BM":
        return decode_bmp(data, name, flag)
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data, name, flag)
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return decode_tiff(data, name, flag)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return decode_webp(data, name, flag)
    for magic, at, kind in _UNSUPPORTED:
        if data[at:at + len(magic)] == magic and (kind != "PNM / PFM" or data[1:2] in
                                                    b"123456fF"):
            raise ValueError(f"{name}: {kind} decoding is not supported ({_READ})")
    raise ValueError(f"{name}: unknown image format ({_READ})")


def imfrombytes(content: bytes, flag: str = "color", float32: bool = False,
                name: str = "<bytes>") -> np.ndarray:
    """Image bytes -> RGB(A) HWC or 2-D grey, uint8 (uint16 for a 16-bit
    file read ``unchanged``) or float32 divided by 255 (img_util.py:21)."""
    img = imdecode(content, name, flag)
    return img.astype(np.float32) / 255.0 if float32 else img


def imfrombytesDP(content: bytes, float32: bool = False, name: str = "<bytes>") -> np.ndarray:
    """Image bytes read ``unchanged`` (16-bit dual-pixel frames), float32
    divided by 65535 when asked (img_util.py:35)."""
    img = imdecode(content, name, "unchanged")
    return img.astype(np.float32) / 65535.0 if float32 else img


def imread(file_path: str, float32: bool = True, flag: str = "color") -> np.ndarray:
    """Read from disk -> RGB HWC (or what ``flag`` reads, as
    :func:`imfrombytes`), float32 in [0, 1] (``float32``) or uint8."""
    if not os.path.isfile(file_path):
        raise FileNotFoundError(file_path)
    with open(file_path, "rb") as f:
        return imfrombytes(f.read(), flag, float32=float32, name=file_path)


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True) -> bool:
    """Write an (H, W, 3) uint8 RGB or (H, W) uint8 grey image as PNG."""
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


def _reflect(img: np.ndarray, h_pad: int, w_pad: int) -> np.ndarray:
    """cv2.copyMakeBorder(img, 0, h_pad, 0, w_pad, BORDER_REFLECT): numpy's
    "symmetric" (the edge pixel repeats: fedcba|abcdef|fedcba); like cv2,
    an (H, W, 1) image comes back 2-D."""
    out = np.pad(img, ((0, h_pad), (0, w_pad)) + ((0, 0),) * (img.ndim - 2), mode="symmetric")
    return out[..., 0] if out.ndim == 3 and out.shape[2] == 1 else out


def padding(img_lq: np.ndarray, img_gt: np.ndarray, gt_size: int):
    """Pad both HWC images at the bottom and right up to ``gt_size``
    (img_util.py:89), as cv2.BORDER_REFLECT does."""
    h, w = img_lq.shape[:2]
    h_pad, w_pad = max(0, gt_size - h), max(0, gt_size - w)
    if h_pad == 0 and w_pad == 0:
        return img_lq, img_gt
    return _reflect(img_lq, h_pad, w_pad), _reflect(img_gt, h_pad, w_pad)


def padding_DP(img_lqL: np.ndarray, img_lqR: np.ndarray, img_gt: np.ndarray, gt_size: int):
    """``padding`` of a dual-pixel triple, sized by the GT (img_util.py:101)."""
    h, w = img_gt.shape[:2]
    h_pad, w_pad = max(0, gt_size - h), max(0, gt_size - w)
    if h_pad == 0 and w_pad == 0:
        return img_lqL, img_lqR, img_gt
    return tuple(_reflect(a, h_pad, w_pad) for a in (img_lqL, img_lqR, img_gt))


def downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """``cv2.resize(img, None, fx=1/factor, fy=1/factor, INTER_LINEAR)`` on an
    (H, W, C) float image: output size round(n / factor) (cv2 rounds half to
    even, as Python does), ``resize_linear`` with cv2's scale 1 / (1 /
    factor), in float32."""
    inv = 1.0 / factor
    h, w = img.shape[:2]
    oh, ow = round(h * inv), round(w * inv)
    if oh == 0 or ow == 0:
        raise ValueError(f"downsample: {h}x{w} / {factor} is empty")
    return resize_linear(np.asarray(img, np.float32), (ow, oh), scale=1.0 / inv)


def resize_linear(img: np.ndarray, size, scale=None) -> np.ndarray:
    """``cv2.resize(img, size)`` (INTER_LINEAR, ``size`` = (width, height))
    as OpenCV's own code computes it: source coordinate (x + 0.5) * scale -
    0.5 in float32 (``scale`` the ratio of sizes unless given, as cv2 keeps
    1 / fx when called with fx), the columns'
    weights zeroed past the edges, the rows clamped with their weights
    kept; uint8 in fixed point (11-bit weights, the vertical pass's
    shifts), float32 in float32, an exact 2x float32 shrink as cv2's 2x2
    area sum (in its 3-channel order). cv2 builds with IPP resize float32 images
    through IPP instead, a few float32 ulps away (uint8 does not use it)."""
    w_out, h_out = size
    h, w = img.shape[:2]
    if (w_out, h_out) == (w, h):
        return img.copy()
    sx_scale = scale if scale is not None else 1.0 / (w_out / w)
    sy_scale = scale if scale is not None else 1.0 / (h_out / h)
    fx = ((np.arange(w_out) + 0.5) * sx_scale - 0.5).astype(np.float32)
    sx = np.floor(fx)
    fx = (fx - sx).astype(np.float32)
    sx = sx.astype(np.int64)
    fx[(sx < 0) | (sx >= w - 1)] = 0.0
    sx = np.clip(sx, 0, w - 1)
    sx1 = np.minimum(sx + 1, w - 1)
    fy = ((np.arange(h_out) + 0.5) * sy_scale - 0.5).astype(np.float32)
    sy = np.floor(fy)
    fy = (fy - sy).astype(np.float32)
    sy = sy.astype(np.int64)
    r0, r1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    col = (1, -1) + (1,) * (img.ndim - 2)
    row = (-1,) + (1,) * (img.ndim - 1)
    one = np.float32(1)
    if img.dtype == np.uint8:
        scale = np.float32(2048)  # INTER_RESIZE_COEF_SCALE, rounded to even as cvRound does
        a0, a1 = np.rint((one - fx) * scale).astype(np.int64), np.rint(fx * scale).astype(np.int64)
        b0, b1 = np.rint((one - fy) * scale).astype(np.int64), np.rint(fy * scale).astype(np.int64)
        x = img.astype(np.int64)
        rows = x[:, sx] * a0.reshape(col) + x[:, sx1] * a1.reshape(col)
        out = (((b0.reshape(row) * (rows[r0] >> 4)) >> 16)
               + ((b1.reshape(row) * (rows[r1] >> 4)) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    if img.dtype != np.float32:
        raise ValueError(f"resize_linear: uint8 or float32, not {img.dtype}")
    if (w, h) == (2 * w_out, 2 * h_out):  # cv2 takes its 2x2 area path here
        a, b, c, d = img[0::2, 0::2], img[0::2, 1::2], img[1::2, 0::2], img[1::2, 1::2]
        s = ((a + b) + c) + d if img.ndim == 3 and img.shape[2] == 3 else (a + b) + (c + d)
        return s * np.float32(0.25)
    rows = img[:, sx] * (one - fx).reshape(col) + img[:, sx1] * fx.reshape(col)
    return rows[r0] * (one - fy).reshape(row) + rows[r1] * fy.reshape(row)
