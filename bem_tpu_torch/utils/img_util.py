"""Image reading and writing (counterpart of bem_tpu/utils/img_util.py
``imread`` / ``imwrite``), on the codecs of :mod:`.image_codec`.

The port works in RGB throughout: ``imread`` returns RGB and ``imwrite``
takes RGB, where bem_tpu goes through cv2's BGR.
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


def imread(file_path: str, float32: bool = True) -> np.ndarray:
    """Read from disk -> RGB HWC, float32 in [0, 1] (``float32``) or uint8."""
    if not os.path.isfile(file_path):
        raise FileNotFoundError(file_path)
    with open(file_path, "rb") as f:
        img = imdecode(f.read(), file_path)
    return img.astype(np.float32) / 255.0 if float32 else img


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True) -> bool:
    """Write an (H, W, 3) uint8 RGB image as PNG."""
    if os.path.splitext(file_path)[1].lower() != ".png":
        raise ValueError(f"{file_path}: imwrite writes PNG only")
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    with open(file_path, "wb") as f:
        f.write(encode_png(img))
    return True
