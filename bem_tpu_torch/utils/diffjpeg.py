"""Differentiable JPEG compression (counterpart of bem_tpu/utils/diffjpeg.py,
itself from mlomnitz/DiffJPEG), torch on the tensor's device: RGB ->
YCbCr, 4:2:0 chroma subsampling (2 x 2 means), 8 x 8 block DCT,
quantization by the standard tables scaled by quality with a
differentiable rounding, dequantization, IDCT, nearest 2x chroma
upsampling, YCbCr -> RGB. Degradation-in-the-loop training differentiates
through it (``diff_round``'s cubic carries the gradient).
"""

from __future__ import annotations

import numpy as np
import torch

from .image_writers import _STD_CHROMA_Q, _STD_LUMA_Q

# the standard JPEG quantization tables, transposed as the reference keeps them
_Y_TABLE = _STD_LUMA_Q.reshape(8, 8).T.astype(np.float32)
_C_TABLE = _STD_CHROMA_Q.reshape(8, 8).T.astype(np.float32)

# the 8 x 8 DCT basis dct[x, y, u, v], float32 as bem_tpu builds it
_k = np.arange(8)
_COS = np.cos((2 * _k[:, None] + 1) * _k[None, :] * np.pi / 16)  # [x, u]
_DCT = (_COS[:, None, :, None] * _COS[None, :, None, :]).astype(np.float32)
_ALPHA = np.array([1.0 / np.sqrt(2)] + [1.0] * 7, np.float32)
_SCALE = np.outer(_ALPHA, _ALPHA) * 0.25


def diff_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) + (x - round(x))^3, rounding half to even (diffjpeg.py:42)."""
    r = torch.round(x)
    return r + (x - r) ** 3


def quality_to_factor(quality: float) -> float:
    """JPEG quality -> the tables' scale factor (diffjpeg.py:48)."""
    if quality < 50:
        return 5000.0 / quality / 100.0
    return (200.0 - quality * 2) / 100.0


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _rgb_to_ycbcr(img255):
    m = _const([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                [0.5, -0.418688, -0.081312]], img255).T
    return img255 @ m + _const([0.0, 128.0, 128.0], img255)


def _ycbcr_to_rgb(ycc):
    m = _const([[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]], ycc).T
    return (ycc - _const([0.0, 128.0, 128.0], ycc)) @ m


def _blocks(ch):
    """(B, H, W) -> (B, n, 8, 8)."""
    B, H, W = ch.shape
    return ch.reshape(B, H // 8, 8, W // 8, 8).permute(0, 1, 3, 2, 4).reshape(B, -1, 8, 8)


def _unblocks(blocks, H, W):
    B = blocks.shape[0]
    return blocks.reshape(B, H // 8, W // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(B, H, W)


def _dct(blocks):
    return torch.einsum("bnxy,xyuv->bnuv", blocks - 128.0, _const(_DCT, blocks)) * _const(
        _SCALE, blocks)


def _idct(coefs):
    alpha = _const(np.outer(_ALPHA, _ALPHA), coefs)
    return torch.einsum("bnuv,xyuv->bnxy", coefs * alpha, _const(_DCT, coefs)) * 0.25 + 128.0


def diff_jpeg(img: torch.Tensor, quality: float = 80, rounding=diff_round) -> torch.Tensor:
    """Differentiable JPEG round trip of (B, H, W, 3) RGB in [0, 1] at
    ``quality`` (diffjpeg.py:94); H and W multiples of 16 (pad first: a
    ValueError otherwise). Same shape, clipped to [0, 1]."""
    B, H, W, _ = img.shape
    if H % 16 or W % 16:
        raise ValueError(f"diff_jpeg: H, W must be multiples of 16 (pad first), not {H}x{W}")
    factor = quality_to_factor(quality)
    ycc = _rgb_to_ycbcr(img * 255.0)
    y = ycc[..., 0]
    cb = ycc[..., 1].reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    cr = ycc[..., 2].reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    y_t = _const(_Y_TABLE, img) * factor
    c_t = _const(_C_TABLE, img) * factor

    def codec(ch, table, h, w):
        q = rounding(_dct(_blocks(ch)) / table)
        return _unblocks(_idct(q * table), h, w)

    y2 = codec(y, y_t, H, W)
    cb2 = codec(cb, c_t, H // 2, W // 2)
    cr2 = codec(cr, c_t, H // 2, W // 2)
    cb_up = cb2.repeat_interleave(2, 1).repeat_interleave(2, 2)
    cr_up = cr2.repeat_interleave(2, 1).repeat_interleave(2, 2)
    out = _ycbcr_to_rgb(torch.stack([y2, cb_up, cr_up], dim=-1))
    return torch.clamp(out / 255.0, 0.0, 1.0)
