"""U-Net building blocks, NCHW: counterpart of bem_tpu/archs/arch_util.py
(PatchMerging, DualUpSample; the Decomp family's CrossFusionBlock, SEBlock,
SpatialAttention)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv2d, LayerNorm2d, PReLU, pixel_shuffle_cf


def fold_dual_upsample(dtype) -> bool:
    """DualUpSample takes its folded serving form on the bf16 stream only
    (bem_tpu arch_util._fold_dual_upsample without its env override)."""
    return dtype == torch.bfloat16


def _kio(conv: Conv2d) -> torch.Tensor:
    """A 1x1 conv's weight as an fp32 (in, out) matrix (the HWIO [0, 0] slice)."""
    return conv.weights()[0][:, :, 0, 0].float().t()


class PatchMerging(nn.Module):
    """2x2 space-to-depth + LN + 1x1 reduction (C -> 2C).

    The channel order is bem_tpu's reshape/transpose form, identical to the
    reference's [x0, x1, x2, x3] strided-slice concat: channel block
    2*wp + hp holds pixel (2i + hp, 2j + wp)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm2d(4 * dim)
        self.reduction = Conv2d(4 * dim, 2 * dim, 1, bias=False)

    def forward(self, x):
        B, C, H, W = x.shape
        x = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 5, 3, 1, 2, 4)
        x = x.reshape(B, 4 * C, H // 2, W // 2)
        return self.reduction(self.norm(x))


def _upsample2(t):
    return F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=False)


class DualUpSample(nn.Module):
    """Pixel-shuffle + bilinear dual upsample (x2), C -> C/2.

    Two forms of one function, chosen by dtype as bem_tpu does: the
    reference op order on fp32, and on bf16 the folded form in which the
    1x1 convs after the PReLUs (and optionally the caller's fusion-conv
    half, ``fold_tail``) are composed at quarter resolution
    (arch_util.py:139-179)."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.up_p_conv1 = Conv2d(c, 2 * c, 1, bias=False)
        self.up_p_prelu = PReLU()
        self.up_p_conv2 = Conv2d(c // 2, c // 2, 1, bias=False)
        self.up_b_conv1 = Conv2d(c, c, 1)
        self.up_b_prelu = PReLU()
        self.up_b_conv2 = Conv2d(c, c // 2, 1, bias=False)
        self.conv = Conv2d(c, c // 2, 1, bias=False)

    def forward(self, x, fold_tail=None):
        p = self.up_p_prelu(self.up_p_conv1(x))
        b = self.up_b_prelu(self.up_b_conv1(x))
        if fold_dual_upsample(x.dtype):
            c = x.shape[1]
            kc = _kio(self.conv)                         # (c, c/2): [xp | xb] rows
            a_p = _kio(self.up_p_conv2) @ kc[: c // 2]   # pixel-shuffle path
            a_b = _kio(self.up_b_conv2) @ kc[c // 2:]    # bilinear path
            if fold_tail is not None:
                a_p = a_p @ fold_tail.float()
                a_b = a_b @ fold_tail.float()
            # a_p through PixelShuffle's (i, dy, dx) channel order
            eye4 = torch.eye(4, device=x.device)
            m = (a_p[:, None, :, None] * eye4[None, :, None, :]).reshape(2 * c, -1)
            q = torch.einsum("bchw,cd->bdhw", p, m.to(x.dtype))
            v = torch.einsum("bchw,cd->bdhw", b, a_b.to(x.dtype))
            return pixel_shuffle_cf(q, 2) + _upsample2(v)
        if fold_tail is not None:
            raise ValueError("fold_tail needs the folded (bf16) form")
        xp = self.up_p_conv2(pixel_shuffle_cf(p, 2))
        xb = self.up_b_conv2(_upsample2(b))
        return self.conv(torch.cat([xp, xb], dim=1))


class CrossFusionBlock(nn.Module):
    """x_tgt + gate * 1x1(x_src), ``gate`` (C,) ones at init."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.gate = nn.Parameter(torch.empty(in_channels))
        self.transform = Conv2d(in_channels, in_channels, 1)

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.gate.fill_(1.0)

    def forward(self, x_src, x_tgt):
        return x_tgt + self.gate.to(x_tgt.dtype)[:, None, None] * self.transform(x_src)


class SEBlock(nn.Module):
    """Squeeze-excitation channel attention."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv2d(channel, channel // reduction, 1, bias=False)
        self.fc2 = Conv2d(channel // reduction, channel, 1, bias=False)

    def forward(self, x):
        y = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(y)


class SpatialAttention(nn.Module):
    """Channel mean / max pooled spatial attention."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x):
        pooled = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv(pooled))
