"""U-Net building blocks, NCHW: counterpart of bem_tpu/archs/arch_util.py
(PatchMerging, DualUpSample, ConvDown, DeconvUp, SAM with its DB and CSAF;
the Decomp family's CrossFusionBlock, SEBlock, SpatialAttention; the model
zoo's ResidualBlockNoBN and Upsample; LN2DLinear; BasicSR's EDVR-era
``flow_warp`` and ``DCNv2Pack``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import init
from ..nn.layers import Conv2d, ConvTranspose2d, LayerNorm2d, PReLU, pixel_shuffle_cf


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


class ConvDown(nn.Module):
    """4x4 stride-2 conv doubling the channels, no bias (the U-Net's
    ``use_pixelshuffle: false`` down-sampling, arch_util.py:30)."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, 2 * in_channels, 4, padding=1, stride=2, bias=False)

    def forward(self, x):
        return self.conv(x)


class DeconvUp(nn.Module):
    """2x2 stride-2 transposed conv halving the channels (arch_util.py:87)."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.deconv = ConvTranspose2d(in_channels, in_channels // 2, 2)

    def forward(self, x):
        return self.deconv(x)


def resize_bilinear_cf(x, size):
    """(B, C, H, W) -> (B, C, *size), bem_tpu's ``resize_bilinear``
    (jax.image.resize "linear": half-pixel centres, antialiased where it
    shrinks), computed in fp32 and rounded once to x's dtype."""
    return F.interpolate(x.float(), size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True).to(x.dtype)


class DB(nn.Module):
    """Dilated dense block (arch_util.py:225): five 3x3 convs with
    dilations ``d_list``, each ReLU'd and concatenated in front of its
    input, then a 1x1 back to ``in_channel``. The convs are raw parameters
    ``conv<i>_weight`` (OIHW) / ``conv<i>_bias``, as bem_tpu declares them."""

    def __init__(self, in_channel: int, d_list=(1, 2, 3, 2, 1), inter_num: int = 24):
        super().__init__()
        self.d_list = tuple(d_list)
        c = in_channel
        for i in range(len(self.d_list)):
            self.register_parameter(f"conv{i}_weight", nn.Parameter(torch.empty(inter_num, c, 3, 3)))
            self.register_parameter(f"conv{i}_bias", nn.Parameter(torch.empty(inter_num)))
            c += inter_num
        self.conv_post = Conv2d(c, in_channel, 1)

    @torch.no_grad()
    def reset_parameters(self, gen):
        for i in range(len(self.d_list)):
            w = getattr(self, f"conv{i}_weight")
            fan_in = w.shape[1] * 9
            init.torch_default_(w, fan_in, gen)
            init.torch_default_(getattr(self, f"conv{i}_bias"), fan_in, gen)

    def forward(self, x):
        t = x
        for i, d in enumerate(self.d_list):
            w, b = getattr(self, f"conv{i}_weight"), getattr(self, f"conv{i}_bias")
            _t = F.relu(F.conv2d(t, w.to(t.dtype), b.to(t.dtype), padding=d, dilation=d))
            t = torch.cat([_t, t], dim=1)
        return self.conv_post(t)


class CSAF(nn.Module):
    """Cross-scale channel attention fusion of three maps (arch_util.py:257)."""

    def __init__(self, in_chnls: int, ratio: int = 4):
        super().__init__()
        self.compress1 = Conv2d(in_chnls, in_chnls // ratio, 1)
        self.compress2 = Conv2d(in_chnls // ratio, in_chnls // ratio, 1)
        self.excitation = Conv2d(in_chnls // ratio, in_chnls, 1)

    def forward(self, x0, x2, x4):
        out = torch.cat([t.mean(dim=(2, 3), keepdim=True) for t in (x0, x2, x4)], dim=1)
        out = F.relu(self.compress2(F.relu(self.compress1(out))))
        w0, w2, w4 = torch.sigmoid(self.excitation(out)).chunk(3, dim=1)
        return x0 * w0 + x2 * w2 + x4 * w4


class SAM(nn.Module):
    """Multi-scale dilated dense attention (arch_util.py:405): a DB at
    full, half and quarter resolution, fused by CSAF, plus x."""

    def __init__(self, in_channel: int, d_list=(1, 2, 3, 2, 1), inter_num: int = 24):
        super().__init__()
        self.basic_block = DB(in_channel, d_list, inter_num)
        self.basic_block_2 = DB(in_channel, d_list, inter_num)
        self.basic_block_4 = DB(in_channel, d_list, inter_num)
        self.fusion = CSAF(3 * in_channel)

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        if H < 4 or W < 4:  # bem_tpu's resize divides by zero there
            raise ValueError(f"SAM on a {H}x{W} map: its quarter scale needs H, W >= 4")
        x2 = resize_bilinear_cf(x, (int(H * 0.5), int(W * 0.5)))
        x4 = resize_bilinear_cf(x, (int(H * 0.25), int(W * 0.25)))
        y0 = self.basic_block(x)
        y2 = resize_bilinear_cf(self.basic_block_2(x2), (H, W))
        y4 = resize_bilinear_cf(self.basic_block_4(x4), (H, W))
        return x + self.fusion(y0, y2, y4)


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

    def upsample2(self, t):
        """The bilinear branch's x2 upsample; a method, so that a row-sharded
        forward (parallel/spatial.py) can bind its band form."""
        return _upsample2(t)

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
            return pixel_shuffle_cf(q, 2) + self.upsample2(v)
        if fold_tail is not None:
            raise ValueError("fold_tail needs the folded (bf16) form")
        xp = self.up_p_conv2(pixel_shuffle_cf(p, 2))
        xb = self.up_b_conv2(self.upsample2(b))
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


class LN2DLinear(nn.Module):
    """LayerNorm + zero-init 1x1 conv (arch_util.py:212-222)."""

    def __init__(self, in_channels: int, out_channels: int, use_bias: bool = False):
        super().__init__()
        self.norm = LayerNorm2d(in_channels)
        self.linear = Conv2d(in_channels, out_channels, 1, bias=use_bias, weight_init="zeros")

    def forward(self, x):
        return self.linear(self.norm(x))


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x))) * res_scale, 3x3 convs (arch_util.py:277-289)."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv2 = Conv2d(num_feat, num_feat, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x))) * self.res_scale


class Upsample(nn.Module):
    """Pixel-shuffle upsampler for scale 2^n (n steps of a 3x3 conv to 4C
    and a x2 shuffle) or 3 (arch_util.py:292-311); the convs are
    ``conv_<i>``."""

    def __init__(self, scale: int, num_feat: int):
        super().__init__()
        if scale & (scale - 1) == 0:
            self.factors = [2] * int(math.log2(scale))
        elif scale == 3:
            self.factors = [3]
        else:
            raise ValueError(f"scale {scale} is not supported")
        for i, r in enumerate(self.factors):
            self.add_module(f"conv_{i}", Conv2d(num_feat, r * r * num_feat, 3, padding=1))

    def forward(self, x):
        for i, r in enumerate(self.factors):
            x = pixel_shuffle_cf(getattr(self, f"conv_{i}")(x), r)
        return x


def flow_warp(x: torch.Tensor, flow: torch.Tensor, padding_mode: str = "zeros") -> torch.Tensor:
    """x (B, C, H, W) warped by ``flow`` (B, H, W, 2), (dx, dy) in pixels:
    each output pixel the bilinear sample of x at its position plus its
    flow, zero outside (bem_tpu arch_util.py:314). ``padding_mode`` is
    accepted and ignored, as in bem_tpu."""
    from ..ops.legacy import bilinear_gather

    B, C, H, W = x.shape
    gy, gx = torch.meshgrid(torch.arange(H, dtype=flow.dtype, device=flow.device),
                            torch.arange(W, dtype=flow.dtype, device=flow.device),
                            indexing="ij")
    ys = (gy[None] + flow[..., 1]).reshape(B, H * W)
    xs = (gx[None] + flow[..., 0]).reshape(B, H * W)
    return bilinear_gather(x, ys, xs).reshape(B, C, H, W)


class DCNv2Pack(nn.Module):
    """Modulated deformable conv whose offsets and mask a zero-initialized
    conv computes from ``feat`` (bem_tpu arch_util.py:327): its output
    splits in three, the first two interleaved into (dy, dx) pairs, the
    third through a sigmoid. ``weight`` (out, in, k, k) is bem_tpu's HWIO
    ``kernel``, ``bias`` its bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 deform_groups: int = 1, feat_channels: int = None):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.deform_groups = k, deform_groups
        self.conv_offset = Conv2d(feat_channels or in_channels, deform_groups * 3 * k * k, k,
                                  padding=k // 2, weight_init="zeros", zero_bias=True)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels))

    @torch.no_grad()
    def reset_parameters(self, gen):
        fan_in = self.weight.shape[1] * self.kernel_size ** 2
        init.torch_default_(self.weight, fan_in, gen)
        init.torch_default_(self.bias, fan_in, gen)

    def forward(self, x, feat):
        from ..ops.legacy import modulated_deform_conv2d

        o1, o2, mask = self.conv_offset(feat).chunk(3, dim=1)
        offset = torch.stack([o1, o2], 2).flatten(1, 2)
        return modulated_deform_conv2d(x, offset, torch.sigmoid(mask), self.weight, self.bias,
                                       stride=1, padding=self.kernel_size // 2,
                                       deform_groups=self.deform_groups)
