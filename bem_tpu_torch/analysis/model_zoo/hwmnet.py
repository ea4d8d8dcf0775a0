"""HWMNet-LOL baseline (counterpart of bem_tpu/analysis/model_zoo/hwmnet.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import Conv2d, PReLU
from .common import CALayer, SALayer, dwt_haar, iwt_haar, resize_bilinear_torch, seeded


class HWB(nn.Module):
    """Half-wavelet dual attention block (hwmnet.py:13-48); one PReLU ``act``
    serves the body and the tail, as in the reference."""

    def __init__(self, n_feat: int, o_feat: int, reduction: int = 16):
        super().__init__()
        self.half = half = n_feat // 2
        self.act = PReLU()
        self.body1 = Conv2d(4 * half, n_feat, 3, padding=1, bias=False)
        self.body2 = Conv2d(n_feat, 2 * n_feat, 3, padding=1, bias=False)
        self.wsa = SALayer()
        self.wca = CALayer(2 * n_feat, reduction, use_bias=False)
        self.conv1x1 = Conv2d(4 * n_feat, 2 * n_feat, 1, bias=False)
        self.conv3x3 = Conv2d(n_feat, o_feat, 3, padding=1, bias=False)
        self.conv1x1_final = Conv2d(n_feat, o_feat, 1, bias=False)

    def forward(self, x):
        wavelet_in, identity = x[:, :self.half], x[:, self.half:]
        x_dwt = dwt_haar(wavelet_in)
        res = self.body2(self.act(self.body1(x_dwt)))
        res = self.conv1x1(torch.cat([self.wsa(res), self.wca(res)], 1)) + x_dwt
        out = torch.cat([iwt_haar(res), identity], 1)
        return self.act(self.conv3x3(out)) + self.conv1x1_final(x)


class PSDown(nn.Module):
    """PixelUnshuffle + 1x1 conv (hwmnet.py:51-59)."""

    def __init__(self, out_size: int):
        super().__init__()
        self.conv1 = Conv2d(4 * out_size, out_size, 1)

    def forward(self, x):
        return self.conv1(F.pixel_unshuffle(x, 2))


class PSUp(nn.Module):
    """PixelShuffle + 1x1 conv (hwmnet.py:62-70)."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.conv1 = Conv2d(in_size // 4, out_size, 1)

    def forward(self, x):
        return self.conv1(F.pixel_shuffle(x, 2))


class UNetConvBlock(nn.Module):
    """HWB body + 1x1 tail (+ a PS down) (hwmnet.py:73-86)."""

    def __init__(self, in_size: int, out_size: int, downsample: bool):
        super().__init__()
        self.downsample = downsample
        self.hwb = HWB(in_size, in_size)
        self.tail = Conv2d(in_size, out_size, 1)
        if downsample:
            self.down = PSDown(out_size)

    def forward(self, x):
        out = self.tail(self.hwb(x))
        if self.downsample:
            return self.down(out), out
        return out


class UNetUpBlock(nn.Module):
    """PS up, the skip concatenated, a conv block (hwmnet.py:89-100)."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.up = PSUp(in_size, out_size)
        self.conv_block = UNetConvBlock(in_size, out_size, False)

    def forward(self, x, bridge):
        return self.conv_block(torch.cat([self.up(x), bridge], 1))


class SKFF(nn.Module):
    """Selective kernel feature fusion (hwmnet.py:103-125): a softmax over
    the branches (dim 1 of the stacked maps)."""

    def __init__(self, in_channels: int, height: int = 3, reduction: int = 8):
        super().__init__()
        d = max(in_channels // reduction, 4)
        self.height = height
        self.du = Conv2d(in_channels, d, 1, bias=False)
        self.du_act = PReLU()
        for i in range(height):
            self.add_module(f"fc_{i}", Conv2d(d, in_channels, 1, bias=False))

    def forward(self, inp_feats):
        stacked = torch.stack(inp_feats, 1)                     # (B, height, C, H, W)
        feats_z = self.du_act(self.du(stacked.sum(1).mean((2, 3), keepdim=True)))
        att = torch.stack([getattr(self, f"fc_{i}")(feats_z) for i in range(self.height)], 1)
        return (stacked * att.softmax(1)).sum(1)


class HWMNet(nn.Module):
    """HWMNet-LOL (hwmnet.py:128-174); comparison config wf 96, depth 4."""

    def __init__(self, in_chn: int = 3, wf: int = 96, depth: int = 4):
        super().__init__()
        self.depth = depth
        self.conv_01 = Conv2d(in_chn, wf, 3, padding=1)
        prev = 0
        for i in range(depth):
            self.add_module(f"down_{i}", UNetConvBlock(prev + wf, 2 ** i * wf, i + 1 < depth))
            prev = 2 ** i * wf
        self.bottom_conv = Conv2d(prev, wf, 3, padding=1)
        for j, i in enumerate(reversed(range(depth - 1))):
            self.add_module(f"skip_conv_{j}", Conv2d(2 ** i * wf, 2 ** i * wf, 3, padding=1))
            self.add_module(f"up_{j}", UNetUpBlock(prev, 2 ** i * wf))
            self.add_module(f"conv_up_{j}", Conv2d(2 ** i * wf, wf, 3, padding=1))
            prev = 2 ** i * wf
        self.final_ff = SKFF(wf, height=depth)
        self.last = Conv2d(wf, in_chn, 3, padding=1)

    def forward(self, img):
        depth = self.depth
        x1 = self.conv_01(img)
        scale_img = img
        encs = []
        for i in range(depth):
            blk = getattr(self, f"down_{i}")
            if i > 0:
                h, w = scale_img.shape[2] // 2, scale_img.shape[3] // 2
                scale_img = resize_bilinear_torch(scale_img, (h, w))
                x1 = torch.cat([x1, self.conv_01(scale_img)], 1)
            if i + 1 < depth:
                x1, x1_up = blk(x1)
                encs.append(x1_up)
            else:
                x1 = blk(x1)
        full = img.shape[2:]
        ms_result = [resize_bilinear_torch(self.bottom_conv(x1), full)]
        for j, i in enumerate(reversed(range(depth - 1))):
            skip = getattr(self, f"skip_conv_{j}")(encs[-j - 1])
            x1 = getattr(self, f"up_{j}")(x1, skip)
            ms_result.append(getattr(self, f"conv_up_{j}")(
                resize_bilinear_torch(x1, full) if i > 0 else x1))
        return self.last(self.final_ff(ms_result)) + img


def buildHWMNet(gen=None, device="cuda"):
    return seeded(HWMNet(in_chn=3, wf=96, depth=4), gen, device)
