"""EDSR and RCAN baselines (counterpart of bem_tpu/analysis/model_zoo/edsr_rcan.py)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...archs.arch_util import ResidualBlockNoBN, Upsample
from ...nn.layers import Conv2d
from .common import CALayer, MeanShift, add_blocks, seeded


class EDSR(nn.Module):
    """EDSR (edsr_rcan.py:16-46): 16 residual blocks of 64 features, x2."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_block: int = 16, upscale: int = 2, res_scale: float = 1.0,
                 img_range: float = 255.0,
                 rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040)):
        super().__init__()
        self.img_range = img_range
        self.register_buffer("mean", torch.tensor(rgb_mean).reshape(1, -1, 1, 1),
                             persistent=False)
        self.conv_first = Conv2d(num_in_ch, num_feat, 3, padding=1)
        self.body = add_blocks(self, "body", lambda i: ResidualBlockNoBN(num_feat, res_scale),
                               num_block)
        self.conv_after_body = Conv2d(num_feat, num_feat, 3, padding=1)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = Conv2d(num_feat, num_out_ch, 3, padding=1)

    def forward(self, x):
        mean = self.mean.to(x.dtype)
        x = self.conv_first((x - mean) * self.img_range)
        res = x
        for blk in self.body:
            res = blk(res)
        res = self.conv_after_body(res) + x
        return self.conv_last(self.upsample(res)) / self.img_range + mean


def buildEDSR(gen=None, device="cuda"):
    return seeded(EDSR(), gen, device)


class RCAB(nn.Module):
    """Residual channel attention block (edsr_rcan.py:52-64)."""

    def __init__(self, n_feat: int, reduction: int = 16):
        super().__init__()
        self.conv1 = Conv2d(n_feat, n_feat, 3, padding=1)
        self.conv2 = Conv2d(n_feat, n_feat, 3, padding=1)
        self.ca = CALayer(n_feat, reduction)

    def forward(self, x):
        return x + self.ca(self.conv2(F.relu(self.conv1(x))))


class ResidualGroup(nn.Module):
    """RCABs and a 3x3 conv around a skip (edsr_rcan.py:67-80)."""

    def __init__(self, n_feat: int, reduction: int, n_resblocks: int):
        super().__init__()
        self.blocks = add_blocks(self, "rcab", lambda i: RCAB(n_feat, reduction), n_resblocks)
        self.conv = Conv2d(n_feat, n_feat, 3, padding=1)

    def forward(self, x):
        res = x
        for blk in self.blocks:
            res = blk(res)
        return x + self.conv(res)


class RCAN(nn.Module):
    """RCAN at the comparison config: 10 groups x 20 RCABs, 64 features,
    x2 pixel-shuffle tail (edsr_rcan.py:83-107)."""

    def __init__(self, n_resgroups: int = 10, n_resblocks: int = 20, n_feats: int = 64,
                 reduction: int = 16, scale: int = 2):
        super().__init__()
        self.sub_mean = MeanShift(255.0, sign=-1)
        self.head = Conv2d(3, n_feats, 3, padding=1)
        self.groups = add_blocks(self, "group",
                                 lambda i: ResidualGroup(n_feats, reduction, n_resblocks),
                                 n_resgroups)
        self.body_conv = Conv2d(n_feats, n_feats, 3, padding=1)
        self.tail_up = Upsample(scale, n_feats)
        self.tail_conv = Conv2d(n_feats, 3, 3, padding=1)
        self.add_mean = MeanShift(255.0, sign=1)

    def forward(self, x):
        x = self.head(self.sub_mean(x))
        res = x
        for g in self.groups:
            res = g(res)
        res = self.body_conv(res) + x
        return self.add_mean(self.tail_conv(self.tail_up(res)))


def buildRCAN(gen=None, device="cuda"):
    return seeded(RCAN(), gen, device)
