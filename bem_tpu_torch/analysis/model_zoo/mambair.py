"""MambaIR baseline (counterpart of bem_tpu/analysis/model_zoo/mambair.py).

The core is the port's SS2D with ``forward_type="v0"`` (z gate, LN
out-norm) and ``scan_backend="xla"``: the 4-direction fused core, never
clamped, row 8 (``csrc/ss2d_fused.cu``) on the card. GELU is the exact
erf form."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...archs.arch_util import Upsample
from ...nn.layers import Conv2d
from ...nn.ss2d import SS2D
from .common import LayerNormLast, add_blocks, seeded


class ChannelAttention(nn.Module):
    """mambair.py:30-45."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        self.down = Conv2d(num_feat, num_feat // squeeze_factor, 1)
        self.up = Conv2d(num_feat // squeeze_factor, num_feat, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.up(F.relu(self.down(x.mean((2, 3), keepdim=True)))))


class CAB(nn.Module):
    """mambair.py:48-62."""

    def __init__(self, num_feat: int, compress_ratio: int = 3, squeeze_factor: int = 30):
        super().__init__()
        self.conv1 = Conv2d(num_feat, num_feat // compress_ratio, 3, padding=1)
        self.conv2 = Conv2d(num_feat // compress_ratio, num_feat, 3, padding=1)
        self.ca = ChannelAttention(num_feat, squeeze_factor)

    def forward(self, x):
        return self.ca(self.conv2(F.gelu(self.conv1(x))))


class VSSBlockIR(nn.Module):
    """The SS2D branch and the CAB branch with learned skip scales
    (mambair.py:65-84)."""

    def __init__(self, hidden_dim: int, d_state: int = 16, mlp_ratio: float = 2.0):
        super().__init__()
        self.ln_1 = LayerNormLast(hidden_dim)
        self.skip_scale = nn.Parameter(torch.empty(hidden_dim))
        self.self_attention = SS2D(d_model=hidden_dim, d_state=d_state, ssm_ratio=mlp_ratio,
                                   d_conv=3, conv_bias=True, forward_type="v0",
                                   scan_backend="xla")
        self.skip_scale2 = nn.Parameter(torch.empty(hidden_dim))
        self.ln_2 = LayerNormLast(hidden_dim)
        self.conv_blk = CAB(hidden_dim)

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.skip_scale.fill_(1.0)
        self.skip_scale2.fill_(1.0)

    def forward(self, x):
        x = x * self.skip_scale[:, None, None] + self.self_attention(self.ln_1(x))
        return x * self.skip_scale2[:, None, None] + self.conv_blk(self.ln_2(x))


class ResidualGroupIR(nn.Module):
    """mambair.py:87-100 (resi_connection '1conv')."""

    def __init__(self, dim: int, depth: int, mlp_ratio: float = 2.0):
        super().__init__()
        self.blocks = add_blocks(self, "block", lambda i: VSSBlockIR(dim, 16, mlp_ratio), depth)
        self.conv = Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        y = x
        for blk in self.blocks:
            y = blk(y)
        return self.conv(y) + x


class MambaIR(nn.Module):
    """mambair.py:103-138; comparison config embed 180, depths (6,)*6,
    pixel-shuffle x2."""

    def __init__(self, in_chans: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6), mlp_ratio: float = 2.0,
                 upscale: int = 2, img_range: float = 1.0, upsampler: str = "pixelshuffle",
                 rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040)):
        super().__init__()
        self.img_range, self.upsampler, self.upscale = img_range, upsampler, upscale
        self.register_buffer("mean", torch.tensor(rgb_mean).reshape(1, -1, 1, 1),
                             persistent=False)
        self.conv_first = Conv2d(in_chans, embed_dim, 3, padding=1)
        self.patch_norm = LayerNormLast(embed_dim)
        self.layers = add_blocks(self, "layer",
                                 lambda i: ResidualGroupIR(embed_dim, depths[i], mlp_ratio),
                                 len(depths))
        self.norm = LayerNormLast(embed_dim)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3, padding=1)
        if upsampler == "pixelshuffle":
            self.conv_before_upsample = Conv2d(embed_dim, 64, 3, padding=1)
            self.upsample = Upsample(upscale, 64)
            self.conv_last = Conv2d(64, in_chans, 3, padding=1)
        elif upsampler == "pixelshuffledirect":
            self.upsample_conv = Conv2d(embed_dim, upscale ** 2 * in_chans, 3, padding=1)
        else:
            self.conv_last = Conv2d(embed_dim, in_chans, 3, padding=1)

    def forward(self, x):
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        feat = self.conv_first(x)
        y = self.patch_norm(feat)
        for layer in self.layers:
            y = layer(y)
        feat = self.conv_after_body(self.norm(y)) + feat
        if self.upsampler == "pixelshuffle":
            feat = F.leaky_relu(self.conv_before_upsample(feat), 0.01)
            out = self.conv_last(self.upsample(feat))
        elif self.upsampler == "pixelshuffledirect":
            out = F.pixel_shuffle(self.upsample_conv(feat), self.upscale)
        else:
            out = x + self.conv_last(feat)
        return out / self.img_range + mean


def buildMambaIR(upscale=2, gen=None, device="cuda"):
    return seeded(MambaIR(embed_dim=180, depths=(6, 6, 6, 6, 6, 6), mlp_ratio=2.0,
                          upscale=upscale, img_range=1.0, upsampler="pixelshuffle"), gen, device)
