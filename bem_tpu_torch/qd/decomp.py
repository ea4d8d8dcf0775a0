"""The compact two-branch quaternion decomposition, NCHW: counterpart of
bem_tpu/qd/decomp.py (CompactTwoBranchModel with its SEBlock, MSEFBlock and
MultiHeadSelfAttention), an experimental alternative to ``Decomp`` that no
option file uses.

Its attention runs over all H x W positions as plain matmul, softmax,
matmul, so its score matrix holds (H W)^2 entries a head: no path runs it
at full width. Parameter names are the flax tree's (``convert.py`` maps
them); the LayerNorm keeps flax's eps, 1e-6.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv2d, Dense, LayerNorm2d
from ..ops.quaternion import rgb_to_quaternions

_KAIMING = dict(weight_init="kaiming_uniform_relu", zero_bias=True)


class SEBlock(nn.Module):
    """Squeeze-excite with a tanh gate."""

    def __init__(self, channels: int, reduction_ratio: int = 16):
        super().__init__()
        hidden = channels // reduction_ratio
        self.fc1 = Dense(channels, hidden, weight_init="kaiming_uniform_relu")
        self.fc2 = Dense(hidden, channels, weight_init="kaiming_uniform_relu")

    def forward(self, x):
        y = torch.tanh(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * y[:, :, None, None]


class MSEFBlock(nn.Module):
    """LN -> (depthwise 3x3 conv) * (SE) -> + residual."""

    def __init__(self, filters: int):
        super().__init__()
        self.layer_norm = LayerNorm2d(filters, eps=1e-6)
        self.depthwise_conv = Conv2d(filters, filters, 3, padding=1, groups=filters, **_KAIMING)
        self.se_attn = SEBlock(filters)

    def forward(self, x):
        x_norm = self.layer_norm(x)
        return self.depthwise_conv(x_norm) * self.se_attn(x_norm) + x


class MultiHeadSelfAttention(nn.Module):
    """Spatial multi-head self-attention over the H*W positions; channel
    c = head * head_dim + d, as bem_tpu splits its heads."""

    def __init__(self, embed_size: int, num_heads: int):
        super().__init__()
        if embed_size % num_heads:
            raise ValueError(f"embed_size {embed_size} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        for name in ("query_dense", "key_dense", "value_dense", "combine_heads"):
            self.add_module(name, Dense(embed_size, embed_size, weight_init="xavier_uniform"))

    def forward(self, x):
        B, C, H, W = x.shape
        hd = C // self.num_heads
        tokens = x.reshape(B, C, H * W)

        def heads(t):  # (B, C, L) -> (B, heads, L, hd)
            return t.reshape(B, self.num_heads, hd, H * W).transpose(-1, -2)

        q, k, v = (heads(getattr(self, n)(tokens))
                   for n in ("query_dense", "key_dense", "value_dense"))
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        out = torch.matmul(attn, v).transpose(-1, -2).reshape(B, C, H * W)
        return self.combine_heads(out).reshape(B, C, H, W)


class CompactTwoBranchModel(nn.Module):
    """Embed the 8-channel quaternion encoding, run the MSEF (local) and
    attention (global) branches, fuse, and emit the interleaved Q1 / Q2.

    forward(img (B, 3, H, W)) -> (Q1, Q2), each (B, 4, H, W)."""

    def __init__(self, embed_dim: int = 32, num_heads: int = 4):
        super().__init__()
        self.embed = Conv2d(8, embed_dim, 3, padding=1, **_KAIMING)
        self.msef_branch = MSEFBlock(embed_dim)
        self.attn_branch = MultiHeadSelfAttention(embed_dim, num_heads)
        self.fuse = Conv2d(2 * embed_dim, embed_dim, 1, **_KAIMING)
        self.out_conv = Conv2d(embed_dim, 8, 3, padding=1, **_KAIMING)

    def forward(self, img):
        x = self.embed(rgb_to_quaternions(img, eps=1e-8))
        fused = self.fuse(torch.cat([self.msef_branch(x), self.attn_branch(x)], dim=1))
        out = self.out_conv(fused)
        return out[:, 0::2], out[:, 1::2]
