"""RetinexFormer baseline (counterpart of bem_tpu/analysis/model_zoo/retinexformer.py).

The attention is bem_tpu's, einsum for einsum, on tokens (B, H*W, C) taken
from the channel-first maps. GELU is the exact erf form (torch's default,
bem_tpu's ``_gelu_exact``)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import Conv2d, ConvTranspose2d
from .common import LayerNormLast, Linear, seeded


def _tokens(x):
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


class IlluminationEstimator(nn.Module):
    """retinexformer.py:23-39."""

    def __init__(self, n_fea_middle: int, n_fea_in: int = 4, n_fea_out: int = 3):
        super().__init__()
        self.conv1 = Conv2d(n_fea_in, n_fea_middle, 1)
        self.depth_conv = Conv2d(n_fea_middle, n_fea_middle, 5, padding=2, groups=n_fea_in)
        self.conv2 = Conv2d(n_fea_middle, n_fea_out, 1)

    def forward(self, img):
        inp = torch.cat([img, img.mean(1, keepdim=True)], 1)
        illu_fea = self.depth_conv(self.conv1(inp))
        return illu_fea, self.conv2(illu_fea)


class IGMSA(nn.Module):
    """Illumination-guided transposed (channel-wise) attention
    (retinexformer.py:42-90)."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        self.dim, self.dim_head, self.heads = dim, dim_head, heads
        dh = dim_head * heads
        self.to_q = Linear(dim, dh, bias=False)
        self.to_k = Linear(dim, dh, bias=False)
        self.to_v = Linear(dim, dh, bias=False)
        self.rescale = nn.Parameter(torch.empty(heads, 1, 1))
        self.proj = Linear(dh, dim, bias=True)
        self.pos1 = Conv2d(dh, dim, 3, padding=1, groups=dim, bias=False)
        self.pos2 = Conv2d(dim, dim, 3, padding=1, groups=dim, bias=False)

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.rescale.fill_(1.0)

    def forward(self, x_in, illu_fea):
        b, c, h, w = x_in.shape
        n, nh, d = h * w, self.heads, self.dim_head
        x = _tokens(x_in)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)

        def heads_split(t):  # (b, n, h*d) -> (b, heads, n, d)
            return t.reshape(b, n, nh, d).transpose(1, 2)

        q, k, vh, illu_h = map(heads_split, (q, k, v, _tokens(illu_fea)))
        vh = vh * illu_h
        # transposed attention over the channels: q, k, v -> (b, heads, d, n)
        q, k, vh = (F.normalize(q.transpose(-2, -1), dim=-1),
                    F.normalize(k.transpose(-2, -1), dim=-1), vh.transpose(-2, -1))
        attn = torch.einsum("bhdn,bhen->bhde", k, q)
        attn = (attn * self.rescale).softmax(-1)
        out = torch.einsum("bhde,bhen->bhdn", attn.transpose(-2, -1), vh)
        out = out.permute(0, 3, 1, 2).reshape(b, n, nh * d)
        out_c = self.proj(out).transpose(1, 2).reshape(b, c, h, w)
        vp = v.transpose(1, 2).reshape(b, nh * d, h, w)
        return out_c + self.pos2(F.gelu(self.pos1(vp)))


class FeedForward(nn.Module):
    """retinexformer.py:93-106."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        h = dim * mult
        self.fc1 = Conv2d(dim, h, 1, bias=False)
        self.dw = Conv2d(h, h, 3, padding=1, groups=h, bias=False)
        self.fc2 = Conv2d(h, dim, 1, bias=False)

    def forward(self, x):
        return self.fc2(F.gelu(self.dw(F.gelu(self.fc1(x)))))


class IGAB(nn.Module):
    """retinexformer.py:109-125."""

    def __init__(self, dim: int, dim_head: int, heads: int, num_blocks: int):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"attn_{i}", IGMSA(dim, dim_head, heads))
            self.add_module(f"norm_{i}", LayerNormLast(dim))
            self.add_module(f"ff_{i}", FeedForward(dim))

    def forward(self, x, illu_fea):
        for i in range(self.num_blocks):
            x = getattr(self, f"attn_{i}")(x, illu_fea) + x
            x = getattr(self, f"ff_{i}")(getattr(self, f"norm_{i}")(x)) + x
        return x


class Denoiser(nn.Module):
    """retinexformer.py:128-166."""

    def __init__(self, in_dim: int = 3, out_dim: int = 3, dim: int = 31, level: int = 2,
                 num_blocks: Sequence[int] = (2, 4, 4)):
        super().__init__()
        self.level = level
        self.embedding = Conv2d(in_dim, dim, 3, padding=1, bias=False)
        d = dim
        for i in range(level):
            self.add_module(f"enc_igab_{i}", IGAB(d, dim, d // dim, num_blocks[i]))
            self.add_module(f"enc_down_{i}", Conv2d(d, 2 * d, 4, padding=1, stride=2, bias=False))
            self.add_module(f"enc_illu_down_{i}",
                            Conv2d(d, 2 * d, 4, padding=1, stride=2, bias=False))
            d *= 2
        self.bottleneck = IGAB(d, dim, d // dim, num_blocks[-1])
        for i in range(level):
            self.add_module(f"dec_up_{i}", ConvTranspose2d(d, d // 2, 2))
            self.add_module(f"dec_fuse_{i}", Conv2d(d, d // 2, 1, bias=False))
            self.add_module(f"dec_igab_{i}",
                            IGAB(d // 2, dim, (d // 2) // dim, num_blocks[level - 1 - i]))
            d //= 2
        self.mapping = Conv2d(dim, out_dim, 3, padding=1, bias=False)

    def forward(self, x, illu_fea):
        fea = self.embedding(x)
        encs, illus = [], []
        for i in range(self.level):
            fea = getattr(self, f"enc_igab_{i}")(fea, illu_fea)
            encs.append(fea)
            illus.append(illu_fea)
            fea = getattr(self, f"enc_down_{i}")(fea)
            illu_fea = getattr(self, f"enc_illu_down_{i}")(illu_fea)
        fea = self.bottleneck(fea, illu_fea)
        for i in range(self.level):
            fea = getattr(self, f"dec_up_{i}")(fea)
            fea = getattr(self, f"dec_fuse_{i}")(torch.cat([fea, encs[self.level - 1 - i]], 1))
            fea = getattr(self, f"dec_igab_{i}")(fea, illus[self.level - 1 - i])
        return self.mapping(fea) + x


class RetinexFormer(nn.Module):
    """retinexformer.py:169-183 (the comparison config: n_feat 40, stage 1,
    blocks (1, 2, 2))."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, n_feat: int = 31,
                 stage: int = 3, num_blocks: Sequence[int] = (1, 1, 1)):
        super().__init__()
        self.stage = stage
        for s in range(stage):
            self.add_module(f"estimator_{s}", IlluminationEstimator(n_feat))
            self.add_module(f"denoiser_{s}",
                            Denoiser(in_channels, out_channels, n_feat, 2, num_blocks))

    def forward(self, x):
        for s in range(self.stage):
            illu_fea, illu_map = getattr(self, f"estimator_{s}")(x)
            x = getattr(self, f"denoiser_{s}")(x * illu_map + x, illu_fea)
        return x


def buildRetinexFormer(gen=None, device="cuda"):
    return seeded(RetinexFormer(in_channels=3, out_channels=3, n_feat=40, stage=1,
                                num_blocks=(1, 2, 2)), gen, device)
