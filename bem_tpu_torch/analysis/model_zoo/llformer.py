"""LLFormer baseline (counterpart of bem_tpu/analysis/model_zoo/llformer.py).

The axis attention and the layer fusion run on bem_tpu's reshapes of the
channel-last view of each map, einsum for einsum; GELU is the exact erf
form."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import Conv2d
from .common import LayerNormLast, add_blocks, seeded


class NextAttentionImplZ(nn.Module):
    """Axis-based MSA over rows (llformer.py:27-58)."""

    def __init__(self, num_dims: int, num_heads: int):
        super().__init__()
        c = num_dims
        self.num_heads = num_heads
        self.q1 = Conv2d(c, 3 * c, 1)
        self.q2 = Conv2d(3 * c, 3 * c, 3, padding=1, groups=3 * c)
        self.q3 = Conv2d(3 * c, 3 * c, 3, padding=1, groups=3 * c)
        self.fac = nn.Parameter(torch.empty(1))
        self.fin = Conv2d(c, c, 1)

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.fac.fill_(1.0)

    def forward(self, x):
        n, c, h, w = x.shape
        nh, dh = self.num_heads, c // self.num_heads
        qkv = self.q3(self.q2(self.q1(x))).permute(0, 2, 3, 1)         # (n, h, w, 3c)
        q, k, v = qkv.chunk(3, -1)

        def reshape(t):  # (n, h, w, nh*dh) -> (n*nh*h, w, dh)
            return t.reshape(n, h, w, nh, dh).permute(0, 3, 1, 2, 4).reshape(n * nh * h, w, dh)

        q, k, v = map(reshape, (q, k, v))
        att = torch.einsum("bwd,bvd->bwv", F.normalize(q, dim=-1), F.normalize(k, dim=-1))
        att = (att * self.fac).softmax(-1)
        res = torch.einsum("bwv,bvd->bwd", att, v).reshape(n, nh, h, w, dh)
        return self.fin(res.permute(0, 1, 4, 2, 3).reshape(n, c, h, w))


class NextAttentionZ(nn.Module):
    """Row then column axis attention (llformer.py:61-72)."""

    def __init__(self, num_dims: int, num_heads: int = 1):
        super().__init__()
        self.row_att = NextAttentionImplZ(num_dims, num_heads)
        self.col_att = NextAttentionImplZ(num_dims, num_heads)

    def forward(self, x):
        x = self.row_att(x).transpose(2, 3)
        return self.col_att(x).transpose(2, 3)


class DualGatedFFN(nn.Module):
    """llformer.py:75-91."""

    def __init__(self, dim: int, expansion: float, use_bias: bool):
        super().__init__()
        h = int(dim * expansion)
        self.project_in = Conv2d(dim, 2 * h, 1, bias=use_bias)
        self.dwconv = Conv2d(2 * h, 2 * h, 3, padding=1, groups=2 * h, bias=use_bias)
        self.project_out = Conv2d(h, dim, 1, bias=use_bias)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, 1)
        return self.project_out(F.gelu(x2) * x1 + F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    """llformer.py:94-110; the attention convs keep their biases."""

    def __init__(self, dim: int, num_heads: int = 1, expansion: float = 2.66,
                 use_bias: bool = False):
        super().__init__()
        self.norm1 = LayerNormLast(dim)
        self.attn = NextAttentionZ(dim, num_heads)
        self.norm2 = LayerNormLast(dim)
        self.ffn = DualGatedFFN(dim, expansion, use_bias)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class LAMModuleV2(nn.Module):
    """Cross-layer attention fusion of N same-shaped maps (llformer.py:113-143)."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.qkv = Conv2d(in_dim, 3 * in_dim, 1)
        self.qkv_dwconv = Conv2d(3 * in_dim, 3 * in_dim, 3, padding=1, groups=3 * in_dim)
        self.temperature = nn.Parameter(torch.empty(1))
        self.project_out = Conv2d(in_dim, in_dim, 1)

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.temperature.fill_(1.0)

    def forward(self, feats):
        n_layers = len(feats)
        b, c, h, w = feats[0].shape
        x = torch.cat(feats, 1)                                          # (B, N*C, H, W)
        q, k, v = (t.reshape(b, n_layers, c * h * w)
                   for t in self.qkv_dwconv(self.qkv(x)).chunk(3, 1))
        att = torch.einsum("bnd,bmd->bnm", F.normalize(q, dim=-1), F.normalize(k, dim=-1))
        att = (att * self.temperature).softmax(-1)
        out = torch.einsum("bnm,bmd->bnd", att, v).reshape(b, n_layers * c, h, w)
        return self.project_out(out) + x


class Downsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.conv = Conv2d(n_feat, n_feat // 2, 3, padding=1, bias=False)

    def forward(self, x):
        return F.pixel_unshuffle(self.conv(x), 2)


class Upsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.conv = Conv2d(n_feat, 2 * n_feat, 3, padding=1, bias=False)

    def forward(self, x):
        return F.pixel_shuffle(self.conv(x), 2)


def _mix(coef, a, b):
    """coef[0] * a + coef[1] * b with (2, C) coefficients on (B, C, H, W) maps."""
    return coef[0][None, :, None, None] * a + coef[1][None, :, None, None] * b


class LLFormer(nn.Module):
    """llformer.py:160-263; comparison config dim 16, blocks (2, 4, 8, 16).
    ``coefficient`` and ``skip_2_1_kernel`` are declared by the reference
    and unused in its forward."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3, dim: int = 16,
                 num_blocks: Sequence[int] = (2, 4, 8, 16), num_refinement_blocks: int = 2,
                 heads: Sequence[int] = (1, 2, 4, 8), expansion: float = 2.66,
                 use_bias: bool = False, attention: bool = True, skip: bool = False):
        super().__init__()
        d, nb = dim, num_blocks
        self.skip = skip
        self.stages = {}

        def blocks(name, width, h, n):
            self.stages[name] = add_blocks(
                self, name, lambda i: TransformerBlock(width, h, expansion, use_bias), n)

        self.coefficient = nn.Parameter(torch.empty(4, 2, d * 8))
        self.patch_embed = Conv2d(inp_channels, d, 3, padding=1, bias=False)
        for name in ("encoder_1", "encoder_2", "encoder_3"):
            blocks(name, d, heads[0], nb[0])
        self.layer_fussion = LAMModuleV2(3 * d)
        self.conv_fuss = Conv2d(3 * d, d, 1, bias=use_bias)
        self.down_1 = Downsample(d)
        blocks("dec1_0", 2 * d, heads[1], nb[0])
        self.down_2 = Downsample(2 * d)
        blocks("dec2_0", 4 * d, heads[2], nb[1])
        self.down_3 = Downsample(4 * d)
        blocks("dec3_0", 8 * d, heads[3], nb[2])
        self.down_4 = Downsample(8 * d)
        blocks("dec4", 16 * d, heads[3], nb[3])
        self.up4_3 = Upsample(16 * d)
        self.coefficient_4_3 = nn.Parameter(torch.empty(2, 8 * d))
        self.skip_4_3 = Conv2d(8 * d, 8 * d, 1, bias=use_bias)
        blocks("dec3_1", 8 * d, heads[3], nb[2])
        self.up3_2 = Upsample(8 * d)
        self.coefficient_3_2 = nn.Parameter(torch.empty(2, 4 * d))
        self.skip_3_2 = Conv2d(4 * d, 4 * d, 1, bias=use_bias)
        blocks("dec2_1", 4 * d, heads[2], nb[1])
        self.up2_1 = Upsample(4 * d)
        self.skip_2_1_kernel = nn.Parameter(torch.empty(1, 1, 2 * d, 2 * d))
        self.coefficient_2_1 = nn.Parameter(torch.empty(2, 2 * d))
        self.skip_1_0 = Conv2d(2 * d, 2 * d, 1, bias=use_bias)
        blocks("dec1_1", 2 * d, heads[1], nb[0])
        self.up2_0 = Upsample(2 * d)
        blocks("latent", d, heads[0], nb[0])
        self.coefficient_1_0 = nn.Parameter(torch.empty(2, d))
        for name in ("ref1", "ref2", "ref3"):
            blocks(name, d, heads[0], num_refinement_blocks)
        self.layer_fussion_2 = LAMModuleV2(3 * d)
        self.conv_fuss_2 = Conv2d(3 * d, d, 1, bias=use_bias)
        self.output = Conv2d(d, out_channels, 3, padding=1, bias=use_bias)

    @torch.no_grad()
    def reset_parameters(self, gen):
        for p in self.parameters(recurse=False):
            p.fill_(1.0)
        self.skip_2_1_kernel.zero_()

    def _run(self, name, x):
        for blk in self.stages[name]:
            x = blk(x)
        return x

    def forward(self, inp_img):
        x = self.patch_embed(inp_img)
        e1 = self._run("encoder_1", x)
        e2 = self._run("encoder_2", e1)
        e3 = self._run("encoder_3", e2)
        fused = self.conv_fuss(self.layer_fussion([e1, e2, e3]))
        x10 = self._run("dec1_0", self.down_1(fused))
        x20 = self._run("dec2_0", self.down_2(x10))
        x30 = self._run("dec3_0", self.down_3(x20))
        x40 = self.up4_3(self._run("dec4", self.down_4(x30)))
        x31 = self._run("dec3_1", self.skip_4_3(_mix(self.coefficient_4_3, x30, x40)))
        x21 = self._run("dec2_1", self.skip_3_2(_mix(self.coefficient_3_2, x20, self.up3_2(x31))))
        x11 = self._run("dec1_1", self.skip_1_0(_mix(self.coefficient_2_1, x10, self.up2_1(x21))))
        out = _mix(self.coefficient_1_0, self._run("latent", fused), self.up2_0(x11))
        o1 = self._run("ref1", out)
        o2 = self._run("ref2", o1)
        o3 = self._run("ref3", o2)
        out = self.output(self.conv_fuss_2(self.layer_fussion_2([o1, o2, o3])))
        return out + inp_img if self.skip else out


def buildLLFormer(gen=None, device="cuda"):
    return seeded(LLFormer(inp_channels=3, out_channels=3, dim=16, num_blocks=(2, 4, 8, 16),
                           num_refinement_blocks=2, heads=(1, 2, 4, 8), expansion=2.66,
                           use_bias=False, attention=True, skip=False), gen, device)
