"""VSSM, the VMamba image classifier.

Counterpart of bem_tpu/nn/vssm.py (reference vmamba.py:1380-1702): patch
embedding v1 / v2, the stages of VSSBlocks with linearly growing drop-path,
downsampling v1 (PatchMerging2D) / v2 / v3 / none, and the classifier (LN,
the spatial mean, ``head``). The input is bem_tpu's NHWC image batch; the
interior runs channel-first (B, C, H, W). Parameter names follow the flax
tree (``patch_embed_1``, ``layer{i}_block{d}``, ``downsample_{i}``, ...),
so :func:`bem_tpu_torch.convert.load_flax_params` maps it mechanically.
``posembed`` adds a learned (1, C, imgsize / patch, imgsize / patch)
``pos_embed`` after the patch embedding; :class:`BackboneVSSM` is the
feature pyramid (vssm.py:165-177).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import init
from .layers import Conv2d, Dense, LayerNorm2d
from .vss import VSSBlock


class PatchMerging2D(nn.Module):
    """2x2 space-to-channel + LN + linear reduction (vssm.py:31-49)."""

    def __init__(self, dim: int, out_dim: int = -1):
        super().__init__()
        self.norm = LayerNorm2d(4 * dim)
        self.reduction = Dense(4 * dim, out_dim if out_dim > 0 else 2 * dim, bias=False)

    def forward(self, x):
        H, W = x.shape[-2:]
        if H % 2 or W % 2:
            x = F.pad(x, (0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], 1)
        return self.reduction(self.norm(x))


class VSSM(nn.Module):
    """The VMamba classifier with bem_tpu VSSM's fields and defaults
    (vssm.py:52-162)."""

    def __init__(self, patch_size: int = 4, in_chans: int = 3, num_classes: int = 1000,
                 depths: Sequence[int] = (2, 2, 9, 2), dims=(96, 192, 384, 768),
                 ssm_d_state: int = 16, ssm_ratio: float = 2.0, ssm_dt_rank="auto",
                 ssm_conv: int = 3, ssm_conv_bias: bool = True, ssm_drop_rate: float = 0.0,
                 ssm_init: str = "v0", forward_type: str = "v05_noz", mlp_ratio: float = 4.0,
                 mlp_drop_rate: float = 0.0, gmlp: bool = False, drop_path_rate: float = 0.1,
                 patch_norm: bool = True, downsample_version: str = "v2",
                 patchembed_version: str = "v1", posembed: bool = False, imgsize: int = 224,
                 scan_backend=None):
        super().__init__()
        dims = [dims * 2 ** i for i in range(len(depths))] if isinstance(dims, int) else list(dims)
        self.patchembed_version, self.use_patch_norm = patchembed_version, patch_norm
        self.downsample_version = downsample_version
        self.depths = list(depths)
        if patchembed_version == "v1":
            self.patch_embed = Conv2d(in_chans, dims[0], patch_size, stride=patch_size)
            if patch_norm:
                self.patch_norm = LayerNorm2d(dims[0])
        elif patchembed_version == "v2":  # two stride-/2 convs with GELU
            stride = patch_size // 2
            k = stride + 1
            self.patch_embed_1 = Conv2d(in_chans, dims[0] // 2, k, padding=1, stride=stride)
            self.patch_embed_2 = Conv2d(dims[0] // 2, dims[0], k, padding=1, stride=stride)
            if patch_norm:
                self.patch_norm_1 = LayerNorm2d(dims[0] // 2)
                self.patch_norm_2 = LayerNorm2d(dims[0])
        else:
            raise ValueError(f"patchembed_version {patchembed_version!r}")
        if posembed and type(self) is VSSM:  # the backbone has none (vssm.py:165-177)
            ph = imgsize // patch_size
            self.pos_embed = nn.Parameter(torch.empty(1, dims[0], ph, ph))
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        blk = 0
        for i, depth in enumerate(depths):
            for d in range(depth):
                self.add_module(f"layer{i}_block{d}", VSSBlock(
                    dims[i], ssm_d_state=ssm_d_state, ssm_ratio=ssm_ratio,
                    mlp_ratio=mlp_ratio, drop_path=dpr[blk], ssm_dt_rank=ssm_dt_rank,
                    ssm_conv=ssm_conv, ssm_conv_bias=ssm_conv_bias, forward_type=forward_type,
                    mlp_type="gmlp" if gmlp else "mlp", ssm_drop_rate=ssm_drop_rate,
                    ssm_init=ssm_init, mlp_drop_rate=mlp_drop_rate, scan_backend=scan_backend))
                blk += 1
            if i < len(depths) - 1:
                self._add_downsample(i, dims[i], dims[i + 1])
        self._add_head(dims, num_classes)

    def _add_head(self, dims, num_classes):
        self.classifier_norm = LayerNorm2d(dims[-1])
        self.head = Dense(dims[-1], num_classes, weight_init="trunc_normal")

    @torch.no_grad()
    def reset_parameters(self, gen):
        if hasattr(self, "pos_embed"):
            init.trunc_normal_(self.pos_embed, 0.02, gen=gen)

    def _add_downsample(self, i: int, dim: int, out_dim: int):
        v = self.downsample_version
        if v == "v1":
            self.add_module(f"downsample_{i}", PatchMerging2D(dim, out_dim))
        elif v in ("v2", "v3"):
            k, p = (2, 0) if v == "v2" else (3, 1)
            self.add_module(f"downsample_{i}", Conv2d(dim, out_dim, k, padding=p, stride=2))
            self.add_module(f"downsample_norm_{i}", LayerNorm2d(out_dim))
        elif v != "none":
            raise ValueError(f"downsample_version {v!r}")

    def _patch_embed(self, x):
        norm = self.use_patch_norm
        if self.patchembed_version == "v1":
            x = self.patch_embed(x)
            return self.patch_norm(x) if norm else x
        x = self.patch_embed_1(x)
        x = F.gelu(self.patch_norm_1(x) if norm else x)
        x = self.patch_embed_2(x)
        return self.patch_norm_2(x) if norm else x

    def _stages(self, x, gen=None, masks=None):
        """The stages on the embedded (B, C, H, W) map: each stage's output
        (before its downsample). ``masks``: per block name, its injected
        keep masks (VSSBlock.draw_masks)."""
        masks = masks or {}
        feats = []
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                name = f"layer{i}_block{d}"
                x = getattr(self, name)(x, gen, masks.get(name))
            feats.append(x)
            if i < len(self.depths) - 1 and self.downsample_version != "none":
                x = getattr(self, f"downsample_{i}")(x)
                if self.downsample_version != "v1":
                    x = getattr(self, f"downsample_norm_{i}")(x)
        return feats

    def forward(self, x, gen=None, masks=None):
        """x: images (B, H, W, in_chans) -> logits (B, num_classes) in x.dtype.
        ``gen`` turns drop-path and SSM dropout on (training); ``masks``
        injects blocks' keep masks (see :meth:`_stages`)."""
        x = self._patch_embed(x.permute(0, 3, 1, 2))
        if hasattr(self, "pos_embed"):
            x = x + self.pos_embed.to(x.dtype)
        x = self.classifier_norm(self._stages(x, gen, masks)[-1]).mean((2, 3))
        return self.head(x)


class BackboneVSSM(VSSM):
    """The feature pyramid (vssm.py:165-177): the stages of :class:`VSSM`,
    each stage of ``out_indices`` through its LayerNorm ``outnorm{i}``; no
    classifier and no position embedding, even with ``posembed``."""

    def __init__(self, out_indices: Sequence[int] = (0, 1, 2, 3), **kw):
        self.out_indices = tuple(out_indices)
        super().__init__(**kw)

    def _add_head(self, dims, num_classes):
        for i in self.out_indices:
            self.add_module(f"outnorm{i}", LayerNorm2d(dims[i]))

    def forward(self, x, gen=None, masks=None):
        """x: images (B, H, W, in_chans) -> the features of ``out_indices``,
        each (B, H_i, W_i, C_i) channels-last as bem_tpu returns them."""
        feats = self._stages(self._patch_embed(x.permute(0, 3, 1, 2)), gen, masks)
        return [getattr(self, f"outnorm{i}")(feats[i]).permute(0, 2, 3, 1)
                for i in self.out_indices]


def vmamba_tiny(**kw):
    return VSSM(depths=(2, 2, 5, 2), dims=96, ssm_d_state=1, ssm_ratio=2.0,
                ssm_conv_bias=False, forward_type="v05_noz", mlp_ratio=4.0,
                downsample_version="v3", patchembed_version="v2", **kw)


def vmamba_small(**kw):
    return VSSM(depths=(2, 2, 15, 2), dims=96, ssm_d_state=1, ssm_ratio=2.0,
                ssm_conv_bias=False, forward_type="v05_noz", mlp_ratio=4.0,
                downsample_version="v3", patchembed_version="v2", **kw)


def vmamba_base(**kw):
    return VSSM(depths=(2, 2, 15, 2), dims=128, ssm_d_state=1, ssm_ratio=2.0,
                ssm_conv_bias=False, forward_type="v05_noz", mlp_ratio=4.0,
                downsample_version="v3", patchembed_version="v2", **kw)
