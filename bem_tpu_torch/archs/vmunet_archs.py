"""The VMUNet family, NCHW inside: counterpart of
bem_tpu/archs/vmunet_archs.py.

- ``VMUNet``: one plain VSS U-Net.
- ``NaiveVMUNetTwoBranch``: two independent branches, outputs averaged.
- ``TunedModel``: two branches, SE and spatial attention after each
  bottleneck, a conv3x3 -> ReLU -> conv3x3 fusion of the two outputs.
- ``FusedTunedModel``: TunedModel with one bidirectional cross-fusion
  exchange at the deepest encoder level.

A branch is the ``_UNetParts`` plumbing with bem_tpu's module names
(``first_conv<tag>``, ``enc<tag>_<i>``, ``down<tag>_<i>``,
``bottleneck<tag>``, ``up<tag>_<i>``, ``fuse<tag>_<i>``, ``dec<tag>_<i>``,
``proj<tag>``; tag "" and "2"), so ``convert.py`` carries bem_tpu's params
over as they are. As in bem_tpu, ``use_pixelshuffle``, ``stage``,
``drop_path``, ``use_illu`` and ``sam`` are accepted and ignored, and so
is the forward's MIM ``mask``. The public forward takes NHWC
(B, H, W, in_channels) and returns [x, the NHWC output].
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv2d
from .arch_util import CrossFusionBlock, SEBlock, SpatialAttention
from .decomp_archs import _UNetParts


class _BranchNet(_UNetParts, nn.Module):
    """The options bem_tpu's ``_BranchCfg`` takes, and ``branches`` U-Net
    branches (tags "" and "2")."""

    branches = ("",)

    def __init__(self, in_channels: int = 3, out_channels: int = 3, n_feat: int = 40,
                 stage: int = 1, num_blocks: Sequence[int] = (2, 2, 2),
                 d_state: Union[int, Sequence[int]] = 1, ssm_ratio: float = 1,
                 mlp_ratio: float = 4, mlp_type: str = "gdmlp", use_pixelshuffle: bool = False,
                 drop_path: float = 0.0, use_illu: bool = False, sam: bool = False,
                 last_act: Optional[str] = None, scan_backend=None):
        super().__init__()
        self._setup_unet(n_feat=n_feat, num_blocks=num_blocks, d_state=d_state,
                         ssm_ratio=ssm_ratio, mlp_ratio=mlp_ratio, mlp_type=mlp_type,
                         last_act=last_act, scan_backend=scan_backend)
        self.out_channels = out_channels
        for tag in self.branches:
            self.dim = self._add_encoder(in_channels, tag)
        self._add_middle(self.dim)
        for tag in self.branches:
            self._add_decoder(self.dim, out_channels, tag)

    def _add_middle(self, dim):
        for tag in self.branches:
            self.add_module(f"bottleneck{tag}", self._level(dim, -1))

    def _branch(self, xc, tag):
        fea, skips = self._encode(xc, tag)
        return self._decode(getattr(self, f"bottleneck{tag}")(fea), skips, tag)


class _OutFusion(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 output fusion."""

    def __init__(self, out_channels: int):
        super().__init__()
        self.conv1 = Conv2d(2 * out_channels, out_channels, 3, padding=1)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class VMUNet(_BranchNet):
    def forward(self, x, mask=None):
        out = self._branch(x.permute(0, 3, 1, 2), "")
        return [x, out.permute(0, 2, 3, 1)]


class NaiveVMUNetTwoBranch(_BranchNet):
    """Two independent branches; outputs averaged."""

    branches = ("", "2")

    def forward(self, x, mask=None):
        xc = x.permute(0, 3, 1, 2)
        out = (self._branch(xc, "") + self._branch(xc, "2")) / 2.0
        return [x, out.permute(0, 2, 3, 1)]


class TunedModel(_BranchNet):
    """Two branches, SE and spatial attention after each bottleneck, conv
    output fusion."""

    branches = ("", "2")

    def _add_middle(self, dim):
        for tag in self.branches:
            self.add_module(f"bottleneck{tag}", self._level(dim, -1))
            self.add_module(f"bottleneck_se{tag}", SEBlock(dim))
            self.add_module(f"spatial_attention{tag}", SpatialAttention())
        self.fusion = _OutFusion(self.out_channels)

    def _middle(self, fea, tag):
        fea = getattr(self, f"bottleneck{tag}")(fea)
        fea = getattr(self, f"bottleneck_se{tag}")(fea)
        return getattr(self, f"spatial_attention{tag}")(fea)

    def forward(self, x, mask=None):
        xc = x.permute(0, 3, 1, 2)
        outs = []
        for tag in self.branches:
            fea, skips = self._encode(xc, tag)
            outs.append(self._decode(self._middle(fea, tag), skips, tag))
        return [x, self.fusion(torch.cat(outs, dim=1)).permute(0, 2, 3, 1)]


class FusedTunedModel(TunedModel):
    """TunedModel with a bidirectional cross-fusion at the deepest encoder
    level: ``cross_fusion_12`` updates branch 2 from branch 1 first, and
    ``cross_fusion_21`` updates branch 1 from the updated branch 2."""

    def _add_middle(self, dim):
        self.cross_fusion_12 = CrossFusionBlock(dim)
        self.cross_fusion_21 = CrossFusionBlock(dim)
        super()._add_middle(dim)

    def forward(self, x, mask=None):
        xc = x.permute(0, 3, 1, 2)
        f1, s1 = self._encode(xc, "")
        f2, s2 = self._encode(xc, "2")
        f2 = self.cross_fusion_12(f1, f2)
        f1 = self.cross_fusion_21(f2, f1)
        out1 = self._decode(self._middle(f1, ""), s1, "")
        out2 = self._decode(self._middle(f2, "2"), s2, "2")
        return [x, self.fusion(torch.cat([out1, out2], dim=1)).permute(0, 2, 3, 1)]


VMUNET_ARCHS = {cls.__name__: cls for cls in (
    VMUNet, NaiveVMUNetTwoBranch, TunedModel, FusedTunedModel)}
