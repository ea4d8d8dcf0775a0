"""``Network``, the BEM condition-generator / image-enhancer U-Net, NCHW inside.

Counterpart of bem_tpu/archs/unet_arch.py (BasicBlock, SubNetwork,
Network) in its serving form: pixel-shuffle up/down sampling, gdMlp
VSSBlocks, and every VSSBlock on the hand-written kernels at every level.
With ``bayesian=True`` the VSSBlocks' convs and linears carry (mu, rho)
pairs while first_conv / proj / the U-Net seams stay deterministic, the
module set bem_tpu converts. The public forward takes and returns NHWC.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from ..nn import init
from ..nn.layers import Conv2d
from ..nn.vss import VSSBlock
from .arch_util import DualUpSample, PatchMerging, _kio, fold_dual_upsample


class BasicBlock(nn.Module):
    """num_blocks VSSBlocks (UNet_arch.py:179-242)."""

    def __init__(self, dim: int, num_blocks: int = 2, d_state: int = 1,
                 ssm_ratio: float = 1, mlp_ratio: float = 4,
                 bayesian: bool = False, sigma_init: float = 0.05):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"blocks_{i}", VSSBlock(
                dim, ssm_d_state=d_state, ssm_ratio=ssm_ratio, mlp_ratio=mlp_ratio,
                bayesian=bayesian, sigma_init=sigma_init))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"blocks_{i}")(x)
        return x


class SubNetwork(nn.Module):
    """Shallow U-Net of BasicBlocks with a residual output (UNet_arch.py:245-361)."""

    def __init__(self, dim: int, num_blocks: Sequence[int] = (2, 2, 2),
                 d_state: Union[int, Sequence[int]] = 1, ssm_ratio: float = 1,
                 mlp_ratio: float = 4, bayesian: bool = False,
                 sigma_init: float = 0.05):
        super().__init__()
        self.level = level = len(num_blocks) - 1
        if isinstance(d_state, int):
            d_state = [d_state] * len(num_blocks)
        common = dict(ssm_ratio=ssm_ratio, mlp_ratio=mlp_ratio, bayesian=bayesian,
                      sigma_init=sigma_init)
        curr = dim
        for i in range(level):
            self.add_module(f"enc_{i}", BasicBlock(curr, num_blocks[i], d_state[i], **common))
            self.add_module(f"down_{i}", PatchMerging(curr))
            curr *= 2
        self.bottleneck = BasicBlock(curr, num_blocks[-1], d_state[level], **common)
        for i in range(level):
            self.add_module(f"up_{i}", DualUpSample(curr))
            self.add_module(f"fusion_{i}", Conv2d(curr, curr // 2, 1, bias=False))
            self.add_module(f"dec_{i}", BasicBlock(
                curr // 2, num_blocks[level - 1 - i], d_state[level - 1 - i], **common))
            curr //= 2

    def forward(self, x):
        fea = x
        skips = []
        for i in range(self.level):
            fea = getattr(self, f"enc_{i}")(fea)
            skips.append(fea)
            fea = getattr(self, f"down_{i}")(fea)
        fea = self.bottleneck(fea)
        for i in range(self.level):
            skip = skips[self.level - 1 - i]
            up, fusion = getattr(self, f"up_{i}"), getattr(self, f"fusion_{i}")
            if fold_dual_upsample(fea.dtype):
                # the fusion conv's two halves fold into DualUpSample's
                # quarter-res tail and a skip-side 1x1 (unet_arch.py:177-193)
                kf = _kio(fusion)
                half = kf.shape[0] // 2
                fea = up(fea, fold_tail=kf[:half]) + torch.einsum(
                    "bchw,cd->bdhw", skip, kf[half:].to(fea.dtype))
            else:
                fea = fusion(torch.cat([up(fea), skip], dim=1))
            fea = getattr(self, f"dec_{i}")(fea)
        return x + fea


class Network(nn.Module):
    """Stage-I (CG) / Stage-II (IE) U-Net (UNet_arch.py:364-474).

    forward(x NHWC) -> [x, out NHWC], like the reference's out_list.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, n_feat: int = 40,
                 stage: int = 1, num_blocks: Sequence[int] = (1, 1, 1),
                 d_state: Union[int, Sequence[int]] = 1, ssm_ratio: float = 1,
                 mlp_ratio: float = 4, mlp_type: str = "gdmlp",
                 use_pixelshuffle: bool = True, bayesian: bool = False,
                 sigma_init: float = 0.05, last_act=None, drop_path: float = 0.0,
                 sam: bool = False):
        super().__init__()
        if (mlp_type != "gdmlp" or not use_pixelshuffle or last_act is not None
                or drop_path or sam):
            raise NotImplementedError(
                "Network port: mlp_type='gdmlp', use_pixelshuffle=True, no last_act, "
                "drop_path=0, sam=False")
        self.stage = stage
        self.first_conv = Conv2d(in_channels, n_feat, 3, padding=1,
                                 weight_init="kaiming_normal_fan_out", zero_bias=True)
        self.mask_token = nn.Parameter(torch.empty(1, n_feat, 1, 1))
        for i in range(stage):
            self.add_module(f"subnets_{i}", SubNetwork(
                n_feat, num_blocks, d_state, ssm_ratio, mlp_ratio, bayesian, sigma_init))
        self.proj = Conv2d(n_feat, out_channels, 3, padding=1, zero_bias=True)

    def reset_parameters(self, gen):
        init.trunc_normal_(self.mask_token, std=0.02, gen=gen)

    def forward(self, x):
        """x (B, H, W, in_channels). ``mask_token`` (the training-time MIM
        masking of the reference) is carried for checkpoint parity only."""
        fea = self.first_conv(x.permute(0, 3, 1, 2).contiguous())
        outs = [x]
        for i in range(self.stage):
            fea = getattr(self, f"subnets_{i}")(fea)
            outs.append(self.proj(fea).permute(0, 2, 3, 1))
        return outs
