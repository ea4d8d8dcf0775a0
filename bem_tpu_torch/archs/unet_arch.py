"""``Network``, the BEM condition-generator / image-enhancer U-Net, NCHW inside.

Counterpart of bem_tpu/archs/unet_arch.py (BasicBlock, SubNetwork,
Network) with all of its options: pixel-shuffle (PatchMerging /
DualUpSample) or conv (ConvDown / DeconvUp) down / up sampling, the four
MLP types, a SAM after each VSSBlock, drop-path on the SubNetwork's output
residual and the last activation. Every VSSBlock runs its SS2D on the
hand-written kernels at every level (rows 2, 3, 5, 6, 7; the gdMlp blocks
also rows 1 and 4, folded). bem_tpu runs the blocks of a ``sam`` or
non-gdMlp net channels-last; the port runs them channel-first, the same
math. With ``bayesian=True`` the VSSBlocks' convs and linears carry (mu,
rho) pairs while first_conv / proj / the U-Net seams / SAM stay
deterministic, the module set bem_tpu converts. The public forward takes
and returns NHWC.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from ..nn import init
from ..nn.layers import Conv2d, DropPath
from ..nn.vss import VSSBlock
from .arch_util import (SAM, ConvDown, DeconvUp, DualUpSample, PatchMerging, _kio,
                        fold_dual_upsample)


class BasicBlock(nn.Module):
    """num_blocks VSSBlocks, each followed by a SAM when ``sam``
    (UNet_arch.py:179-242). The VSSBlocks have no drop-path (unet_arch.py:81)."""

    def __init__(self, dim: int, num_blocks: int = 2, d_state: int = 1,
                 ssm_ratio: float = 1, mlp_ratio: float = 4, mlp_type: str = "gdmlp",
                 sam: bool = False, bayesian: bool = False, sigma_init: float = 0.05,
                 scan_backend=None):
        super().__init__()
        self.num_blocks, self.sam = num_blocks, sam
        for i in range(num_blocks):
            self.add_module(f"blocks_{i}", VSSBlock(
                dim, ssm_d_state=d_state, ssm_ratio=ssm_ratio, mlp_ratio=mlp_ratio,
                bayesian=bayesian, sigma_init=sigma_init, mlp_type=mlp_type,
                scan_backend=scan_backend))
            if sam:
                self.add_module(f"sam_blocks_{i}", SAM(dim))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"blocks_{i}")(x)
            if self.sam:
                x = getattr(self, f"sam_blocks_{i}")(x)
        return x


class SubNetwork(nn.Module):
    """Shallow U-Net of BasicBlocks with a residual output (UNet_arch.py:245-361)."""

    def __init__(self, dim: int, num_blocks: Sequence[int] = (2, 2, 2),
                 d_state: Union[int, Sequence[int]] = 1, ssm_ratio: float = 1,
                 mlp_ratio: float = 4, bayesian: bool = False,
                 sigma_init: float = 0.05, mlp_type: str = "gdmlp",
                 use_pixelshuffle: bool = False, drop_path: float = 0.0, sam: bool = False,
                 scan_backend=None):
        super().__init__()
        self.level = level = len(num_blocks) - 1
        self.use_pixelshuffle = use_pixelshuffle
        if isinstance(d_state, int):
            d_state = [d_state] * len(num_blocks)
        common = dict(ssm_ratio=ssm_ratio, mlp_ratio=mlp_ratio, mlp_type=mlp_type, sam=sam,
                      bayesian=bayesian, sigma_init=sigma_init, scan_backend=scan_backend)
        curr = dim
        for i in range(level):
            self.add_module(f"enc_{i}", BasicBlock(curr, num_blocks[i], d_state[i], **common))
            self.add_module(f"down_{i}", PatchMerging(curr) if use_pixelshuffle
                            else ConvDown(curr))
            curr *= 2
        self.bottleneck = BasicBlock(curr, num_blocks[-1], d_state[level], **common)
        for i in range(level):
            self.add_module(f"up_{i}", DualUpSample(curr) if use_pixelshuffle
                            else DeconvUp(curr))
            self.add_module(f"fusion_{i}", Conv2d(curr, curr // 2, 1, bias=False))
            self.add_module(f"dec_{i}", BasicBlock(
                curr // 2, num_blocks[level - 1 - i], d_state[level - 1 - i], **common))
            curr //= 2
        self.drop_path = DropPath(drop_path)

    def forward(self, x, drop_mask=None):
        """``drop_mask`` ((B,) bool, the images kept) turns the output
        residual's drop-path on; bem_tpu's trainers leave it off (they pass
        no "dropout" rng)."""
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
            if self.use_pixelshuffle and fold_dual_upsample(fea.dtype):
                # the fusion conv's two halves fold into DualUpSample's
                # quarter-res tail and a skip-side 1x1 (unet_arch.py:177-193)
                kf = _kio(fusion)
                half = kf.shape[0] // 2
                fea = up(fea, fold_tail=kf[:half]) + torch.einsum(
                    "bchw,cd->bdhw", skip, kf[half:].to(fea.dtype))
            else:
                fea = fusion(torch.cat([up(fea), skip], dim=1))
            fea = getattr(self, f"dec_{i}")(fea)
        return x + self.drop_path(fea, mask=drop_mask)


class Network(nn.Module):
    """Stage-I (CG) / Stage-II (IE) U-Net (UNet_arch.py:364-474).

    forward(x NHWC) -> [x, out NHWC], like the reference's out_list.
    ``last_act`` "relu" or "softmax" (over the channels) ends each stage;
    any other value adds nothing, and ``use_illu`` is read and ignored, as
    in bem_tpu. ``scan_backend`` "xla" / "ref" takes bem_tpu's unfused
    route in every VSSBlock (see :class:`~bem_tpu_torch.nn.vss.VSSBlock`).
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, n_feat: int = 40,
                 stage: int = 1, num_blocks: Sequence[int] = (1, 1, 1),
                 d_state: Union[int, Sequence[int]] = 1, ssm_ratio: float = 1,
                 mlp_ratio: float = 4, mlp_type: str = "gdmlp",
                 use_pixelshuffle: bool = False, bayesian: bool = False,
                 sigma_init: float = 0.05, last_act=None, drop_path: float = 0.0,
                 sam: bool = False, use_illu: bool = False, scan_backend=None):
        super().__init__()
        self.stage, self.last_act = stage, last_act
        self.scan_backend = scan_backend
        self.first_conv = Conv2d(in_channels, n_feat, 3, padding=1,
                                 weight_init="kaiming_normal_fan_out", zero_bias=True)
        self.mask_token = nn.Parameter(torch.empty(1, n_feat, 1, 1))
        for i in range(stage):
            self.add_module(f"subnets_{i}", SubNetwork(
                n_feat, num_blocks, d_state, ssm_ratio, mlp_ratio, bayesian, sigma_init,
                mlp_type, use_pixelshuffle, drop_path, sam, scan_backend))
        self.proj = Conv2d(n_feat, out_channels, 3, padding=1, zero_bias=True)

    def reset_parameters(self, gen):
        init.trunc_normal_(self.mask_token, std=0.02, gen=gen)

    def forward(self, x, mask=None, drop_mask=None):
        """x (B, H, W, in_channels). ``mask`` (B, H, W), the MIM mask of a
        training step: where it is 1 the first conv's features are replaced
        by ``mask_token`` (unet_arch.py:285-295). ``drop_mask`` turns the
        SubNetworks' drop-path on (see SubNetwork.forward)."""
        fea = self.first_conv(x.permute(0, 3, 1, 2).contiguous())
        if mask is not None:
            w = mask[:, None].to(fea.dtype)
            fea = fea * (1.0 - w) + self.mask_token.to(fea.dtype) * w
        outs = [x]
        for i in range(self.stage):
            fea = getattr(self, f"subnets_{i}")(fea, drop_mask)
            out = self.proj(fea).permute(0, 2, 3, 1)
            if self.last_act == "relu":
                out = torch.relu(out)
            elif self.last_act == "softmax":
                out = torch.softmax(out, dim=-1)
            outs.append(out)
        return outs
