"""The Decomp family, the BEM flagship archs, NCHW inside: counterpart of
bem_tpu/archs/decomp_archs.py.

Every arch embeds a frozen QD decomposition (``decomp``, a
``qd.models.Decomp``): its outputs carry no gradient, ``load_frozen``
copies the shipped checkpoint into it (the trainers call it when they
build the net, as bem_tpu's ``init_state`` does), and the optimizer skips
the ``frozen_subtrees``. The U-Nets are one plain shape: 3x3 stem ->
[VSSBlocks -> 4x4/s2 conv down] x L -> bottleneck VSSBlocks -> [2x2/s2
transposed conv up -> 1x1 skip fuse -> VSSBlocks] x L -> 3x3 proj. The
VSSBlocks are the port's folded gdMlp / ``v05_noz`` form on the
hand-written kernels (bem_tpu runs them channels-last; the function is
the same). As in bem_tpu, ``use_pixelshuffle``, ``stage``,
``drop_path``, ``use_illu`` and ``sam`` are accepted and ignored, and so
is the forward's MIM ``mask`` (bem_tpu's Decomp archs declare no mask
token: a flagship step with ``mim`` on trains on the unmasked input). The
public forward takes NHWC (B, H, W, in_channels) and returns [x (the
image alone for DecompDualBranch2), the enhanced NHWC image].
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..convert import flax_to_state_dict
from ..nn.layers import Conv2d, ConvTranspose2d
from ..nn.vss import VSSBlock
from ..ops.quaternion import hamilton_product
from ..ops.wavelet import iwt2
from ..qd import Decomp, load_decomp_params
from .arch_util import CrossFusionBlock, SEBlock, SpatialAttention


def _d_state_list(d_state, n):
    return [d_state] * n if isinstance(d_state, int) else list(d_state)


def _last_act(out, last_act):
    if last_act == "relu":
        return F.relu(out)
    if last_act == "softmax":
        return torch.softmax(out, dim=1)
    return out


class VSSLevel(nn.Module):
    """num_blocks VSSBlocks at one scale (children ``block_{i}``)."""

    def __init__(self, dim: int, num_blocks: int, d_state: int = 1, ssm_ratio: float = 1,
                 mlp_ratio: float = 4, mlp_type: str = "gdmlp", scan_backend=None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", VSSBlock(
                dim, ssm_d_state=d_state, ssm_ratio=ssm_ratio, mlp_ratio=mlp_ratio,
                forward_type="v05_noz", mlp_type=mlp_type, scan_backend=scan_backend))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x)
        return x


class _UNetParts:
    """The encoder / decoder plumbing the U-Nets share (a mixin of an
    ``nn.Module``). A branch's modules are ``first_conv<tag>``,
    ``enc<tag>_<i>``, ``down<tag>_<i>``, ``up<tag>_<i>``, ``fuse<tag>_<i>``,
    ``dec<tag>_<i>`` and ``proj<tag>``: tag "" for the plain U-Net, "_Q1" /
    "_Q2" for the dual branch, "" / "2" for DecompDualBranch."""

    def _setup_unet(self, n_feat=40, num_blocks=(2, 2, 2), d_state=1, ssm_ratio=1,
                    mlp_ratio=4, mlp_type="gdmlp", last_act=None, scan_backend=None):
        self.n_feat, self.num_blocks = n_feat, tuple(num_blocks)
        self.levels = len(self.num_blocks)
        self.d_state = _d_state_list(d_state, self.levels)
        self.last_act = last_act
        self.common = dict(ssm_ratio=ssm_ratio, mlp_ratio=mlp_ratio, mlp_type=mlp_type,
                           scan_backend=scan_backend)

    def _level(self, dim, i):
        return VSSLevel(dim, self.num_blocks[i], self.d_state[i], **self.common)

    def _add_encoder(self, in_ch, tag):
        """Declare one branch's encoder; returns the bottleneck width."""
        self.add_module(f"first_conv{tag}", Conv2d(
            in_ch, self.n_feat, 3, padding=1, weight_init="kaiming_normal_fan_out",
            zero_bias=True))
        dim = self.n_feat
        for i in range(self.levels - 1):
            self.add_module(f"enc{tag}_{i}", self._level(dim, i))
            self.add_module(f"down{tag}_{i}", Conv2d(dim, 2 * dim, 4, padding=1, stride=2,
                                                     bias=False))
            dim *= 2
        return dim

    def _add_decoder(self, dim, out_ch, tag):
        for i in range(self.levels - 1):
            self.add_module(f"up{tag}_{i}", ConvTranspose2d(dim, dim // 2))
            self.add_module(f"fuse{tag}_{i}", Conv2d(dim, dim // 2, 1, bias=False))
            self.add_module(f"dec{tag}_{i}", self._level(dim // 2, self.levels - 2 - i))
            dim //= 2
        self.add_module(f"proj{tag}", Conv2d(self.n_feat, out_ch, 3, padding=1, zero_bias=True))

    def _encode(self, x, tag):
        fea = getattr(self, f"first_conv{tag}")(x)
        skips = []
        for i in range(self.levels - 1):
            fea = getattr(self, f"enc{tag}_{i}")(fea)
            skips.append(fea)
            fea = getattr(self, f"down{tag}_{i}")(fea)
        return fea, skips

    def _decode(self, fea, skips, tag):
        for i in range(self.levels - 1):
            fea = getattr(self, f"up{tag}_{i}")(fea)
            fea = getattr(self, f"fuse{tag}_{i}")(torch.cat([fea, skips[-1 - i]], dim=1))
            fea = getattr(self, f"dec{tag}_{i}")(fea)
        return _last_act(getattr(self, f"proj{tag}")(fea), self.last_act)


class PlainVSSUNet(_UNetParts, nn.Module):
    """first_conv -> enc / down -> bottleneck -> up / fuse / dec -> proj."""

    def __init__(self, in_channels: int, out_channels: int, **unet):
        super().__init__()
        self._setup_unet(**unet)
        dim = self._add_encoder(in_channels, "")
        self.bottleneck = self._level(dim, -1)
        self._add_decoder(dim, out_channels, "")

    def forward(self, x):
        fea, skips = self._encode(x, "")
        return self._decode(self.bottleneck(fea), skips, "")


class _DualBranchUNet(_UNetParts, nn.Module):
    """Two encoder / decoder branches (Q1, Q2) around one fused bottleneck."""

    def __init__(self, in_channels: int, out_channels: int, **unet):
        super().__init__()
        self._setup_unet(**unet)
        for tag in ("_Q1", "_Q2"):
            dim = self._add_encoder(in_channels, tag)
        self.bottleneck_fuse = Conv2d(2 * dim, dim, 1, bias=False)
        self.bottleneck = self._level(dim, -1)
        self.bottleneck_to_Q1 = Conv2d(dim, dim, 1, bias=False)
        self.bottleneck_to_Q2 = Conv2d(dim, dim, 1, bias=False)
        for tag in ("_Q1", "_Q2"):
            self._add_decoder(dim, out_channels, tag)

    def forward(self, q1, q2):
        f1, skips1 = self._encode(q1, "_Q1")
        f2, skips2 = self._encode(q2, "_Q2")
        fused = self.bottleneck(self.bottleneck_fuse(torch.cat([f1, f2], dim=1)))
        return (self._decode(self.bottleneck_to_Q1(fused), skips1, "_Q1"),
                self._decode(self.bottleneck_to_Q2(fused), skips2, "_Q2"))


class _DecompArchBase(nn.Module):
    """The family's options and its frozen decomposition."""

    post_smooth = True  # whether model4's decomposition declares its PostSmooth

    def __init__(self, in_channels: int = 6, out_channels: int = 3, n_feat: int = 40,
                 stage: int = 1, num_blocks: Sequence[int] = (2, 2, 2),
                 d_state: Union[int, Sequence[int]] = 1, ssm_ratio: float = 1,
                 mlp_ratio: float = 4, mlp_type: str = "gdmlp", use_pixelshuffle: bool = False,
                 drop_path: float = 0.0, use_illu: bool = False, sam: bool = False,
                 last_act: Optional[str] = None, decomp_model: str = "model1",
                 scan_backend=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.decomp_model = decomp_model
        self.decomp = Decomp(decomp_model, smooth=self.post_smooth)
        self.unet_kwargs = dict(n_feat=n_feat, num_blocks=num_blocks, d_state=d_state,
                                ssm_ratio=ssm_ratio, mlp_ratio=mlp_ratio, mlp_type=mlp_type,
                                last_act=last_act, scan_backend=scan_backend)

    @torch.no_grad()
    def load_frozen(self):
        """Copy the shipped QD checkpoint into ``decomp``, in place: every
        parameter the module declared takes the checkpoint's value where the
        checkpoint has it (the wavelet arch declares no PostSmooth)."""
        loaded = flax_to_state_dict(load_decomp_params(self.decomp_model))
        for name, t in self.decomp.state_dict().items():
            if name in loaded:
                t.copy_(torch.tensor(loaded[name]))
        return self

    @staticmethod
    def frozen_subtrees():
        """Parameter-name prefixes the optimizer must not touch."""
        return ("decomp",)

    def _frozen(self, fn, *args):
        with torch.no_grad():
            return fn(*args)

    @staticmethod
    def _split(x):
        """NHWC input -> NCHW (image, condition) and the NCHW whole."""
        xc = x.permute(0, 3, 1, 2).contiguous()
        return xc[:, :3], xc[:, 3:6], xc

    @staticmethod
    def _final(o1, o2):
        return hamilton_product(o1, o2)[:, 1:].permute(0, 2, 3, 1)


class DecompSingleBranch(_DecompArchBase):
    """decomp(img) -> cat(Q1, Q2, cond) -> one U-Net -> 8 ch -> Q1 x Q2."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.unet = PlainVSSUNet(8 + self.in_channels - 3, 8, **self.unet_kwargs)

    def forward(self, x, mask=None):
        img, _, xc = self._split(x)
        q1, q2 = self._frozen(self.decomp, img)
        out = self.unet(torch.cat([q1, q2, xc[:, 3:]], dim=1))
        return [x, self._final(out[:, :4], out[:, 4:])]


class DecompSingleBranchDD(_DecompArchBase):
    """decomp(img) + decomp(cond) -> 16 ch -> one U-Net -> 8 ch -> Q1 x Q2."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.unet = PlainVSSUNet(16, 8, **self.unet_kwargs)

    def forward(self, x, mask=None):
        img, cond, _ = self._split(x)
        q1i, q2i = self._frozen(self.decomp, img)
        q1c, q2c = self._frozen(self.decomp, cond)
        out = self.unet(torch.cat([q1i, q2i, q1c, q2c], dim=1))
        return [x, self._final(out[:, :4], out[:, 4:])]


class DecompDualBranch2(_DecompArchBase):
    """cond zero-padded to 4 ch and added to Q1 and Q2; two branches around a
    shared bottleneck."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.branches = _DualBranchUNet(4, 4, **self.unet_kwargs)

    def forward(self, x, mask=None):
        img, cond, _ = self._split(x)
        q1, q2 = self._frozen(self.decomp, img)
        cond_q = torch.cat([cond, torch.zeros_like(cond[:, :1])], dim=1)
        o1, o2 = self.branches(q1 + cond_q, q2 + cond_q)
        return [x[..., :3], self._final(o1, o2)]


class DecompDualBranch2DD(_DecompArchBase):
    """decomp of the image and of the condition; each branch takes
    cat(Q_img, Q_cond), 8 ch."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.branches = _DualBranchUNet(8, 4, **self.unet_kwargs)

    def forward(self, x, mask=None):
        img, cond, _ = self._split(x)
        q1i, q2i = self._frozen(self.decomp, img)
        q1c, q2c = self._frozen(self.decomp, cond)
        o1, o2 = self.branches(torch.cat([q1i, q1c], dim=1), torch.cat([q2i, q2c], dim=1))
        return [x, self._final(o1, o2)]


class DecompDualBranchDDWavelet(_DecompArchBase):
    """The flagship: the wavelet-domain dual branch. The decomposition stops
    before its IWT; the branches run at H/2 x W/2 on 32-channel inputs; an
    IWT after each decoder, the Hamilton product in pixel space."""

    post_smooth = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.branches = _DualBranchUNet(32, 16, **self.unet_kwargs)

    def forward(self, x, mask=None):
        img, cond, _ = self._split(x)
        q1i, q2i = self._frozen(self.decomp.wavelet_features, img)
        q1c, q2c = self._frozen(self.decomp.wavelet_features, cond)
        o1, o2 = self.branches(torch.cat([q1i, q1c], dim=1), torch.cat([q2i, q2c], dim=1))
        return [x, self._final(iwt2(o1), iwt2(o2))]


class DecompDualBranch(_UNetParts, _DecompArchBase):
    """Two U-Nets over Q1 / Q2 with one cross-fusion exchange at the deepest
    encoder level and SE / spatial attention after each bottleneck."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._setup_unet(**dict(self.unet_kwargs, last_act=None))
        for tag in ("", "2"):
            dim = self._add_encoder(4, tag)
        self.cross_fusion_12 = CrossFusionBlock(dim)
        self.cross_fusion_21 = CrossFusionBlock(dim)
        for tag in ("", "2"):
            self.add_module(f"bottleneck{tag}", self._level(dim, -1))
            self.add_module(f"bottleneck_se{tag}", SEBlock(dim))
            self.add_module(f"spatial_attention{tag}", SpatialAttention())
        for tag in ("", "2"):
            self._add_decoder(dim, 4, tag)

    def forward(self, x, mask=None):
        img, _, _ = self._split(x)
        q1, q2 = self._frozen(self.decomp, img)
        f1, skips1 = self._encode(q1, "")
        f2, skips2 = self._encode(q2, "2")
        f2 = self.cross_fusion_12(f1, f2)
        f1 = self.cross_fusion_21(f2, f1)
        f1 = self.spatial_attention(self.bottleneck_se(self.bottleneck(f1)))
        f2 = self.spatial_attention2(self.bottleneck_se2(self.bottleneck2(f2)))
        return [x, self._final(self._decode(f1, skips1, ""), self._decode(f2, skips2, "2"))]


DECOMP_ARCHS = {cls.__name__: cls for cls in (
    DecompSingleBranch, DecompSingleBranchDD, DecompDualBranch, DecompDualBranch2,
    DecompDualBranch2DD, DecompDualBranchDDWavelet)}
