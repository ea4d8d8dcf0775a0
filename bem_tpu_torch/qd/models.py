"""QD quaternion Retinex decomposition networks (model1..model4), NCHW.

Counterpart of bem_tpu/qd/models.py; one module parameterized by
``model_type`` covers the four variants:

- model1: conv branches + symmetric C x C cross-attention;
- model2: dilated second branch convs (the raw ``conv1_weight`` /
  ``conv1_bias``, flax's ``conv1_kernel`` / ``conv1_bias``), attention
  projections kaiming-normal;
- model3: a mini U-Net (stride-2 conv, mid conv, transposed-conv up with
  skip) before the branches. Its attention dropout (0.1) acts only under
  a dropout rng, which no path of bem_tpu passes (its QD training
  included): no forward applies it;
- model4: model1 + a residual depthwise PostSmooth of Q1 / Q2 after the IWT.

``forward(img)`` -> (Q1, Q2), each (B, 4, H, W); ``wavelet_features(img)``
-> (Q1_w, Q2_w), each (B, 16, H/2, W/2), the stop-before-IWT forward of
the wavelet Decomp arch. A module built with ``smooth=False`` declares no
PostSmooth, as bem_tpu's wavelet arch never calls (so never creates) it.
Parameter names are the flax tree's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import init
from ..nn.layers import Conv2d, ConvTranspose2d
from ..ops.quaternion import rgb_to_quaternions
from ..ops.wavelet import dwt2, iwt2

# wavelet-domain de-interleave: 4 subbands x 8 interleaved (Q1, Q2) components
Q1_W_INDICES = tuple(s * 8 + c for s in range(4) for c in (0, 2, 4, 6))
Q2_W_INDICES = tuple(s * 8 + c for s in range(4) for c in (1, 3, 5, 7))


class SymmetricCrossAttention(nn.Module):
    """Channel-wise C x C cross attention, both directions."""

    def __init__(self, dim: int, heads: int = 1, kaiming_proj: bool = False):
        super().__init__()
        self.heads = heads
        kw = (dict(weight_init="kaiming_normal_fan_in", zero_bias=True) if kaiming_proj
              else {})
        for name in ("q1_proj", "k2_proj", "v2_proj", "q2_proj", "k1_proj", "v1_proj",
                     "out1", "out2"):
            self.add_module(name, Conv2d(dim, dim, 1, **kw))

    def forward(self, q1_feat, q2_feat):
        B, C, H, W = q1_feat.shape
        hd = C // self.heads
        scale = hd ** -0.5

        def heads_first(t):  # (B, C, H, W) -> (B, heads, hd, L)
            return t.reshape(B, self.heads, hd, H * W)

        def attend(q, k, v):
            return torch.softmax((q * scale) @ k.transpose(-1, -2), dim=-1) @ v

        q1, k2, v2 = (heads_first(getattr(self, n)(t)) for n, t in
                      (("q1_proj", q1_feat), ("k2_proj", q2_feat), ("v2_proj", q2_feat)))
        q2, k1, v1 = (heads_first(getattr(self, n)(t)) for n, t in
                      (("q2_proj", q2_feat), ("k1_proj", q1_feat), ("v1_proj", q1_feat)))
        cross1 = attend(q1, k2, v2).reshape(B, C, H, W)
        cross2 = attend(q2, k1, v1).reshape(B, C, H, W)
        return self.out1(cross1) + q1_feat, self.out2(cross2) + q2_feat


class _Branch(nn.Module):
    """conv-relu-conv refinement branch; model2 dilates the second conv."""

    def __init__(self, nf: int, dilated: bool = False):
        super().__init__()
        self.dilated = dilated
        self.conv0 = Conv2d(nf, nf, 3, padding=1)
        if dilated:
            self.conv1_weight = nn.Parameter(torch.empty(nf, nf, 3, 3))
            self.conv1_bias = nn.Parameter(torch.empty(nf))
        else:
            self.conv1 = Conv2d(nf, nf, 3, padding=1)

    def reset_parameters(self, gen):
        if self.dilated:
            fan_in = self.conv1_weight.shape[1] * 9
            init.torch_default_(self.conv1_weight, fan_in, gen)
            init.torch_default_(self.conv1_bias, fan_in, gen)

    def forward(self, x):
        x = F.relu(self.conv0(x))
        if self.dilated:
            return F.conv2d(x, self.conv1_weight.to(x.dtype), self.conv1_bias.to(x.dtype),
                            padding=2, dilation=2)
        return self.conv1(x)


class PostSmooth(nn.Module):
    """x + relu(depthwise 3x3 of x)."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__()
        self.conv = Conv2d(channels, channels, kernel_size, padding=kernel_size // 2,
                           groups=channels)

    def forward(self, x):
        return x + F.relu(self.conv(x))


class Decomp(nn.Module):
    """The QD decomposition: 32 filters over the Haar subbands of the 8-channel
    quaternion encoding (bem_tpu's defaults, the shipped checkpoints')."""

    def __init__(self, model_type: str = "model4", smooth: bool = True):
        super().__init__()
        if model_type not in ("model1", "model2", "model3", "model4"):
            raise ValueError(f"Decomp: unknown model_type {model_type!r}")
        self.model_type = model_type
        nf, cin, out_ch = 32, 4 * 8, 4 * 8  # the 8 channels' 4 subbands
        self.conv_in = Conv2d(cin, nf, 3, padding=1)
        if model_type == "model3":
            self.down_conv = Conv2d(nf, nf, 3, padding=1, stride=2)
            self.mid_conv = Conv2d(nf, nf, 3, padding=1)
            self.up_conv = ConvTranspose2d(nf, nf, 2)
        self.branch_q1 = _Branch(nf, model_type == "model2")
        self.branch_q2 = _Branch(nf, model_type == "model2")
        self.cross_attn = SymmetricCrossAttention(nf, kaiming_proj=model_type == "model2")
        self.fuse = Conv2d(2 * nf, nf, 1)
        self.conv_out = Conv2d(nf, out_ch, 3, padding=1)
        self.sharpening = Conv2d(out_ch, out_ch, 3, padding=1, weight_init="laplacian",
                                 zero_bias=True)
        self.smooth = smooth and model_type == "model4"
        if self.smooth:
            self.smooth_q1 = PostSmooth(4, 3)
            self.smooth_q2 = PostSmooth(4, 3)

    def _trunk(self, x):
        """The path between the quaternion encoding's DWT and the IWT."""
        feat = self.conv_in(x)
        if self.model_type == "model3":
            mid = F.relu(self.mid_conv(F.relu(self.down_conv(feat))))
            feat = feat + self.up_conv(mid)
        q1, q2 = self.cross_attn(self.branch_q1(feat) + feat, self.branch_q2(feat) + feat)
        out = self.conv_out(self.fuse(torch.cat([q1, q2], dim=1)))
        return out + self.sharpening(out)

    def forward(self, img):
        """RGB (B, 3, H, W) -> (Q1, Q2), each (B, 4, H, W)."""
        out = iwt2(self._trunk(dwt2(rgb_to_quaternions(img))))
        q1, q2 = out[:, 0::2], out[:, 1::2]
        if self.smooth:
            q1, q2 = self.smooth_q1(q1), self.smooth_q2(q2)
        return q1, q2

    def wavelet_features(self, img):
        """RGB (B, 3, H, W) -> (Q1_w, Q2_w), each (B, 16, H/2, W/2): no IWT,
        no PostSmooth."""
        out = self._trunk(dwt2(rgb_to_quaternions(img)))
        return out[:, list(Q1_W_INDICES)], out[:, list(Q2_W_INDICES)]
