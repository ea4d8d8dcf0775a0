"""UVM-Net baseline (counterpart of bem_tpu/analysis/model_zoo/uvmnet.py).

``Mamba1D`` follows mamba_ssm's documented layout (as bem_tpu does; the
reference needs that CUDA package): its scan is the port's
``ops.scan.selective_scan``, whose recurrence is ``linear_scan`` (row 7,
``csrc/scan.cu``, on the card). ``conv1d_weight`` stays in bem_tpu's HIO
(d_conv, 1, d_inner) layout."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import init
from ...nn.layers import Conv2d
from ...ops.scan import selective_scan
from .common import BatchNormInference, LayerNormLast, Linear, resize_bilinear_torch, seeded


class Mamba1D(nn.Module):
    """mamba_ssm.Mamba lookalike on (B, L, d_model) (uvmnet.py:23-63)."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2):
        super().__init__()
        self.d_inner = d_inner = expand * d_model
        self.R = R = math.ceil(d_model / 16)
        self.N, self.d_conv = d_state, d_conv
        self.in_proj = Linear(d_model, 2 * d_inner, bias=False)
        self.conv1d_weight = nn.Parameter(torch.empty(d_conv, 1, d_inner))
        self.conv1d_bias = nn.Parameter(torch.empty(d_inner))
        self.x_proj = Linear(d_inner, R + 2 * d_state, bias=False)
        self.dt_proj = Linear(R, d_inner, bias=True)
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.D = nn.Parameter(torch.empty(d_inner))
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def reset_parameters(self, gen):
        fan_in, _ = init.jax_fans(tuple(self.conv1d_weight.shape))
        init.torch_default_(self.conv1d_weight, fan_in, gen)
        init.torch_default_(self.conv1d_bias, self.d_conv, gen)
        init.a_log_(self.A_log)
        with torch.no_grad():
            self.D.fill_(1.0)

    def forward(self, x):
        R, N = self.R, self.N
        xs, z = self.in_proj(x).chunk(2, -1)
        # causal depthwise conv over L: d_conv - 1 zeros in front
        w = self.conv1d_weight.permute(2, 1, 0).to(xs.dtype)             # (d_inner, 1, d_conv)
        xc = F.conv1d(F.pad(xs.transpose(1, 2), (self.d_conv - 1, 0)), w,
                      self.conv1d_bias.to(xs.dtype), groups=self.d_inner)
        xc = F.silu(xc.transpose(1, 2))
        x_dbl = self.x_proj(xc)
        dt = self.dt_proj(x_dbl[..., :R])
        # one B / C group shared by all d_inner channels
        y = selective_scan(xc, dt, -torch.exp(self.A_log.float()), x_dbl[..., None, R:R + N],
                           x_dbl[..., None, R + N:], D=self.D, delta_softplus=True)
        return self.out_proj(y.to(x.dtype) * F.silu(z))


class UVMB(nn.Module):
    """Conv stem, then pixel-sequence and channel-sequence Mamba mixing at
    a fixed w x h working size (uvmnet.py:66-89)."""

    def __init__(self, c: int = 3, w: int = 64, h: int = 64):
        super().__init__()
        self.c, self.w, self.h = c, w, h
        self.convb1 = Conv2d(c, 16, 3, padding=1)
        self.convb2 = Conv2d(16, c, 3, padding=1)
        self.ln = LayerNormLast(c, channels_last=True)
        self.model1 = Mamba1D(c)
        self.model3 = Mamba1D(w * h)
        self.model2 = Mamba1D(c)
        self.smooth = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        b = x.shape[0]
        x = self.convb2(F.relu(self.convb1(x))) + x
        seq = self.ln(x.permute(0, 2, 3, 1).reshape(b, -1, self.c))       # (B, WH, C)
        z = self.model3(self.model1(seq).transpose(1, 2)).transpose(1, 2)  # channel-seq mix
        att = self.model2(seq).softmax(-1)
        out = (att * z).reshape(b, self.h, self.w, self.c).permute(0, 3, 1, 2)
        return self.smooth(out)


class DoubleConv(nn.Module):
    """UVMB at 64x64, then two conv + BatchNorm (inference) + ReLU
    (uvmnet.py:92-115)."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int = 0):
        super().__init__()
        mid = mid_channels or out_channels
        self.ub = UVMB(c=in_channels)
        self.conv1 = Conv2d(in_channels, mid, 3, padding=1, bias=False)
        self.bn1 = BatchNormInference(mid)
        self.conv2 = Conv2d(mid, out_channels, 3, padding=1, bias=False)
        self.bn2 = BatchNormInference(out_channels)

    def forward(self, x):
        h, w = x.shape[2:]
        out = self.ub(resize_bilinear_torch(x, (64, 64), align_corners=True))
        out = resize_bilinear_torch(out, (h, w), align_corners=True) + x
        out = F.relu(self.bn1(self.conv1(out)))
        return F.relu(self.bn2(self.conv2(out)))


class UVMNetUNet(nn.Module):
    """The bilinear U-Net with UVMB-augmented DoubleConvs (uvmnet.py:118-145)."""

    LEVELS = (("down1", 64, 128), ("down2", 128, 256), ("down3", 256, 512),
              ("down4", 512, 512))
    UPS = (("up1", 1024, 256), ("up2", 512, 128), ("up3", 256, 64), ("up4", 128, 64))

    def __init__(self, n_channels: int = 3):
        super().__init__()
        self.inc = DoubleConv(n_channels, 64)
        for name, cin, cout in self.LEVELS:
            self.add_module(name, DoubleConv(cin, cout))
        for name, cin, cout in self.UPS:
            self.add_module(name, DoubleConv(cin, cout, cin // 2))
        self.outc = Conv2d(64, 3, 1)

    def forward(self, inp):
        xs = [self.inc(inp)]
        for name, _, _ in self.LEVELS:
            xs.append(getattr(self, name)(F.max_pool2d(xs[-1], 2)))
        x = xs.pop()
        for name, _, _ in self.UPS:
            x2 = xs.pop()
            x1 = resize_bilinear_torch(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=True)
            dh, dw = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
            x = getattr(self, name)(torch.cat([x2, x1], 1))
        return self.outc(x) + inp


def buildUVMNet(gen=None, device="cuda"):
    return seeded(UVMNetUNet(n_channels=3), gen, device)
