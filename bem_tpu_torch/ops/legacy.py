"""BasicSR's legacy ops (counterpart of bem_tpu/ops/legacy.py), channel-first.

bem_tpu computes these in plain XLA (no Pallas kernel), so the port's are
plain PyTorch, with bem_tpu's math and argument order:

- ``fused_leaky_relu``: StyleGAN's leaky_relu(x + bias) * scale, the bias
  on the channel axis;
- ``upfirdn2d``: zero-insertion upsampling, the same ``(p0, p1)`` padding
  of both axes (a negative pad crops), a depthwise correlation with the
  flipped kernel, then subsampling;
- ``make_resample_kernel``: a 1-D kernel's outer product, normalized;
- ``modulated_deform_conv2d`` / ``deform_conv2d``: deformable convolution
  v2 / v1 as a bilinear gather and a matmul. Each output position's taps
  are sampled at the tap's grid point plus its offset; the offsets come
  as (dy, dx) pairs per tap and per deform group, and each of the four
  corners of a sample is zero outside [0, H - 1] x [0, W - 1].

Tensors are (B, C, H, W) where bem_tpu's are (B, H, W, C); offsets are
(B, 2 * groups * kh * kw, Ho, Wo) and masks (B, groups * kh * kw, Ho, Wo),
their channels in bem_tpu's last-axis order; the deform-conv weight is
(Cout, Cin, kh, kw), the HWIO kernel's torch layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = 2 ** 0.5) -> torch.Tensor:
    """leaky_relu(x + bias) * scale, ``bias`` (C,) on axis 1 (legacy.py:21)."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, negative_slope * x) * scale


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x (B, C, H, W), kernel (kh, kw) -> upsample, FIR, downsample
    (legacy.py:30)."""
    B, C, H, W = x.shape
    kh, kw = kernel.shape
    if up > 1:
        z = x.new_zeros((B, C, H, up, W, up))
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(B, C, H * up, W * up)
    p0, p1 = pad
    x = F.pad(x, (max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)))
    if p0 < 0 or p1 < 0:
        x = x[:, :, max(-p0, 0): x.shape[2] - max(-p1, 0),
              max(-p0, 0): x.shape[3] - max(-p1, 0)]
    k = torch.flip(kernel, (0, 1)).to(x.dtype)[None, None].expand(C, 1, kh, kw)
    x = F.conv2d(x, k, groups=C)
    if down > 1:
        x = x[:, :, ::down, ::down]
    return x


def make_resample_kernel(k) -> torch.Tensor:
    """A 1-D kernel -> its separable 2-D form, normalized to sum 1
    (legacy.py:56)."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.dim() == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def bilinear_gather(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) sampled at (ys, xs) (B, P) -> (B, C, P); each corner
    outside [0, H - 1] x [0, W - 1] counts as zero (legacy.py:64)."""
    B, C, H, W = x.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[:, None].to(x.dtype), (xs - x0)[:, None].to(x.dtype)
    flat = x.reshape(B, C, H * W)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        idx = (yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long())
        v = torch.gather(flat, 2, idx[:, None].expand(B, C, idx.shape[1]))
        return v * valid[:, None].to(x.dtype)

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    return ((1 - wy) * (1 - wx) * v00 + (1 - wy) * wx * v01
            + wy * (1 - wx) * v10 + wy * wx * v11)


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                            mask: Optional[torch.Tensor], weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, stride: int = 1,
                            padding: int = 1, dilation: int = 1,
                            deform_groups: int = 1) -> torch.Tensor:
    """Deformable conv v2 (legacy.py:89): x (B, Cin, H, W); offset (B,
    2 * G * kh * kw, Ho, Wo); mask (B, G * kh * kw, Ho, Wo) or None (v1);
    weight (Cout, Cin, kh, kw); bias (Cout,). Returns (B, Cout, Ho, Wo)."""
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    Ho = (H + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    K, G = kh * kw, deform_groups
    dev = x.device
    base_y = torch.arange(Ho, device=dev) * stride - padding
    base_x = torch.arange(Wo, device=dev) * stride - padding
    ky = torch.arange(kh, device=dev) * dilation
    kx = torch.arange(kw, device=dev) * dilation
    # the (kh, kw, Ho, Wo) sample grid, taps first
    gy = (ky[:, None, None, None] + base_y[None, None, :, None]).expand(kh, kw, Ho, Wo)
    gx = (kx[None, :, None, None] + base_x[None, None, None, :]).expand(kh, kw, Ho, Wo)
    off = offset.reshape(B, G, K, 2, Ho, Wo)
    cg = Cin // G
    cols = []
    for g in range(G):
        ys = (gy.reshape(1, K, Ho, Wo) + off[:, g, :, 0]).reshape(B, K * Ho * Wo)
        xs = (gx.reshape(1, K, Ho, Wo) + off[:, g, :, 1]).reshape(B, K * Ho * Wo)
        s = bilinear_gather(x[:, g * cg:(g + 1) * cg], ys, xs).reshape(B, cg, K, Ho * Wo)
        if mask is not None:
            s = s * mask.reshape(B, G, K, Ho * Wo)[:, g, None].to(s.dtype)
        cols.append(s)
    cols = torch.cat(cols, 1)                                        # (B, Cin, K, P)
    out = torch.einsum("bikp,oik->bop", cols, weight.reshape(Cout, Cin, K).to(x.dtype))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1).to(out.dtype)
    return out.reshape(B, Cout, Ho, Wo)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=1, dilation=1,
                  deform_groups=1):
    """Deformable conv v1: :func:`modulated_deform_conv2d` without a mask."""
    return modulated_deform_conv2d(x, offset, None, weight, bias, stride, padding, dilation,
                                   deform_groups)
