"""SwinIR and HAT baselines (counterpart of bem_tpu/analysis/model_zoo/swinir_hat.py).

The Swin blocks run on the channel-last view (B, H, W, C) of the map, with
bem_tpu's window partitions and einsums; the residual groups' convs and
the heads run channel-first; GELU is the exact erf form. Relative-position
indices and shift masks are computed in numpy (buffers, not parameters, in
the reference), once per window size or input size and device."""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...archs.arch_util import Upsample
from ...nn.layers import Conv2d
from .common import LayerNormLast, Linear, add_blocks, seeded
from .mambair import CAB


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows, ws, h, w):
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def rpi_sa(ws: int) -> np.ndarray:
    """Relative position index for window self-attention (swinir_hat.py:44-54)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def rpi_oca(ws: int, overlap_ratio: float) -> np.ndarray:
    """Relative position index for overlapping cross-attention
    (swinir_hat.py:57-71)."""
    wse = ws + int(overlap_ratio * ws)
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(wse), np.arange(wse), indexing="ij")).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - wse + 1
    rel[:, :, 1] += ws - wse + 1
    rel[:, :, 0] *= ws + wse - 1
    return rel.sum(-1)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """The (-100 / 0) mask of shifted-window attention (swinir_hat.py:74-86)."""
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = img.reshape(1, h // ws, ws, w // ws, ws, 1)
    win = win.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _on_device(make, args: tuple, device: torch.device):
    """``make(*args)`` (a numpy index or mask) as a tensor on ``device``,
    made once per input size: the shift masks of HAT's 272x272 input hold
    19M entries, too many to rebuild on the host for every block."""
    return torch.from_numpy(make(*args)).to(device)


def _bias(table, idx: torch.Tensor, n: int, m: int):
    """The (heads, n, m) relative-position bias gathered from ``table``."""
    return table[idx.reshape(-1)].reshape(n, m, -1).permute(2, 0, 1)


class _TableAttention(nn.Module):
    """Owns a zero-initialised ``relative_position_bias_table`` (bem_tpu's init)."""

    def __init__(self, rows: int, heads: int):
        super().__init__()
        self.relative_position_bias_table = nn.Parameter(torch.empty(rows, heads))

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.relative_position_bias_table.zero_()


class WindowAttention(_TableAttention):
    """W-MSA with relative position bias (swinir_hat.py:89-122)."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__((2 * window_size - 1) ** 2, num_heads)
        self.window_size, self.num_heads = window_size, num_heads
        self.qkv = Linear(dim, 3 * dim, bias=True)
        self.proj = Linear(dim, dim, bias=True)

    def forward(self, x, mask=None):
        b_, n, c = x.shape
        nh = self.num_heads
        d = c // nh
        qkv = self.qkv(x).reshape(b_, n, 3, nh, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = torch.einsum("bhnd,bhmd->bhnm", q * d ** -0.5, k)
        table = self.relative_position_bias_table
        idx = _on_device(rpi_sa, (self.window_size,), table.device)
        attn = attn + _bias(table, idx, n, n)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(b_, nh, n, n)
        out = torch.einsum("bhnm,bhmd->bhnd", attn.softmax(-1), v)
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, in_features)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """Swin transformer block on (B, H, W, C); with conv_scale > 0, HAT's HAB
    (swinir_hat.py:136-184)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float, conv_scale: float = 0.0, compress_ratio: int = 3,
                 squeeze_factor: int = 30):
        super().__init__()
        self.window_size, self.shift_size, self.conv_scale = window_size, shift_size, conv_scale
        self.norm1 = LayerNormLast(dim, channels_last=True)
        if conv_scale:
            self.conv_block = CAB(dim, compress_ratio, squeeze_factor)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNormLast(dim, channels_last=True)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, h, w, c = x.shape
        # windows shrink to a smaller input, and then do not shift (hat.py:246-249)
        ws = min(self.window_size, h, w)
        shift = self.shift_size if min(h, w) > self.window_size else 0
        y = self.norm1(x)
        conv_x = 0.0
        if self.conv_scale:
            conv_x = self.conv_block(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) * self.conv_scale
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _on_device(shift_attn_mask, (h, w, ws, shift), y.device).to(y.dtype)
        wins = self.attn(window_partition(y, ws).reshape(-1, ws * ws, c), mask)
        y = window_reverse(wins.reshape(-1, ws, ws, c), ws, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y + conv_x
        return x + self.mlp(self.norm2(x))


class OCAB(_TableAttention):
    """Overlapping cross-attention block on (B, H, W, C) (swinir_hat.py:187-246)."""

    def __init__(self, dim: int, window_size: int, overlap_ratio: float, num_heads: int,
                 mlp_ratio: float = 2.0):
        ows = window_size + int(overlap_ratio * window_size)
        super().__init__((window_size + ows - 1) ** 2, num_heads)
        self.window_size, self.overlap_ratio, self.num_heads = window_size, overlap_ratio, num_heads
        self.ows = ows
        self.norm1 = LayerNormLast(dim, channels_last=True)
        self.qkv = Linear(dim, 3 * dim, bias=True)
        self.proj = Linear(dim, dim, bias=True)
        self.norm2 = LayerNormLast(dim, channels_last=True)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, h, w, c = x.shape
        ws, ows, nh = self.window_size, self.ows, self.num_heads
        pad = (ows - ws) // 2
        d = c // nh
        q, k, v = self.qkv(self.norm1(x)).chunk(3, -1)
        q_wins = window_partition(q, ws).reshape(-1, ws * ws, c)
        nwh, nww = h // ws, w // ws
        idx_h, idx_w = (torch.arange(ows, device=x.device)[None] + ws * torch.arange(
            nw, device=x.device)[:, None] for nw in (nwh, nww))

        def overlap_windows(t):  # (B, H, W, C) padded -> (B*nw, ows*ows, C)
            t = F.pad(t, (0, 0, pad, pad, pad, pad))
            t = t[:, idx_h.reshape(-1)][:, :, idx_w.reshape(-1)]
            t = t.reshape(b, nwh, ows, nww, ows, c)
            return t.permute(0, 1, 3, 2, 4, 5).reshape(-1, ows * ows, c)

        b_ = q_wins.shape[0]

        def heads(t):
            return t.reshape(b_, -1, nh, d).transpose(1, 2)

        attn = torch.einsum("bhnd,bhmd->bhnm", heads(q_wins) * d ** -0.5,
                            heads(overlap_windows(k)))
        table = self.relative_position_bias_table
        idx = _on_device(rpi_oca, (ws, self.overlap_ratio), table.device)
        attn = attn + _bias(table, idx, ws * ws, ows * ows)[None]
        out = torch.einsum("bhnm,bhmd->bhnd", attn.softmax(-1), heads(overlap_windows(v)))
        out = window_reverse(out.transpose(1, 2).reshape(-1, ws, ws, c), ws, h, w)
        x = self.proj(out) + x
        return x + self.mlp(self.norm2(x))


class RSTB(nn.Module):
    """SwinIR's residual group on (B, C, H, W): Swin blocks, shifted every
    other one, and a 3x3 conv ('1conv') (swinir_hat.py:249-264); with a
    ``conv_scale`` and an ``overlap_ratio``, HAT's RHAG: HABs, an OCAB,
    the conv (swinir_hat.py:267-293)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, conv_scale: float = 0.0, compress_ratio: int = 3,
                 squeeze_factor: int = 30, overlap_ratio: float = None):
        super().__init__()
        self.blocks = add_blocks(self, "block", lambda i: SwinBlock(
            dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2, mlp_ratio,
            conv_scale, compress_ratio, squeeze_factor), depth)
        self.overlap_attn = (None if overlap_ratio is None else
                             OCAB(dim, window_size, overlap_ratio, num_heads, mlp_ratio))
        self.conv = Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        y = x.permute(0, 2, 3, 1)
        for blk in self.blocks:
            y = blk(y)
        if self.overlap_attn is not None:
            y = self.overlap_attn(y)
        return self.conv(y.permute(0, 3, 1, 2)) + x


class _SRTransformer(nn.Module):
    """The shared frame of SwinIR and HAT: mean shift, conv_first,
    patch_norm, the residual groups, norm, conv_after_body, then the
    pixel-shuffle head and the crop to the input's size times the scale."""

    def _frame(self, in_chans, embed_dim, n_layers, group, upscale, img_range, rgb_mean):
        self.upscale, self.img_range = upscale, img_range
        self.register_buffer("mean", torch.tensor(rgb_mean).reshape(1, -1, 1, 1),
                             persistent=False)
        self.conv_first = Conv2d(in_chans, embed_dim, 3, padding=1)
        self.patch_norm = LayerNormLast(embed_dim)
        self.layers = add_blocks(self, "layer", group, n_layers)
        self.norm = LayerNormLast(embed_dim)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_before_upsample = Conv2d(embed_dim, 64, 3, padding=1)
        self.upsample = Upsample(upscale, 64)
        self.conv_last = Conv2d(64, in_chans, 3, padding=1)

    def _run(self, x, h0, w0):
        mean = self.mean.to(x.dtype)
        feat = self.conv_first((x - mean) * self.img_range)
        y = self.patch_norm(feat)
        for layer in self.layers:
            y = layer(y)
        feat = self.conv_after_body(self.norm(y)) + feat
        feat = F.leaky_relu(self.conv_before_upsample(feat), 0.01)
        out = self.conv_last(self.upsample(feat)) / self.img_range + mean
        return out[:, :, :h0 * self.upscale, :w0 * self.upscale]


class SwinIR(_SRTransformer):
    """swinir_hat.py:296-341; comparison config x4 pixel-shuffle, embed 180,
    depths (6,)*6, heads 6, window 8, mlp_ratio 2."""

    def __init__(self, in_chans: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6), window_size: int = 8,
                 mlp_ratio: float = 2.0, upscale: int = 4, img_range: float = 1.0,
                 rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040)):
        super().__init__()
        self.window_size = window_size
        self._frame(in_chans, embed_dim, len(depths),
                    lambda i: RSTB(embed_dim, depths[i], num_heads[i], window_size, mlp_ratio),
                    upscale, img_range, rgb_mean)

    def forward(self, x):
        ws = self.window_size
        h0, w0 = x.shape[2:]
        x = F.pad(x, (0, (ws - w0 % ws) % ws, 0, (ws - h0 % ws) % ws), mode="reflect")
        return self._run(x, h0, w0)


def buildSwinIR(gen=None, device="cuda"):
    return seeded(SwinIR(upscale=4, window_size=8, img_range=1.0, depths=(6, 6, 6, 6, 6, 6),
                         embed_dim=180, num_heads=(6, 6, 6, 6, 6, 6), mlp_ratio=2.0), gen, device)


class HAT(_SRTransformer):
    """swinir_hat.py:351-372; comparison config x2 pixel-shuffle, embed 180,
    depths / heads (6,)*6, window 16, OCAB overlap 0.5, CAB scale 0.01."""

    def __init__(self, in_chans: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6), window_size: int = 16,
                 compress_ratio: int = 3, squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 2.0, upscale: int = 2,
                 img_range: float = 1.0, rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040)):
        super().__init__()
        self.window_size = window_size
        self._frame(in_chans, embed_dim, len(depths),
                    lambda i: RSTB(embed_dim, depths[i], num_heads[i], window_size, mlp_ratio,
                                   conv_scale, compress_ratio, squeeze_factor, overlap_ratio),
                    upscale, img_range, rgb_mean)

    def forward(self, x):
        ws = self.window_size
        h0, w0 = x.shape[2:]
        # the reference pads by a mirrored concat to the next window multiple
        ph, pw = (h0 // ws + 1) * ws - h0, (w0 // ws + 1) * ws - w0
        x = torch.cat([x, x.flip(2)], 2)[:, :, :h0 + ph]
        x = torch.cat([x, x.flip(3)], 3)[:, :, :, :w0 + pw]
        return self._run(x, h0, w0)


def buildHAT(gen=None, device="cuda"):
    return seeded(HAT(), gen, device)
