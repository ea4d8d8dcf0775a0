"""Batched on-device NIQE for candidate selection.

Counterpart of bem_tpu/metrics/niqe_jax.py::niqe_batch_rgb (same algorithm:
MSCN at two scales, per-block AGGD features, Mahalanobis distance to the
pristine model in ``niqe_pris_params.npz``, a copy of bem_tpu's model
data), batched over the candidates with plain PyTorch ops. The 7x7
Gaussian filter is 49 shifted fp32 multiply-adds rather than a
convolution, so no TF32 path can touch the score.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

_GAM = np.arange(0.2, 10.001, 0.001)
BLOCK = 96  # NIQE block size in pixels


def _r_gam() -> np.ndarray:
    """gamma(2/a)^2 / (gamma(1/a) gamma(3/a)) over the alpha table."""
    g = torch.from_numpy(_GAM)
    lg = torch.lgamma
    return torch.exp(2 * lg(2.0 / g) - lg(1.0 / g) - lg(3.0 / g)).numpy()


def _cubic(x):
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return (1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2))


def _contributions(in_length: int, out_length: int, scale: float):
    """MATLAB imresize bicubic weights with antialiasing (the numpy helper
    of bem_tpu/utils/matlab_functions.py)."""
    kernel_width = 4.0 / scale if scale < 1 else 4.0
    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :] - 1
    dist = u[:, None] - (indices + 1)
    weights = scale * _cubic(dist * scale) if scale < 1 else _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    nz = np.nonzero(np.any(weights != 0, axis=0))[0]
    weights = weights[:, nz[0]:nz[-1] + 1]
    indices = indices[:, nz[0]:nz[-1] + 1]
    aux = np.concatenate([np.arange(in_length), np.arange(in_length - 1, -1, -1)])
    return weights, aux[np.mod(indices.astype(np.int64), 2 * in_length)]


def _resize_half_mat(n: int) -> np.ndarray:
    wts, idx = _contributions(n, int(np.ceil(n * 0.5)), 0.5)
    M = np.zeros((wts.shape[0], n), np.float32)
    np.add.at(M, (np.arange(wts.shape[0])[:, None], idx), wts)
    return M


def _aggd(flat, r_gam, gam):
    """Vectorized AGGD fit. flat (N, P) -> (alpha, beta_l, beta_r, valid)."""
    neg, pos = flat < 0, flat > 0
    sq = flat * flat
    n_neg, n_pos = neg.sum(1), pos.sum(1)
    valid = (n_neg > 0) & (n_pos > 0)
    left_std = torch.sqrt(torch.where(neg, sq, 0.0).sum(1) / n_neg.clamp(min=1))
    right_std = torch.sqrt(torch.where(pos, sq, 0.0).sum(1) / n_pos.clamp(min=1))
    gammahat = left_std / right_std.clamp(min=1e-20)
    rhat = flat.abs().mean(1) ** 2 / sq.mean(1).clamp(min=1e-20)
    rhatnorm = rhat * (gammahat ** 3 + 1) * (gammahat + 1) / (gammahat ** 2 + 1) ** 2
    alpha = gam[torch.argmin((r_gam[None, :] - rhatnorm[:, None]) ** 2, dim=1)]
    ratio = torch.exp(0.5 * (torch.lgamma(1.0 / alpha) - torch.lgamma(3.0 / alpha)))
    return alpha, left_std * ratio, right_std * ratio, valid


def _block_features(blocks, r_gam, gam):
    """blocks (N, bh, bw) -> (N, 18) AGGD features and a validity mask."""
    N = blocks.shape[0]
    alpha, bl, br, valid = _aggd(blocks.reshape(N, -1), r_gam, gam)
    feats = [alpha, (bl + br) / 2]
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        shifted = torch.roll(blocks, shift, dims=(1, 2))
        a2, bl2, br2, v2 = _aggd((blocks * shifted).reshape(N, -1), r_gam, gam)
        mean = (br2 - bl2) * torch.exp(torch.lgamma(2.0 / a2) - torch.lgamma(1.0 / a2))
        feats += [a2, mean, bl2, br2]
        valid = valid & v2
    return torch.stack(feats, dim=1), valid


def _mscn(img, window):
    """(img - mu) / (sigma + 1) with an edge-replicated 7x7 Gaussian filter
    (the flipped window, as scipy's convolve applies it). img (K, H, W)."""
    k = window.shape[0]
    p = k // 2
    H, W = img.shape[-2:]
    x = F.pad(img[:, None], (p, p, p, p), mode="replicate")[:, 0]
    wf = torch.flip(window, (0, 1))

    def filt(a):
        out = torch.zeros_like(img)
        for i in range(k):
            for j in range(k):
                out = out + wf[i, j] * a[:, i:i + H, j:j + W]
        return out

    mu = filt(x)
    sigma = torch.sqrt(torch.abs(filt(x * x) - mu * mu))
    return (img - mu) / (sigma + 1.0)


class _Niqe:
    """NIQE of (K, h, w) Y images in [0, 255] at a fixed size."""

    def __init__(self, h: int, w: int, device):
        p = np.load(os.path.join(os.path.dirname(__file__), "niqe_pris_params.npz"))
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        self.mu_pris = t(np.squeeze(p["mu_pris_param"]))
        self.cov_pris = t(p["cov_pris_param"])
        self.window = t(p["gaussian_window"])
        self.nbh, self.nbw = h // BLOCK, w // BLOCK
        self.hc, self.wc = self.nbh * BLOCK, self.nbw * BLOCK
        self.Mh = t(_resize_half_mat(self.hc))
        self.Mw = t(_resize_half_mat(self.wc))
        self.r_gam, self.gam = t(_r_gam()), t(_GAM)

    def __call__(self, img):
        img = img[:, :self.hc, :self.wc].float()
        K = img.shape[0]
        feats, valids = [], []
        for scale in (1, 2):
            norm = _mscn(img, self.window)
            bh = bw = BLOCK // scale
            blocks = norm.reshape(K, self.nbh, bh, self.nbw, bw).permute(0, 3, 1, 2, 4)
            f, v = _block_features(blocks.reshape(-1, bh, bw), self.r_gam, self.gam)
            feats.append(f.reshape(K, -1, 18))
            valids.append(v.reshape(K, -1))
            if scale == 1:
                img = torch.matmul(torch.matmul(self.Mh, img / 255.0), self.Mw.t()) * 255.0
        dist = torch.cat(feats, dim=2)                                   # (K, nb, 36)
        # a degenerate block NaNs all its columns at that scale in the
        # reference (nanmean); a per-scale column mask reproduces that
        w = torch.cat([valids[0][..., None].expand(-1, -1, 18),
                       valids[1][..., None].expand(-1, -1, 18)], dim=2).float()
        mu_dist = (dist * w).sum(1) / w.sum(1).clamp(min=1.0)          # (K, 36)
        row_ok = (valids[0] & valids[1]).float()[..., None]              # (K, nb, 1)
        n_good = row_ok.sum(1).clamp(min=2.0)                            # (K, 1)
        xc = (dist - mu_dist[:, None]) * row_ok
        cov = xc.transpose(1, 2) @ xc / (n_good - 1.0)[..., None]
        mu_good = (dist * row_ok).sum(1) / n_good
        dmu = (mu_good - mu_dist)[..., None]
        cov = cov - (n_good / (n_good - 1.0))[..., None] * (dmu @ dmu.transpose(1, 2))
        diff = self.mu_pris - mu_dist
        sol = torch.linalg.solve((self.cov_pris + cov) / 2, diff[..., None])
        return torch.sqrt(torch.clamp((diff[:, None, :] @ sol)[:, 0, 0], min=0.0))


def rgb_to_y_255(rgb):
    """[0,1] RGB -> BT.601 Y in [16, 235], rounded; the RGB values are not
    rounded first (bem_tpu niqe_jax.rgb_to_y_255 with round_rgb=False, the
    eval protocol's candidate scoring)."""
    x = rgb.float().clamp(0.0, 1.0) * 255.0
    y = (x[..., 0] * 65.481 + x[..., 1] * 128.553 + x[..., 2] * 24.966) / 255.0 + 16.0
    return torch.round(y)


def niqe_batch_rgb(h: int, w: int):
    """(K, h, w, 3) [0,1] RGB candidates -> (K,) NIQE scores on their device
    (96-pixel blocks, unrounded RGB)."""
    cores = {}

    def fn(imgs):
        core = cores.get(imgs.device)
        if core is None:
            core = cores[imgs.device] = _Niqe(h, w, imgs.device)
        return core(rgb_to_y_255(imgs))

    return fn
