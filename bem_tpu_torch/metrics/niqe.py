"""NIQE: batched on the device for candidate selection, and on the host.

:func:`niqe_batch_rgb` is the counterpart of
bem_tpu/metrics/niqe_jax.py::niqe_batch_rgb (same algorithm: MSCN at two
scales, per-block AGGD features, Mahalanobis distance to the pristine
model in ``niqe_pris_params.npz``, a copy of bem_tpu's model data),
batched over the candidates with plain PyTorch ops in fp32. The 7x7
Gaussian filter is 49 shifted multiply-adds rather than a convolution, so
no TF32 path can touch the score. :func:`calculate_niqe` is the
``val.metrics`` entry of bem_tpu/metrics/niqe.py: the same core in fp64 on
the CPU, as that module's numpy core computes it.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.cv_ops import bgr2gray
from ..utils.matlab_functions import _contributions
from .metric_util import reorder_image, to_y_channel

_GAM = np.arange(0.2, 10.001, 0.001)
BLOCK = 96  # NIQE block size in pixels


def _r_gam() -> np.ndarray:
    """gamma(2/a)^2 / (gamma(1/a) gamma(3/a)) over the alpha table."""
    g = torch.from_numpy(_GAM)
    lg = torch.lgamma
    return torch.exp(2 * lg(2.0 / g) - lg(1.0 / g) - lg(3.0 / g)).numpy()


def _resize_half_mat(n: int, dtype=np.float32) -> np.ndarray:
    wts, idx = _contributions(n, int(np.ceil(n * 0.5)), 0.5, antialiasing=True)
    M = np.zeros((wts.shape[0], n), dtype)
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


class NiqeCore(nn.Module):
    """NIQE of (K, h, w) Y images in [0, 255] at a fixed size, in ``dtype``;
    ``np_cov`` takes np.cov's reading of an image with one good block (the
    host metric's), else its covariance is 0 (niqe_jax's). The pristine
    model, the filter window, the half-size resize matrices and the alpha
    table are buffers, so a module that holds the core carries them into
    its exported program."""

    def __init__(self, h: int, w: int, device, dtype=torch.float32, np_cov: bool = False):
        super().__init__()
        p = np.load(os.path.join(os.path.dirname(__file__), "niqe_pris_params.npz"))
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.dtype, self.np_cov = dtype, np_cov
        self.nbh, self.nbw = h // BLOCK, w // BLOCK
        self.hc, self.wc = self.nbh * BLOCK, self.nbw * BLOCK
        for name, a in (("mu_pris", np.squeeze(p["mu_pris_param"])),
                        ("cov_pris", p["cov_pris_param"]), ("window", p["gaussian_window"]),
                        ("Mh", _resize_half_mat(self.hc, np_dtype)),
                        ("Mw", _resize_half_mat(self.wc, np_dtype)),
                        ("r_gam", _r_gam()), ("gam", _GAM)):
            self.register_buffer(name, torch.as_tensor(np.ascontiguousarray(a, np_dtype),
                                                       device=device),
                                 persistent=False)

    def forward(self, img):
        img = img[:, :self.hc, :self.wc].to(self.dtype)
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
        if self.np_cov:
            if torch.compiler.is_compiling():
                raise RuntimeError("NIQE with np_cov picks its images by value (.tolist()): "
                                   "it cannot be traced or exported")
            # np.cov reads a single good row as one variable of 36
            # observations: a scalar variance added to every entry
            for k in torch.nonzero(row_ok.sum((1, 2)) == 1).flatten().tolist():
                cov[k] = dist[k][row_ok[k, :, 0] > 0][0].var()
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
            core = cores[imgs.device] = NiqeCore(h, w, imgs.device)
        return core(rgb_to_y_255(imgs))

    return fn


def calculate_niqe(img, crop_border, input_order="HWC", convert_to="y", **kwargs):
    """NIQE of a [0, 255] BGR (or grey) image on the host (bem_tpu
    niqe.py:99-120): its Y channel (``convert_to="y"``) or its grey
    conversion (``"gray"``, cv2's BGR2GRAY on [0, 1]), cropped, rounded,
    then the core in fp64; ``input_order="HW"`` takes a 2-D image as it is."""
    img = np.asarray(img).astype(np.float32)
    if input_order != "HW":
        img = reorder_image(img, input_order=input_order)
        if convert_to == "y":
            img = to_y_channel(img)
        elif convert_to == "gray":
            img = bgr2gray(img / 255.0) * 255.0
        img = np.squeeze(img)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    img = torch.from_numpy(np.ascontiguousarray(img.round(), np.float64))
    return float(NiqeCore(*img.shape, "cpu", torch.float64, np_cov=True)(img[None])[0])
