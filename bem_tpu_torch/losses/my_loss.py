"""The ad-hoc combined losses, the counterpart of bem_tpu/losses/my_loss.py.

Colour, PSNR, smooth-L1, (MS-)SSIM and histogram losses and the
``CombinedLoss`` aggregate. SSIM follows pytorch_msssim's algorithm, as
bem_tpu does: a separable Gaussian window (11, sigma 1.5), VALID padding,
K1 = 0.01, K2 = 0.03; MS-SSIM its five default level weights with a 2x2
average pool (padded by the odd remainder, the pad counted) between levels.
``power_factors`` is accepted and ignored, as in the reference's call.

Images are NHWC float in [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .perceptual import VGGFeatureExtractor

_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def color_loss(y_true, y_pred):
    """Mean |difference| of the per-image global means (my_loss.py:25)."""
    return (y_true.mean(dim=(1, 2, 3)) - y_pred.mean(dim=(1, 2, 3))).abs().mean()


def psnr_loss(y_true, y_pred):
    """40 - PSNR of the batch's MSE (my_loss.py:32)."""
    mse = (y_true - y_pred).square().mean()
    return 40.0 - 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def smooth_l1_loss(y_true, y_pred):
    """Smooth L1 with beta 1 (my_loss.py:39)."""
    d = (y_true - y_pred).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def _gaussian_window(size=11, sigma=1.5):
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return torch.from_numpy((g / g.sum()).astype(np.float32))


def _filter2d_sep(x, win):
    """Per-channel VALID Gaussian filter along H, then W; x NCHW."""
    c = x.shape[1]
    S = win.numel()
    win = win.to(x.device, x.dtype)
    x = F.conv2d(x, win.reshape(1, 1, S, 1).expand(c, 1, S, 1), groups=c)
    return F.conv2d(x, win.reshape(1, 1, 1, S).expand(c, 1, 1, S), groups=c)


def _ssim_per_channel(x, y, data_range=1.0, win_size=11, sigma=1.5):
    """(ssim, cs) per (batch, channel) of NCHW maps (pytorch_msssim._ssim)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gaussian_window(win_size, sigma)
    mu1, mu2 = _filter2d_sep(x, win), _filter2d_sep(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d_sep(x * x, win) - mu1_sq
    sigma2_sq = _filter2d_sep(y * y, win) - mu2_sq
    sigma12 = _filter2d_sep(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def _cf(x):
    return x.permute(0, 3, 1, 2)


def ssim(x, y, data_range=1.0, size_average=True):
    """SSIM of NHWC images: the mean, or per image without ``size_average``."""
    s, _ = _ssim_per_channel(_cf(x), _cf(y), data_range)
    return s.mean() if size_average else s.mean(dim=1)


def ms_ssim(x, y, data_range=1.0, size_average=True, weights=_MS_WEIGHTS):
    """MS-SSIM of NHWC images over ``len(weights)`` levels."""
    x, y = _cf(x), _cf(y)
    w = torch.tensor(weights, dtype=torch.float32, device=x.device)
    mcs = []
    for i in range(len(weights)):
        s, cs = _ssim_per_channel(x, y, data_range)
        if i < len(weights) - 1:
            mcs.append(F.relu(cs))
            pad = (x.shape[2] % 2, x.shape[3] % 2)
            x = F.avg_pool2d(x, 2, padding=pad, count_include_pad=True)
            y = F.avg_pool2d(y, 2, padding=pad, count_include_pad=True)
    vals = torch.stack(mcs + [F.relu(s)])                  # (levels, B, C)
    out = torch.prod(vals ** w[:, None, None], dim=0)      # (B, C)
    return out.mean() if size_average else out.mean(dim=1)


def ssim_loss(y_true, y_pred, max_val=1.0, power_factors=(0.5, 0.5)):
    return 1.0 - ssim(y_true, y_pred, data_range=max_val)


def multiscale_ssim_loss(y_true, y_pred, max_val=1.0, power_factors=(0.5, 0.5)):
    return 1.0 - ms_ssim(y_true, y_pred, data_range=max_val)


def _histogram(v, bins):
    """jnp.histogram(v, bins, range=(0, 1)) normalised to sum 1: edges
    i / bins, each value in the bin whose left edge it reaches, 1.0 in the
    last, values outside [0, 1] dropped."""
    v = v.detach().reshape(-1).float()
    edges = torch.arange(bins + 1, dtype=torch.float32, device=v.device) / bins
    idx = torch.searchsorted(edges, v, right=True)
    idx = torch.where(v == 1.0, torch.full_like(idx, bins), idx)
    h = torch.bincount(idx, minlength=bins + 2)[1:bins + 1].float()
    return h / h.sum()


def histogram_loss(y_true, y_pred, bins=256):
    """Mean |difference| of the two global histograms (my_loss.py:116);
    no gradient, as torch.histc has none."""
    return (_histogram(y_true, bins) - _histogram(y_pred, bins)).abs().mean()


class VGGPerceptualLoss:
    """MSE between relu(conv3_3) VGG19 features, no input normalisation
    (my_loss.py:127; torchvision's ``features[:16]``)."""

    def __init__(self, device="cuda"):
        self._extract = VGGFeatureExtractor(["conv3_3"], use_input_norm=False, device=device)

    def __call__(self, y_true, y_pred):
        ft = F.relu(self._extract(y_true)["conv3_3"])
        fp = F.relu(self._extract(y_pred)["conv3_3"])
        return (ft - fp).square().mean()


class CombinedLoss:
    """The weighted sum of the six terms (my_loss.py:145)."""

    def __init__(self, loss_weight: float = 1.0, device="cuda"):
        self.loss_weight = loss_weight
        self.perceptual = VGGPerceptualLoss(device)
        self.alpha1, self.alpha2, self.alpha3 = 1.00, 0.06, 0.05
        self.alpha4, self.alpha5, self.alpha6 = 0.5, 0.0083, 0.25

    def __call__(self, y_true, y_pred):
        total = (self.alpha1 * smooth_l1_loss(y_true, y_pred)
                 + self.alpha2 * self.perceptual(y_true, y_pred)
                 + self.alpha3 * histogram_loss(y_true, y_pred)
                 + self.alpha5 * psnr_loss(y_true, y_pred)
                 + self.alpha6 * color_loss(y_true, y_pred)
                 + self.alpha4 * ssim_loss(y_true, y_pred))
        return self.loss_weight * total
