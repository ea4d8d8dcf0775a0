"""QD Retinex decomposition losses, NCHW: counterpart of bem_tpu/qd/loss.py
(RetinexLoss, its extended weighting with the total-variation and FFT
terms, and the reconstruction-only warm-up objective).

Q1 / Q2 are (B, 4, H, W) quaternion maps: reflectance R = Q1[:, 1:],
illumination I = Q2[:, 1:], and the Hamilton product Q1 x Q2 reconstructs
the image in its imaginary parts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.quaternion import hamilton_product

_GRAY = (0.299, 0.587, 0.114)


def _gradient(x: torch.Tensor, direction: str) -> torch.Tensor:
    """|conv2d(x, 2x2 kernel, padding 1)| of a (B, 1, H, W) map: (B, 1, H+1, W+1),
    the reference's padding (its mean downstream makes that benign)."""
    k = [[0.0, 0.0], [-1.0, 1.0]] if direction == "x" else [[0.0, -1.0], [0.0, 1.0]]
    kern = torch.tensor(k, dtype=x.dtype, device=x.device)[None, None]
    return F.conv2d(x, kern, padding=1).abs()


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 window sum over zero padding / 9."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _gray(x: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_GRAY, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
    return (x * w).sum(dim=1, keepdim=True)


def smoothness(I: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Illumination smoothness weighted by exp(-10 * the pooled reflectance
    gradient)."""
    Rg, Ig = _gray(R), _gray(I)
    return (_gradient(Ig, "x") * torch.exp(-10.0 * _avg_pool3(_gradient(Rg, "x")))
            + _gradient(Ig, "y") * torch.exp(-10.0 * _avg_pool3(_gradient(Rg, "y")))).mean()


def total_variation_loss(img: torch.Tensor, weight: float = 0.1) -> torch.Tensor:
    tv_h = (img[:, :, 1:, :] - img[:, :, :-1, :]).abs().mean()
    tv_w = (img[:, :, :, 1:] - img[:, :, :, :-1]).abs().mean()
    return weight * (tv_h + tv_w)


def frequency_regularization(img: torch.Tensor, weight: float = 0.01) -> torch.Tensor:
    """weight * mean |FFT| over the last 10 x 10 corner of the shifted
    orthonormal spectrum over H and W."""
    fft = torch.fft.fftshift(torch.fft.fft2(img.float(), norm="ortho"), dim=(-2, -1))
    return weight * fft[..., -10:, -10:].abs().mean()


def _l1(a, b):
    return (a - b).abs().mean()


class RetinexLoss:
    """RetinexNet-style decomposition loss on quaternion pairs. ``extended``
    adds the total-variation and FFT terms with their weights; without it,
    the original weighting."""

    def __init__(self, extended: bool = False):
        self.extended = extended

    def __call__(self, Q1_low, Q2_low, input_low, Q1_high, Q2_high, input_high):
        """Q* (B, 4, H, W), inputs (B, 3, H, W); returns the dict of terms,
        ``loss_Decom`` the total."""
        R_low, I_low = Q1_low[:, 1:], Q2_low[:, 1:]
        R_high, I_high = Q1_high[:, 1:], Q2_high[:, 1:]
        recon_low = hamilton_product(Q1_low, Q2_low)[:, 1:]
        recon_high = hamilton_product(Q1_high, Q2_high)[:, 1:]
        recon_mutal_low = hamilton_product(Q1_high, Q2_low)[:, 1:]
        recon_mutal_high = hamilton_product(Q1_low, Q2_high)[:, 1:]
        out = {"recon_loss_low": _l1(recon_low, input_low),
               "recon_loss_high": _l1(recon_high, input_high),
               "recon_loss_mutal_low": _l1(recon_mutal_low, input_low),
               "recon_loss_mutal_high": _l1(recon_mutal_high, input_high),
               "equal_R_loss": _l1(R_low, R_high.detach())}
        recon = out["recon_loss_low"] + out["recon_loss_high"]
        if self.extended:
            smooth_low = smoothness(I_low, R_low) + total_variation_loss(R_low)
            smooth_high = smoothness(I_high, R_high) + total_variation_loss(R_high)
            freq_loss = frequency_regularization(recon_low) + frequency_regularization(recon_high)
            loss = (recon + 0.01 * out["recon_loss_mutal_low"] + 0.01 * out["recon_loss_mutal_high"]
                    + 0.05 * smooth_low + 0.05 * smooth_high + 0.01 * out["equal_R_loss"]
                    + freq_loss)
            out["freq_loss"] = freq_loss
        else:
            smooth_low, smooth_high = smoothness(I_low, R_low), smoothness(I_high, R_high)
            loss = (recon + 0.001 * out["recon_loss_mutal_low"]
                    + 0.001 * out["recon_loss_mutal_high"]
                    + 0.1 * smooth_low + 0.1 * smooth_high + 0.01 * out["equal_R_loss"])
        out["Ismooth_loss_low"] = smooth_low
        out["Ismooth_loss_high"] = smooth_high
        out["loss_Decom"] = loss
        return out

    def recon_only(self, Q1_low, Q2_low, input_low, Q1_high, Q2_high, input_high):
        """The warm-up objective: the two reconstruction terms."""
        return (_l1(hamilton_product(Q1_low, Q2_low)[:, 1:], input_low)
                + _l1(hamilton_product(Q1_high, Q2_high)[:, 1:], input_high))
