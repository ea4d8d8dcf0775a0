"""Pixel losses, the counterpart of bem_tpu/losses/basic_loss.py (L1, MSE,
Charbonnier, weighted TV, PSNR); images are NHWC."""

from __future__ import annotations

import math

import torch

_REDUCTIONS = ("none", "mean", "sum")


def _reduce(x: torch.Tensor, reduction: str, weight=None) -> torch.Tensor:
    if weight is not None:
        x = x * weight
    if reduction == "none":
        return x
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    raise ValueError(f"reduction {reduction!r} not in {_REDUCTIONS}")


class L1Loss:
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * _reduce((pred - target).abs(), self.reduction, weight)


class MSELoss:
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * _reduce((pred - target).square(), self.reduction, weight)


class CharbonnierLoss:
    """sqrt((x - y)^2 + eps), a differentiable L1."""

    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean", eps: float = 1e-12):
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.eps = eps

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * _reduce(
            torch.sqrt((pred - target).square() + self.eps), self.reduction, weight)


class WeightedTVLoss:
    """Total variation of NHWC ``pred``, optionally pixel-weighted
    (basic_loss.py:70): the reduced |differences| along H plus along W."""

    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        if reduction not in ("mean", "sum"):
            raise ValueError("WeightedTVLoss supports mean | sum")
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, weight=None):
        yw = None if weight is None else weight[:, :-1]
        xw = None if weight is None else weight[:, :, :-1]
        ydiff = _reduce((pred[:, :-1] - pred[:, 1:]).abs(), self.reduction, yw)
        xdiff = _reduce((pred[:, :, :-1] - pred[:, :, 1:]).abs(), self.reduction, xw)
        return self.loss_weight * (ydiff + xdiff)


class PSNRLoss:
    """loss_weight * mean over images of 10 / ln 10 * ln(mse + 1e-8)
    (basic_loss.py:95). ``reduction`` and ``toY`` are accepted and
    ignored, as bem_tpu does."""

    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean", toY: bool = False):
        self.loss_weight = loss_weight
        self.scale = 10.0 / math.log(10.0)

    def __call__(self, pred, target, weight=None):
        mse = (pred - target).square().mean(dim=(1, 2, 3))
        return self.loss_weight * (self.scale * torch.log(mse + 1e-8)).mean()
