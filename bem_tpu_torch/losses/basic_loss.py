"""Pixel losses, the counterpart of bem_tpu/losses/basic_loss.py:18-80."""

from __future__ import annotations

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
