"""Losses of the port (counterpart of bem_tpu/losses)."""

from typing import Any, Dict

from .basic_loss import CharbonnierLoss, L1Loss, MSELoss

_LOSSES = {"L1Loss": L1Loss, "MSELoss": MSELoss, "CharbonnierLoss": CharbonnierLoss}


def build_loss(opt: Dict[str, Any]):
    """Instantiate a loss from an Options-style dict."""
    opt = dict(opt)
    loss_type = opt.pop("type")
    if loss_type not in _LOSSES:
        raise NotImplementedError(f"loss {loss_type} is not ported")
    return _LOSSES[loss_type](**opt)
