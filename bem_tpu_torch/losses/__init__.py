"""Losses of the port (counterpart of bem_tpu/losses): every name of
bem_tpu's ``LOSS_REGISTRY`` and ``PerceptualLoss``."""

from typing import Any, Dict

from .basic_loss import CharbonnierLoss, L1Loss, MSELoss, PSNRLoss, WeightedTVLoss
from .gan_loss import GANLoss, MultiScaleGANLoss, gradient_penalty_loss, r1_penalty  # noqa: F401
from .my_loss import CombinedLoss

_LOSSES = {"L1Loss": L1Loss, "MSELoss": MSELoss, "CharbonnierLoss": CharbonnierLoss,
           "WeightedTVLoss": WeightedTVLoss, "PSNRLoss": PSNRLoss, "CombinedLoss": CombinedLoss,
           "GANLoss": GANLoss, "MultiScaleGANLoss": MultiScaleGANLoss}
# the losses that hold VGG19 features, built on the caller's device
_ON_DEVICE = ("CombinedLoss",)


def build_loss(opt: Dict[str, Any], device="cuda"):
    """Instantiate a loss from an Options-style dict; ``device`` is where a
    loss with VGG19 features keeps them."""
    opt = dict(opt)
    loss_type = opt.pop("type")
    if loss_type == "PerceptualLoss":
        from .perceptual import build_perceptual

        return build_perceptual(opt, device)
    if loss_type not in _LOSSES:
        raise KeyError(f"No object named '{loss_type}' found in 'loss' registry!")
    if loss_type in _ON_DEVICE:
        opt["device"] = device
    return _LOSSES[loss_type](**opt)
