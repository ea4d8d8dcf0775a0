"""GAN losses, the counterpart of bem_tpu/losses/gan_loss.py: ``GANLoss``
(vanilla, lsgan, wgan, wgan_softplus, hinge), ``MultiScaleGANLoss``, the R1
and gradient penalties. No BEM option file uses them."""

from __future__ import annotations

import torch
import torch.nn.functional as F

GAN_TYPES = ("vanilla", "lsgan", "wgan", "wgan_softplus", "hinge")


class GANLoss:
    def __init__(self, gan_type: str = "vanilla", real_label_val: float = 1.0,
                 fake_label_val: float = 0.0, loss_weight: float = 1.0):
        if gan_type not in GAN_TYPES:
            raise NotImplementedError(f"GAN type {gan_type} not implemented")
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def _target(self, x, target_is_real):
        return torch.full_like(x, self.real_label_val if target_is_real else self.fake_label_val)

    def __call__(self, x, target_is_real: bool, is_disc: bool = False):
        t = self.gan_type
        if t == "vanilla":  # BCE with logits, in its stable form
            tgt = self._target(x, target_is_real)
            loss = (x.clamp(min=0) - x * tgt + torch.log1p(torch.exp(-x.abs()))).mean()
        elif t == "lsgan":
            loss = (x - self._target(x, target_is_real)).square().mean()
        elif t == "wgan":
            loss = -x.mean() if target_is_real else x.mean()
        elif t == "wgan_softplus":
            loss = F.softplus(-x).mean() if target_is_real else F.softplus(x).mean()
        elif is_disc:  # hinge
            loss = F.relu(1.0 + (-x if target_is_real else x)).mean()
        else:
            loss = -x.mean()
        return loss if is_disc else loss * self.loss_weight


class MultiScaleGANLoss(GANLoss):
    """The mean of GANLoss over a list of predictions (each the last of its
    own list where it is one)."""

    def __call__(self, x, target_is_real: bool, is_disc: bool = False):
        if isinstance(x, (list, tuple)):
            total = 0.0
            for xi in x:
                if isinstance(xi, (list, tuple)):
                    xi = xi[-1]
                total = total + super().__call__(xi, target_is_real, is_disc)
            return total / len(x)
        return super().__call__(x, target_is_real, is_disc)


def r1_penalty(real_grad: torch.Tensor) -> torch.Tensor:
    """R1 penalty from d(real_pred)/d(real_img) (gan_loss.py:72)."""
    return real_grad.square().sum(dim=(1, 2, 3)).mean()


def gradient_penalty_loss(interp_grad: torch.Tensor, weight=None) -> torch.Tensor:
    """WGAN-GP's (||grad|| - 1)^2 from the interpolates' gradient (gan_loss.py:77)."""
    if weight is not None:
        interp_grad = interp_grad * weight
    norm = torch.sqrt(interp_grad.square().sum(dim=(1, 2, 3)) + 1e-12)
    return (norm - 1.0).square().mean()
