"""Mixup (counterpart of bem_tpu/utils/mixing_augment.py): a batch mixed with
itself flipped along the batch axis, by a weight lam ~ Beta(beta, beta).

Every draw comes from an explicit numpy ``Generator`` (torch's Beta takes
none); the trainers draw lam through :func:`mixup_lam` from (seed, step), so
a resumed run draws what an unbroken one would.
"""

from __future__ import annotations

import numpy as np
import torch


def mixup_lam(beta: float, seed: int, step: int) -> float:
    """The Beta(beta, beta) weight of update ``step`` of a run seeded ``seed``."""
    return float(np.random.default_rng((seed, step)).beta(beta, beta))


def mix(target: torch.Tensor, input_: torch.Tensor, lam, flip=lambda t: t.flip(0)):
    """lam * x + (1 - lam) * flip(x), for both tensors, ``flip`` the batch
    flipped along axis 0 (a trainer's rows of the global batch flipped,
    under dist); lam is taken as an fp32 scalar, as bem_tpu's is."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=target.device)
    return (lam * target + (1 - lam) * flip(target),
            lam * input_ + (1 - lam) * flip(input_))


class MixingAugment:
    """``use_identity``: a fair coin, drawn before lam, skips the mix."""

    def __init__(self, mixup_beta: float, use_identity: bool, rng: np.random.Generator):
        self.mixup_beta = mixup_beta
        self.use_identity = use_identity
        self.rng = rng

    def __call__(self, target, input_, lam=None, do_mix=None):
        """``lam`` and the coin ``do_mix`` are drawn from ``rng`` when None."""
        if self.use_identity:
            if do_mix is None:
                do_mix = bool(self.rng.random() < 0.5)
            if not do_mix:
                return target, input_
        if lam is None:
            lam = self.rng.beta(self.mixup_beta, self.mixup_beta)
        return mix(target, input_, lam)
