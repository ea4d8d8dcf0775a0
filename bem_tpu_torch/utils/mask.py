"""The MIM random patch mask (counterpart of bem_tpu/utils/mask.py)."""

from __future__ import annotations

import numpy as np


class MaskGenerator:
    """``mask_count = ceil(tokens * ratio)`` of the (input / mask_patch)^2
    tokens set to 1, drawn as ``rng.permutation(tokens)[:mask_count]``, each
    token repeated mask_patch / model_patch times along both axes; int32
    (H, W) with H = W = input_size / model_patch_size."""

    def __init__(self, input_size: int, mask_patch_size: int, model_patch_size: int,
                 mask_ratio: float, rng: np.random.Generator):
        if input_size % mask_patch_size or mask_patch_size % model_patch_size:
            raise ValueError(f"MaskGenerator: input_size {input_size}, mask_patch_size "
                             f"{mask_patch_size}, model_patch_size {model_patch_size} "
                             f"do not divide")
        self.rand_size = input_size // mask_patch_size
        self.scale = mask_patch_size // model_patch_size
        self.token_count = self.rand_size ** 2
        self.mask_count = int(np.ceil(self.token_count * mask_ratio))
        self.rng = rng

    def __call__(self) -> np.ndarray:
        mask = np.zeros(self.token_count, dtype=np.int32)
        mask[self.rng.permutation(self.token_count)[: self.mask_count]] = 1
        mask = mask.reshape(self.rand_size, self.rand_size)
        return mask.repeat(self.scale, axis=0).repeat(self.scale, axis=1)
