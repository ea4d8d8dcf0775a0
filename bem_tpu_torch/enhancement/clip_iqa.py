"""CLIP-IQA candidate scorer (counterpart of bem_tpu/enhancement/clip_iqa.py).

Per prompt pair (positive, negative) the score is the softmax weight of
the positive prompt; the pairs are averaged with brightness x 0.7
(Enhancement/eval.py:236-242). The vision tower and the precomputed
prompt embeddings come from the converted bundle at ``BEM_CLIP_NPZ``
(default ``enhancement/weights/clip_iqa_vitb32.npz``; bem_tpu's
tools/convert_clip.py writes it). Without a bundle construction raises:
a semantic scorer has no meaningful fallback. bem_tpu's second route, a
huggingface snapshot at ``BEM_CLIP_DIR`` through ``transformers``, is not
ported.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch

from .clip import CLIPVisionTower, clip_iqa_score_fn, load_clip_iqa_npz, load_flax_tree

PROMPT_PAIRS = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
}

DEFAULT_NPZ = os.path.join(os.path.dirname(__file__), "weights", "clip_iqa_vitb32.npz")


class ClipIQA:
    """``score(images)``: (K, H, W, 3) RGB in [0, 1] on the scorer's device
    -> (K,) scores there, higher better. The tower is ViT-B/32
    (clip_flax.CLIPVisionTower's defaults)."""

    def __init__(self, prompts: Sequence[str] = ("brightness", "noisiness", "quality"),
                 device="cuda"):
        self.prompts = list(prompts)
        unknown = [p for p in self.prompts if p not in PROMPT_PAIRS]
        if unknown:
            raise KeyError(f"unknown CLIP-IQA prompts {unknown} (known: {list(PROMPT_PAIRS)})")
        npz = os.environ.get("BEM_CLIP_NPZ", DEFAULT_NPZ)
        if not os.path.isfile(npz):
            raise RuntimeError(
                f"CLIP-IQA needs CLIP weights: set BEM_CLIP_NPZ to a bundle converted with "
                f"tools/convert_clip.py (none at {npz}; zero-egress machines cannot download "
                f"openai/clip-vit-base-patch32). Use --no_ref niqe instead.")
        params, text_embeds, avail, scale = load_clip_iqa_npz(npz)
        idx = []
        for p in self.prompts:
            if p not in avail:
                raise RuntimeError(f"prompt {p!r} not in converted bundle {npz} (has {avail}); "
                                   f"re-run tools/convert_clip.py")
            idx += [2 * avail.index(p), 2 * avail.index(p) + 1]
        self.device = torch.device(device)
        tower = load_flax_tree(CLIPVisionTower(), params).to(self.device).eval()
        self.score = clip_iqa_score_fn(text_embeds[idx], self.prompts, scale, tower)
