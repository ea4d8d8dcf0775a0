"""CLIP ViT vision tower and the CLIP-IQA prompt-pair score (counterpart
of bem_tpu/enhancement/clip_flax.py), in plain PyTorch.

The tower is huggingface's CLIPVisionTransformer + visual_projection: a
bias-free patch convolution, the class token, learned position
embeddings, a pre-LN, pre-LN encoder layers with quick-GELU MLPs, a
post-LN on the class token and a bias-free projection. The text tower
never runs: the prompt embeddings come precomputed in the weight bundle
(``load_clip_iqa_npz``, bem_tpu's ``BEM_CLIP_NPZ`` layout).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, nn.Linear(width, width))

    def forward(self, x):  # (B, L, D)
        B, L, D = x.shape
        hd = D // self.heads

        def split(t):
            return t.reshape(B, L, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x) * hd ** -0.5)
        att = torch.softmax(q @ split(self.k_proj(x)).transpose(-1, -2), dim=-1)
        out = (att @ split(self.v_proj(x))).transpose(1, 2).reshape(B, L, D)
        return self.out_proj(out)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.self_attn = CLIPAttention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)
        self.fc1 = nn.Linear(width, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, width)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class CLIPVisionTower(nn.Module):
    """(B, H, W, 3) normalised pixels -> (B, proj_dim) image embeddings.
    Parameter names follow the flax tree of clip_flax.CLIPVisionTower
    (``layer_{i}``, ``pre_layrnorm``, ...); the defaults are ViT-B/32's."""

    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12, patch: int = 32,
                 image_size: int = 224, proj_dim: int = 512, mlp_dim: int = 0):
        super().__init__()
        self.width, self.layers, self.patch, self.image_size = width, layers, patch, image_size
        n_pos = (image_size // patch) ** 2 + 1
        self.patch_embedding = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.position_embedding = nn.Parameter(torch.zeros(n_pos, width))
        self.pre_layrnorm = nn.LayerNorm(width, eps=1e-5)
        for i in range(layers):
            self.add_module(f"layer_{i}", CLIPEncoderLayer(width, heads, mlp_dim or 4 * width))
        self.post_layernorm = nn.LayerNorm(width, eps=1e-5)
        self.visual_projection = nn.Linear(width, proj_dim, bias=False)

    def forward(self, pixel_values):
        B = pixel_values.shape[0]
        x = self.patch_embedding(pixel_values.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, patches, D), row-major as the NHWC reshape
        x = torch.cat([self.class_embedding.expand(B, 1, -1), x], dim=1)
        x = self.pre_layrnorm(x + self.position_embedding)
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.visual_projection(self.post_layernorm(x[:, 0]))


def load_flax_tree(tower: CLIPVisionTower, params: Dict[str, Any]) -> CLIPVisionTower:
    """Load clip_flax params (nested dicts of numpy arrays) into ``tower`` in
    place: Dense kernels (in, out) -> Linear weights (out, in), the patch
    kernel HWIO -> OIHW, LayerNorm ``scale`` -> ``weight``. Every parameter
    must be matched."""
    sd = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                k, a = "weight", (a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
            elif k == "scale":
                k = "weight"
            sd[".".join(prefix + (k,))] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params, ())
    tower.load_state_dict(sd, strict=True)
    return tower


def preprocess(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """(K, H, W, 3) RGB [0,1] -> pixel values: shortest side to
    ``image_size`` by bilinear resize, antialiased where it shrinks as
    jax.image.resize is, centre crop, CLIP normalisation."""
    K, H, W, _ = images.shape
    s = image_size / min(H, W)
    nh, nw = max(int(round(H * s)), image_size), max(int(round(W * s)), image_size)
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=True)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    x = x[:, :, top:top + image_size, left:left + image_size].permute(0, 2, 3, 1)
    mean = x.new_tensor(CLIP_MEAN)
    std = x.new_tensor(CLIP_STD)
    return (x - mean) / std


def clip_iqa_score_fn(text_embeds: np.ndarray, prompts: Sequence[str], logit_scale: float,
                      tower: CLIPVisionTower):
    """``images (K, H, W, 3) [0,1] -> (K,)`` scores on the tower's device,
    higher better: per prompt pair (text_embeds rows [pos0, neg0, pos1,
    ...], normalised) the softmax weight of the positive prompt, brightness
    x 0.7 (eval.py:239), averaged over prompts."""
    prompts = list(prompts)
    te = torch.as_tensor(np.asarray(text_embeds, np.float32))
    scale = float(logit_scale)

    @torch.inference_mode()
    def fn(images):
        img = tower(preprocess(images.float(), tower.image_size))
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        logits = scale * img @ te.to(img.device).T  # (K, 2P)
        scores = []
        for i, name in enumerate(prompts):
            prob = torch.softmax(logits[:, 2 * i:2 * i + 2], dim=-1)[:, 0]
            scores.append(prob * 0.7 if name == "brightness" else prob)
        return torch.stack(scores).mean(dim=0)

    return fn


def load_clip_iqa_npz(path: str):
    """The converted bundle: (vision params as nested dicts, text embeddings,
    prompt names, logit scale), as clip_flax.load_clip_iqa_npz reads it."""
    with np.load(path, allow_pickle=False) as data:
        params: Dict[str, Any] = {}
        for k in data.files:
            if not k.startswith("v/"):
                continue
            node = params
            parts = k[2:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[k]
        prompts = [s for s in str(data["prompts"]).split(",") if s]
        return params, data["text_embeds"], prompts, float(data["logit_scale"])


def flatten_params(params: Dict[str, Any], prefix: str = "v") -> Dict[str, np.ndarray]:
    """Nested params -> the bundle's flat ``v/a/b`` keys."""
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out
