"""CLIP-IQA: the port's vision tower, preprocess, prompt-pair score and
bundle reader against bem_tpu's clip_flax on a tiny tower (1e-5), with
the bundle written by ``smoke.write_clip_bundle`` (bem_tpu's BEM_CLIP_NPZ
layout, seeded weights). The preprocess shrinks (antialiased, as
jax.image.resize) and grows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.enhancement import clip_flax
from bem_tpu_torch import smoke
from bem_tpu_torch.enhancement.clip import (CLIPVisionTower, clip_iqa_score_fn, flatten_params,
                                            load_clip_iqa_npz, load_flax_tree, preprocess)
from bem_tpu_torch.enhancement.clip_iqa import ClipIQA

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

TINY = dict(width=48, layers=3, patch=16, image_size=64, proj_dim=24, mlp_dim=96)
HEADS = 4
PROMPTS = ("brightness", "noisiness", "quality")


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip") / "tiny.npz"
    return str(smoke.write_clip_bundle(path, seed=3, **TINY))


def _towers(bundle):
    params, te, prompts, scale = clip_flax.load_clip_iqa_npz(bundle)
    jt = clip_flax.CLIPVisionTower(heads=HEADS, **TINY)
    pt = load_flax_tree(CLIPVisionTower(heads=HEADS, **TINY), load_clip_iqa_npz(bundle)[0])
    return params, te, prompts, scale, jt, pt.eval()


def test_bundle_round_trip(bundle):
    params, te, prompts, scale = load_clip_iqa_npz(bundle)
    jparams, jte, jprompts, jscale = clip_flax.load_clip_iqa_npz(bundle)
    assert prompts == jprompts == list(PROMPTS) and scale == jscale == 100.0
    np.testing.assert_array_equal(te, jte)
    ours, theirs = flatten_params(params), clip_flax.flatten_params(jparams)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_vision_tower_matches_clip_flax(bundle):
    params, _, _, _, jt, pt = _towers(bundle)
    x = np.random.default_rng(0).standard_normal((3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pt(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(100, 150), (40, 50), (64, 64), (90, 61)])
def test_preprocess_matches_clip_flax(shape):
    imgs = np.random.default_rng(1).random((2, *shape, 3)).astype(np.float32)
    want = np.asarray(clip_flax.preprocess(jnp.asarray(imgs), 64))
    got = preprocess(torch.from_numpy(imgs), 64).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prompts", [PROMPTS, ("quality", "brightness")])
def test_score_fn_matches_clip_flax(bundle, prompts):
    params, te, avail, scale, jt, pt = _towers(bundle)
    idx = [j for p in prompts for j in (2 * avail.index(p), 2 * avail.index(p) + 1)]
    imgs = np.random.default_rng(2).random((4, 80, 120, 3)).astype(np.float32)
    want = np.asarray(jax.jit(clip_flax.clip_iqa_score_fn(te[idx], prompts, scale, tower=jt))(
        params, jnp.asarray(imgs)))
    got = clip_iqa_score_fn(te[idx], prompts, scale, pt)(torch.from_numpy(imgs)).numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_clip_iqa_refuses_without_bundle_or_prompt(bundle, tmp_path, monkeypatch):
    monkeypatch.setenv("BEM_CLIP_NPZ", str(tmp_path / "missing.npz"))
    with pytest.raises(RuntimeError, match="BEM_CLIP_NPZ"):
        ClipIQA(device="cpu")
    with pytest.raises(KeyError, match="unknown CLIP-IQA prompts"):
        ClipIQA(("crispness",), device="cpu")
    monkeypatch.setenv("BEM_CLIP_NPZ", bundle)
    with pytest.raises(RuntimeError, match="not in converted bundle"):
        ClipIQA(("sharpness",), device="cpu")
