"""The serving pipeline end to end: the port vs a bem_tpu reference.

The reference is bench.py's pipeline body (bench.py:141-167) written out
with bem_tpu modules, fed the port's Bayesian weight samples (converted to
flax params) so both sides see the same K condition-generator weights.
Sizes: 112x176 images padded to 128x192, K=2, two images, small nets,
fp32. NIQE scores must agree within 0.05 and pick the same candidates.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu.metrics.niqe_jax import niqe_batch_rgb as jax_niqe
from bem_tpu.ops.resize import resize_bilinear as jax_resize
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.enhancement.pipeline import (build_pipeline, flagship_config,
                                                padded_size)
from bem_tpu_torch.metrics.niqe import niqe_batch_rgb
from bem_tpu_torch.nn import sample_bayes
from bem_tpu_torch.ops import resize_bilinear

H, W, K, NIMG = 112, 176, 2, 2


def test_port_imports_no_jax():
    code = ("import sys, bem_tpu_torch.enhancement.pipeline, bem_tpu_torch.smoke, "
            "bem_tpu_torch.models, bem_tpu_torch.train, bem_tpu_torch.ops.scan; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'bem_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("src,dst", [((28, 40), (448, 640)), ((7, 11), (14, 22))])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(0).random((2, *src, 3)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), size=dst))
    out = resize_bilinear(torch.from_numpy(x), size=dst).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_niqe_matches_jax():
    rng = np.random.default_rng(1)
    base = rng.random((4, 1, 1, 3)) * 0.6 + 0.2
    yy, xx = np.mgrid[0:200, 0:290] / 40.0
    imgs = base + 0.2 * np.sin(yy + xx)[None, ..., None] * rng.random((4, 1, 1, 3)) \
        + 0.05 * rng.standard_normal((4, 200, 290, 3))
    imgs = np.clip(imgs, 0, 1).astype(np.float32)
    ref = np.asarray(jax.jit(jax_niqe(200, 290, round_rgb=False))(jnp.asarray(imgs)))
    out = niqe_batch_rgb(200, 290)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(out, ref, atol=0.05)


def test_pipeline_matches_jax_reference():
    cfg = dict(flagship_config(n_feat=8, num_blocks=(1, 1, 1)))
    Hp, Wp = padded_size(H, W)
    hc, wc = Hp // 16, Wp // 16
    rng = np.random.default_rng(0)
    img = rng.random((NIMG, Hp, Wp, 3)).astype(np.float32)
    cond = rng.random((NIMG, hc, wc, 3)).astype(np.float32)

    jcg = jax_build(dict(cfg, in_channels=3, out_channels=3, bayesian=True, scan_backend="xla"))
    jie = jax_build(dict(cfg, in_channels=6, out_channels=3, scan_backend="xla"))
    cg_v = jax.jit(jcg.init)(jax.random.PRNGKey(0), jnp.asarray(cond[:1]))
    ie_v = jax.jit(jie.init)(jax.random.PRNGKey(1), jnp.zeros((1, Hp, Wp, 6)))
    cg = load_flax_params(build_network(dict(cfg, in_channels=3, out_channels=3,
                                             bayesian=True)), cg_v)
    ie = load_flax_params(build_network(dict(cfg, in_channels=6, out_channels=3)), ie_v)

    pipe = build_pipeline(nimg=NIMG, K=K, device="cpu", dtype=torch.float32, H=H, W=W,
                          nets=(cg, ie))
    sel, best, scores = pipe(torch.Generator().manual_seed(5), torch.from_numpy(img),
                             torch.from_numpy(cond))
    assert sel.shape == (NIMG, H, W, 3) and best.shape == (NIMG,)

    # bench.py:141-167 with the same K weight samples, drawn again from the
    # same seed, for bem_tpu
    gen = torch.Generator().manual_seed(5)
    samples = [state_dict_to_flax(cg, sample_bayes(cg, gen)) for _ in range(K)]
    cg_apply = jax.jit(lambda p, x: jcg.apply({"params": p}, x)[-1])
    conds = jnp.stack([cg_apply(p, jnp.asarray(cond)) for p in samples])

    @jax.jit
    def stage2(conds, img):
        conds = jnp.clip(conds, 0.0, 1.0).reshape(K * NIMG, hc, wc, 3)
        up = jax_resize(conds, size=(Hp, Wp))
        inp = jnp.concatenate([jnp.broadcast_to(img[None], (K, NIMG, Hp, Wp, 3))
                               .reshape(K * NIMG, Hp, Wp, 3), up], axis=-1)
        preds = jie.apply(ie_v, inp)[-1]
        cand = jnp.clip(preds.reshape(K, NIMG, Hp, Wp, 3)[:, :, :H, :W, :], 0.0, 1.0)
        scores = jax_niqe(H, W, round_rgb=False)(cand.reshape(K * NIMG, H, W, 3))
        return cand, scores.reshape(K, NIMG)

    cand, ref_scores = stage2(conds, jnp.asarray(img))
    ref_best = np.asarray(jnp.argmin(ref_scores, axis=0))

    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=0.05)
    np.testing.assert_array_equal(best.numpy(), ref_best)
    ref_sel = np.asarray(cand)[ref_best, np.arange(NIMG)]
    np.testing.assert_allclose(sel.numpy(), ref_sel, rtol=1e-3, atol=1e-3)
