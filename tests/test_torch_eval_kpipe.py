"""The stochastic K-candidate pipeline: the port's ``make_k_pipeline`` vs
bem_tpu's (K=4 Bayesian CG samples, the IE in chunks of 3, condition noise,
with and without the GT-mean rescale), same weights and noise.

The K weight samples' eps is numpy-seeded and injected into both:
bem_tpu's ``_bayes_weight`` is monkeypatched (as in test_torch_train.py)
to read sample k's eps, k found by matching the vmapped per-sample key
against the K keys bem_tpu splits; the condition noise is bem_tpu's own
normal draw, handed to the port. Candidates within 1e-4; the same
candidate wins on PSNR.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bem_tpu.nn.layers as jlayers
from bem_tpu.archs import build_network as jax_build
from bem_tpu.enhancement.eval import make_k_pipeline as jax_k_pipeline
from bem_tpu.ops.resize import resize_bilinear as jax_resize
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.enhancement.eval import make_k_pipeline
from bem_tpu_torch.metrics.psnr_ssim import calculate_psnr

from test_torch_eval_cli import one_torch_thread  # noqa: F401  (an autouse fixture)

K, P, NOISE = 4, 3, 0.1
H, W = 64, 128
CFG = dict(type="Network", out_channels=3, n_feat=8, num_blocks=(1, 1), d_state=(1, 1),
           ssm_ratio=1, mlp_ratio=2, use_pixelshuffle=True)


@pytest.mark.parametrize("use_gt_mean", [False, True])
def test_k_candidates_match_bem_tpu(monkeypatch, use_gt_mean):
    cg = build_network(dict(CFG, in_channels=3, bayesian=True, sigma_init=0.05),
                       torch.Generator().manual_seed(0)).eval()
    ie = build_network(dict(CFG, in_channels=6), torch.Generator().manual_seed(1)).eval()
    jcg = jax_build(dict(CFG, in_channels=3, bayesian=True, scan_backend="xla"))
    jie = jax_build(dict(CFG, in_channels=6, scan_backend="xla"))

    rng = np.random.default_rng(7)
    eps = [{k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            for k, p in cg.named_parameters() if k.rpartition(".")[2].startswith("mu_")}
           for _ in range(K)]
    eps_trees = [state_dict_to_flax(cg, e) for e in eps]
    eps_tree = jax.tree_util.tree_map(lambda *a: np.stack(a), *eps_trees)
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, K + 1)
    sample_keys = jnp.asarray(jax.random.key_data(keys[1:]))

    def bayes_weight(self, name, init_fn, shape, sigma_init):
        mu = self.param(f"mu_{name}", init_fn, shape)
        rho = self.param(f"rho_{name}", jlayers.inits.constant(
            jlayers.rho_from_sigma(sigma_init)), shape)
        if not self.has_rng("bayes"):
            return mu
        root = self.scope.rngs["bayes"]
        root = jax.random.key_data(getattr(root, "rng", root))
        k = jnp.argmax(jnp.all(root[None] == sample_keys, axis=-1))
        node = eps_tree
        for part in self.scope.path:
            node = node[part]
        return mu + jlayers.softplus_sigma(rho) * jnp.asarray(node[f"mu_{name}"])[k]

    monkeypatch.setattr(jlayers._BayesParamMixin, "_bayes_weight", bayes_weight)

    img = rng.random((1, H, W, 3)).astype(np.float32)
    cond = rng.random((1, H // 16, W // 16, 3)).astype(np.float32)
    tmean = rng.random((1, 1, 1, 3)).astype(np.float32) * 0.5 + 0.25
    jk = jax_k_pipeline(jcg, state_dict_to_flax(cg), jie, state_dict_to_flax(ie), K=K, P=P,
                        cond_type="mean", noise_level=NOISE)
    want = np.asarray(jk(key, jnp.asarray(img), jnp.asarray(cond), jnp.asarray(tmean),
                         use_gt_mean=use_gt_mean, stochastic=True))
    noise = np.array(jax.random.normal(keys[0], (K, H // 16, W // 16, 3)))

    pk = make_k_pipeline(cg, ie, K=K, P=P, cond_type="mean", noise_level=NOISE)
    got = pk(None, torch.from_numpy(img), torch.from_numpy(cond), torch.from_numpy(tmean),
             use_gt_mean=use_gt_mean, stochastic=True, eps=eps,
             noise=torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (K, H, W, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the samples differ, so the selection below means something
    assert np.abs(want[0] - want[1]).max() > 1e-2
    target = np.clip(img[0] * 1.5, 0, 1) * 255
    pick = [int(np.argmax([calculate_psnr(target, np.clip(c, 0, 1) * 255, 0) for c in cands]))
            for cands in (got, want)]
    assert pick[0] == pick[1]


def test_gt_mean_keeps_a_black_channel_black():
    """A CG whose first output channel is black everywhere: bem_tpu's GT-mean
    rescale divides 0 by 0 and every candidate turns NaN; the port floors
    the mean, so the channel stays 0 and the candidates are finite: bem_tpu's
    nets with that channel left at 0 and the others rescaled (1e-4)."""
    cg = build_network(dict(CFG, in_channels=3, bayesian=True, sigma_init=0.05),
                       torch.Generator().manual_seed(0)).eval()
    ie = build_network(dict(CFG, in_channels=6), torch.Generator().manual_seed(1)).eval()
    with torch.no_grad():
        cg.proj.bias[0] = -100.0
    jcg = jax_build(dict(CFG, in_channels=3, bayesian=True, scan_backend="xla"))
    jie = jax_build(dict(CFG, in_channels=6, scan_backend="xla"))
    rng = np.random.default_rng(8)
    img = rng.random((1, H, W, 3)).astype(np.float32)
    cond = rng.random((1, H // 16, W // 16, 3)).astype(np.float32)
    tmean = np.full((1, 1, 1, 3), 0.4, np.float32)
    jk = jax_k_pipeline(jcg, state_dict_to_flax(cg), jie, state_dict_to_flax(ie), K=2, P=2,
                        cond_type="mean", noise_level=0)
    want = np.asarray(jk(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(cond),
                         jnp.asarray(tmean), use_gt_mean=True, stochastic=False))
    pk = make_k_pipeline(cg, ie, K=2, P=2, cond_type="mean", noise_level=0)
    got = pk(None, torch.from_numpy(img), torch.from_numpy(cond), torch.from_numpy(tmean),
             use_gt_mean=True, stochastic=False).numpy()
    assert np.isnan(want).all() and np.isfinite(got).all()
    # bem_tpu's own nets with the black channel's condition left at 0
    c = np.clip(np.asarray(jax.jit(jcg.apply)({"params": state_dict_to_flax(cg)}, cond)[-1]),
                0, 1)
    m = c.mean(axis=(1, 2), keepdims=True)
    assert m[..., 0] == 0 and (m[..., 1:] > 0).all()
    c = np.clip(c * (tmean / np.where(m > 0, m, 1)), 0, 1)
    x = jnp.concatenate([img, jax_resize(jnp.asarray(c), (H, W))], axis=-1)
    ref = np.asarray(jax.jit(jie.apply)({"params": state_dict_to_flax(ie)}, x)[-1])
    np.testing.assert_allclose(got, np.repeat(ref, 2, axis=0), rtol=1e-4, atol=1e-4)
