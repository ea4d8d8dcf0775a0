"""The K-sharded eval: the K=16 Monte-Carlo samples over 4 gloo ranks
(``--shard_samples on``), against the port's unsharded run and bem_tpu's
``make_k_pipeline(shard=True)`` on its virtual mesh.

- ``make_k_pipeline`` with every draw from the generator (weights, then
  the condition noise; each rank makes all K and keeps its own): the 16
  candidates bit-identical to the unsharded pipeline's (the CPU's plain
  versions are batch-independent).
- The same with the weight noise injected and bem_tpu's condition noise
  handed in (as test_torch_eval_kpipe.py does): the candidates within
  1e-4 of bem_tpu's sharded pipeline, and the same NIQE pick.
- The eval CLI's ``main`` with ``--shard_samples on`` on 4 ranks against
  ``--shard_samples off`` in one process (NIQE, K=16, noise 0.1, two
  128x128 images): the same picks and scores, the written PNGs
  byte-identical; rank 0 alone returns and writes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bem_tpu.nn.layers as jlayers
from bem_tpu.archs import build_network as jax_build
from bem_tpu.enhancement.eval import make_k_pipeline as jax_k_pipeline
from bem_tpu.metrics.niqe_jax import niqe_batch_rgb as jax_niqe
from bem_tpu.utils.checkpoint import save_params
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.enhancement import eval as port_eval
from bem_tpu_torch.metrics.niqe import niqe_batch_rgb
from bem_tpu_torch.parallel import spawn
from bem_tpu_torch.utils.img_util import imwrite

import torch_parallel_workers as workers
from test_eval_cli import CG_YML, IE_YML
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

N, K, NOISE = 4, 16, 0.05
H = W = 96
COMMON = dict(type="Network", out_channels=3, n_feat=8, stage=1, num_blocks=(1, 1),
              d_state=(1, 1), ssm_ratio=1, mlp_ratio=2, use_pixelshuffle=True)
CFGS = (dict(COMMON, in_channels=3, bayesian=True, sigma_init=0.05), dict(COMMON, in_channels=6))


def _main_args(root, out, extra):
    return ["--opt", str(root / "cg.yml"), "--cond_opt", str(root / "ie.yml"),
            "--weights", str(root / "cg.msgpack"), "--cond_weights", str(root / "ie.msgpack"),
            "--input_dir", str(root / "input"), "--result_dir", str(root / out),
            "--num_samples", str(K), "--no_ref", "niqe", "--device", "cpu"] + extra


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("kshard")
    rng = np.random.default_rng(3)
    os.makedirs(root / "input")
    for i in range(2):
        imwrite((rng.random((128, 128, 3)) * 120).astype(np.uint8),
                str(root / "input" / f"{i}.png"))
    (root / "cg.yml").write_text(CG_YML.format())
    (root / "ie.yml").write_text(IE_YML.format())
    for name, cfg, seed in (("cg", CFGS[0], 0), ("ie", CFGS[1], 1)):
        save_params(str(root / f"{name}.msgpack"),
                    state_dict_to_flax(build_network(cfg, torch.Generator().manual_seed(seed))))
    cg = build_network(CFGS[0], torch.Generator().manual_seed(0))
    eps = [{k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            for k, p in cg.named_parameters() if k.rpartition(".")[2].startswith("mu_")}
           for _ in range(K)]
    img = rng.random((1, H, W, 3)).astype(np.float32)
    cond = rng.random((1, H // 16, W // 16, 3)).astype(np.float32)
    tmean = np.ones((1, 1, 1, 3), np.float32)
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.normal(jax.random.split(key, K + 1)[0], (K, H // 16, W // 16, 3)))
    res = spawn(workers.eval_k, N, args=(CFGS, K, img, cond, tmean, eps, NOISE, noise,
                                         _main_args(root, "sharded", ["--shard_samples", "on"])))
    return root, eps, img, cond, tmean, key, noise, res


def _nets():
    return (build_network(CFGS[0], torch.Generator().manual_seed(0)).eval(),
            build_network(CFGS[1], torch.Generator().manual_seed(1)).eval())


def test_drawn_candidates_bit_identical_to_unsharded(ranks):
    _, _, img, cond, tmean, _, _, res = ranks
    cg, ie = _nets()
    pk = port_eval.make_k_pipeline(cg, ie, K=K, P=2, cond_type="mean", noise_level=NOISE)
    want = pk(torch.Generator().manual_seed(5), torch.from_numpy(img), torch.from_numpy(cond),
              torch.from_numpy(tmean), use_gt_mean=False, stochastic=True).numpy()
    assert want.shape == (K, H, W, 3)
    for out in res:  # every rank holds all K, gathered in sample order
        np.testing.assert_array_equal(out["drawn"], want)


def test_injected_candidates_and_pick_match_bem_tpu(ranks, monkeypatch):
    _, eps, img, cond, tmean, key, _, res = ranks
    cg, ie = _nets()
    eps_tree = jax.tree_util.tree_map(lambda *a: np.stack(a),
                                      *[state_dict_to_flax(cg, e) for e in eps])
    sample_keys = jnp.asarray(jax.random.key_data(jax.random.split(key, K + 1)[1:]))

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
    jk = jax_k_pipeline(jax_build(dict(CFGS[0], scan_backend="xla")), state_dict_to_flax(cg),
                        jax_build(dict(CFGS[1], scan_backend="xla")), state_dict_to_flax(ie),
                        K=K, P=4, cond_type="mean", noise_level=NOISE, shard=True)
    want = np.asarray(jk(key, jnp.asarray(img), jnp.asarray(cond), jnp.asarray(tmean),
                         False, True))
    got = res[0]["injected"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(want[0] - want[1]).max() > 1e-2  # the samples differ
    s_port = niqe_batch_rgb(H, W)(torch.from_numpy(got).clamp(0, 1)).numpy()
    s_jax = np.asarray(jax.jit(jax_niqe(H, W))(jnp.clip(jnp.asarray(want), 0.0, 1.0)))
    assert int(np.argmin(s_port)) == int(np.argmin(s_jax))


def test_eval_cli_shard_samples_on_matches_off(ranks):
    root, *_, res = ranks
    want = port_eval.main(_main_args(root, "unsharded", ["--shard_samples", "off"]))
    got = res[0]["main"]
    assert all(out["main"] is None for out in res[1:])
    assert got["selected"] == want["selected"]
    assert got["scores"] == want["scores"] and got["niqe"] == want["niqe"]
    for i in range(2):
        a = (root / "sharded" / "dataset" / f"{i}.png").read_bytes()
        assert a == (root / "unsharded" / "dataset" / f"{i}.png").read_bytes()
    assert sorted(os.listdir(root / "sharded" / "dataset")) == ["0.png", "1.png", "result.txt"]
    assert "running time" in res[0]["log"] and not any(out["log"] for out in res[1:])
