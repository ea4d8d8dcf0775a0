"""The classification harness: the port's trainer vs bem_tpu's make_trainer.

- One train step of a narrow VSSM (embed 16, depths (1,1), d_state 4,
  forward_type v2, 32x32, B=2, so bem_tpu takes the clamped grouped core
  and its unclamped VJP) from the port's seeded weights, converted to flax
  params: loss within 1e-5 relative, every gradient leaf within 1e-3 of
  the leaf's largest entry, the updated params within 1e-6 where the
  gradient is clearly nonzero (Adam's first step is lr * sign(g) there) and
  within one step (2 lr) elsewhere. bem_tpu runs its Pallas kernels in
  interpret mode; drop-path is off (rate 0), since the frameworks draw
  different random numbers.
- eval_step's top-1 / top-5 on the same batch.
- The schedule vs optax.warmup_cosine_decay_schedule.
- The default config tree vs bem_tpu's get_config(), and merge_from_list.
- drop_path with a given mask vs bem_tpu's DropPath (the same mask).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bem_tpu.classification.config import get_config as jax_get_config
from bem_tpu.classification.train import build_model_from_config as jax_build
from bem_tpu.classification.train import cross_entropy as jax_ce
from bem_tpu.classification.train import make_trainer as jax_make_trainer
from bem_tpu.nn.layers import DropPath as JaxDropPath
from bem_tpu_torch.classification import (build_model_from_config, cross_entropy, get_config,
                                          make_trainer, synthetic_batch,
                                          warmup_cosine_decay_schedule)
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.nn.layers import drop_path

from test_torch_train import _flat

LR = 1e-3
REPO = Path(__file__).resolve().parents[1]


def _narrow(cfg, forward_type="v2"):
    v = cfg.MODEL.VSSM
    v.EMBED_DIM, v.DEPTHS, v.SSM_D_STATE, v.SSM_RATIO = 16, [1, 1], 4, 1.0
    v.SSM_FORWARDTYPE = forward_type
    cfg.DATA.IMG_SIZE, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DROP_PATH_RATE = 32, 10, 0.0
    return cfg


def run_train_step(forward_type="v2"):
    """One train step and an eval of the narrow VSSM with ``forward_type``
    on both sides, from the port's seeded weights."""
    rng = np.random.default_rng(0)
    images = rng.random((2, 32, 32, 3), np.float32)
    labels = np.array([3, 7])
    model = build_model_from_config(_narrow(get_config(), forward_type),
                                    torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(model))
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}

    jm = jax_build(_narrow(jax_get_config(), forward_type)).clone(scan_backend="pallas")
    jstate, jstep, jeval = jax_make_trainer(jm, images[:1], total_steps=10, base_lr=LR,
                                            warmup_steps=2, seed=0)
    jstate = jstate.replace(params=params)
    jstate, jloss = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
    jtop = jeval(jstate.params, jnp.asarray(images), jnp.asarray(labels))
    # the step's gradient, from Adam's first moment after one update: mu =
    # (1 - b1) g, with g unclipped while its norm stays under 5 (checked below)
    adam = next(x for x in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu"))
    jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, adam.mu)

    state, step, evaluate = make_trainer(model, total_steps=10, base_lr=LR, warmup_steps=2,
                                         device="cpu")
    grads = {}
    opt_step = state.optimizer.step
    state.optimizer.step = lambda p, g: (grads.update(g), opt_step(p, g))[1]
    state, loss = step(state, images, labels)
    top = evaluate(state, images, labels)
    return dict(jloss=float(jloss), loss=float(loss), grad_norm=float(state.logs["grad_norm"]),
                jgrads=_flat(jgrads), grads=_flat(state_dict_to_flax(model, grads)),
                jparams=_flat(jstate.params), params=_flat(state_dict_to_flax(model)),
                p0=_flat(state_dict_to_flax(model, p0)), jtop=tuple(map(float, jtop)),
                top=tuple(map(float, top)), lr=state.logs["lr"])


@pytest.fixture(scope="module")
def step_results():
    return run_train_step("v2")


def check_loss_and_gradients(r):
    assert r["grad_norm"] < 5.0  # below the clip: Adam's mu holds the raw gradient
    assert abs(r["loss"] - r["jloss"]) <= 1e-5 * abs(r["jloss"])
    assert r["grads"].keys() == r["jgrads"].keys()
    for k, jg in r["jgrads"].items():
        err = np.abs(r["grads"][k] - jg).max()
        assert err <= 1e-3 * max(np.abs(jg).max(), 1e-30), (k, err, np.abs(jg).max())


def check_updates(r):
    lr = r["lr"]
    assert lr == pytest.approx(0.0)  # warmup from 0: the first update's lr is schedule(0)
    for k, jp in r["jparams"].items():
        p, g = r["params"][k], r["jgrads"][k]
        moved = np.abs(p - jp)
        clear = np.abs(g) > 1e-2 * np.abs(g).max()
        if clear.any():
            assert (moved[clear] / (1 + np.abs(jp[clear]))).max() <= 1e-6, k
        assert (moved <= 2 * LR * (1 + 1e-4 * np.abs(r["p0"][k])) + 1e-6).all(), k


def test_train_step_loss_and_gradients(step_results):
    check_loss_and_gradients(step_results)


def test_train_step_updates_params(step_results):
    check_updates(step_results)


def test_eval_step_top1_top5(step_results):
    assert step_results["top"] == pytest.approx(step_results["jtop"])


def test_cross_entropy_matches():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 10)).astype(np.float32)
    labels = np.array([0, 3, 9, 3])
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels), 0.1))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), 0.1))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("warmup,total", [(1, 2), (5, 40), (200180, 3003000)])
def test_schedule_matches_optax(warmup, total):
    want = optax.warmup_cosine_decay_schedule(0.0, 5e-4, warmup, total)
    got = warmup_cosine_decay_schedule(0.0, 5e-4, warmup, total)
    for step in sorted({0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total,
                        total + 5}):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-5, abs=1e-12), step


def test_config_tree_matches():
    assert get_config() == jax_get_config()
    opts = ["TRAIN.BASE_LR", "1e-3", "MODEL.VSSM.DEPTHS", "[1, 1]", "MODEL.VSSM.GMLP", "true",
            "MODEL.VSSM.SSM_FORWARDTYPE", "v05_noz", "DATA.BATCH_SIZE", "64"]
    a, b = get_config(), jax_get_config()
    a.merge_from_list(opts)
    b.merge_from_list(opts)
    assert a == b and a.MODEL.VSSM.DEPTHS == [1, 1] and a.TRAIN.BASE_LR == 1e-3


@pytest.mark.parametrize("key,value", [("SSM_DROP_RATE", "0.1"), ("MLP_DROP_RATE", "0.1"),
                                       ("SSM_INIT", "v1"), ("POSEMBED", "true")])
def test_build_refuses_settings_not_ported(key, value):
    """Settings the port lacks raise in one place instead of being ignored."""
    cfg = _narrow(get_config())
    cfg.merge_from_list([f"MODEL.VSSM.{key}", value])
    with pytest.raises(NotImplementedError, match=key):
        build_model_from_config(cfg)


def test_drop_path_with_given_mask():
    """Per-sample x / keep or 0, with bem_tpu's mask fed to the port."""
    x = np.random.default_rng(2).standard_normal((8, 3, 4, 5)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = JaxDropPath(0.3).apply({}, jnp.asarray(x), rngs={"dropout": key})
    # the mask bem_tpu drew: the samples its output kept
    drawn = np.asarray(want).reshape(8, -1).any(-1)
    assert 0 < drawn.sum() < 8
    got = drop_path(torch.from_numpy(x), 0.3, mask=torch.from_numpy(drawn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert torch.equal(drop_path(torch.from_numpy(x), 0.3), torch.from_numpy(x))  # eval
    gen = torch.Generator().manual_seed(0)
    kept = drop_path(torch.ones(4000, 1), 0.3, gen=gen)
    assert set(torch.unique(kept).tolist()) <= {0.0, torch.tensor(1 / 0.7).item()}
    assert abs((kept > 0).float().mean().item() - 0.7) < 0.03


def test_synthetic_batch_shapes():
    cfg = _narrow(get_config())
    images, labels = synthetic_batch(cfg, torch.Generator().manual_seed(0), batch_size=3)
    assert images.shape == (3, 32, 32, 3) and labels.shape == (3,)
    assert 0 <= images.min() and images.max() < 1 and labels.max() < 10


def test_classifier_imports_no_jax():
    code = ("import sys, chip_smoke, bem_tpu_torch.classification, bem_tpu_torch.nn.vssm, "
            "bem_tpu_torch.profile_classify; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'bem_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=REPO)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device, or chip_smoke.py alone without the package: a
    non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env, timeout=120,
                           capture_output=True, text=True)
        assert r.returncode != 0 and '"ok"' not in r.stdout, (cwd, r.returncode, r.stdout)
