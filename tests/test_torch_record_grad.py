"""``logger.record_grad``: the port's train step logs bem_tpu's
``grads/<path>`` scalars, the mean |grad| of each parameter under
bem_tpu's path names (bem_tpu/models/base_model.py:202-210).

One ImageEnhancer train step of tests/test_torch_train.py (n_feat 8,
blocks (1,1,1), B=2, 32x32, the condition noise bem_tpu's step draws
injected into the port's), with ``record_grad`` on in both:

- the tags equal bem_tpu's, and each value is the mean |g| of the port's
  own gradient leaf (1e-6 relative) and within the gradient's tolerance
  of tests/test_torch_train.py (1e-3 of the leaf's largest entry) of
  bem_tpu's;
- bem_tpu's gradient tree handed to the port's ``_apply_updates``: each
  logged value is the leaf's exact mean |g| (1e-7 relative) and within
  2e-6 relative of bem_tpu's, whose fp32 mean is itself up to 1.04e-6
  off the exact one;
- without ``record_grad`` the port logs no such tag.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.models import build_model as jax_build_model
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from bem_tpu_torch.models import build_model

from test_trainers import make_batch, make_opt
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def _opt(record=True):
    opt = make_opt("ImageEnhancer")
    opt["logger"] = {"record_grad": record}
    return opt


def _port_model(record=True):
    net = build_network(_opt()["network_g"], torch.Generator().manual_seed(0))
    return build_model(_opt(record), device="cpu", net=net)


@pytest.fixture(scope="module")
def step():
    """(bem_tpu's logs, the port's logs, both gradient trees, the port's
    model) of one step with ``record_grad`` on."""
    batch = make_batch(np.random.default_rng(0), H=32, W=32, down=4)
    pm = _port_model()
    jopt = _opt()
    jopt["network_g"]["scan_backend"] = "xla"
    jm = jax_build_model(jopt)
    params0 = state_dict_to_flax(pm.net)
    jm._init_variables = lambda rng, batch: {"params": params0}
    jm.init_state(batch, seed=0)
    orig = jm._apply_updates

    def apply(state, g, aux):  # hand the gradient tree out with the visuals
        aux["_visual_grads"] = g
        return orig(state, g, aux)

    jm._apply_updates = apply
    _, noise_rng, _ = jax.random.split(jm.state.rng, 3)
    noise = np.asarray(jax.random.normal(noise_rng, batch["gt_down"].shape, jnp.float32))
    jlogs = jm.train_step(batch)
    grads = {"bem_tpu": jax.tree.map(np.asarray, jm.last_visuals["grads"])}
    porig = pm._apply_updates

    def papply(g, aux):
        grads["port"] = dict(g)
        return porig(g, aux)

    pm._apply_updates = papply
    plogs = pm.train_step(batch, noise=torch.from_numpy(noise.copy()))
    return jlogs, plogs, grads, pm


def _grad_tags(logs):
    return {k: float(v) for k, v in logs.items() if k.startswith("grads/")}


def test_record_grad_logs_bem_tpus_tags_and_values(step):
    jlogs, plogs, grads, pm = step
    want, got = _grad_tags(jlogs), _grad_tags(plogs)
    assert len(want) == len(list(pm.net.parameters())) > 0
    assert set(got) == set(want)
    gp = _flat(state_dict_to_flax(pm.net, grads["port"]))
    gj = _flat(grads["bem_tpu"])
    for tag, v in got.items():
        path = tag[len("grads/"):]
        assert abs(v - np.abs(gp[path]).mean()) <= 1e-6 * abs(v) + 1e-12, tag
        assert abs(v - want[tag]) <= 1e-3 * np.abs(gj[path]).max() + 1e-12, tag


def test_record_grad_values_equal_on_the_same_gradient(step):
    jlogs, _, grads, _ = step
    g = {k: torch.from_numpy(np.array(v)) for k, v in
         flax_to_state_dict(grads["bem_tpu"]).items()}
    logs = _port_model()._apply_updates(g, {})
    want, got = _grad_tags(jlogs), _grad_tags(logs)
    assert set(got) == set(want)
    gj = _flat(grads["bem_tpu"])
    for tag, v in want.items():
        exact = np.abs(gj[tag[len("grads/"):]]).mean(dtype=np.float64)
        assert abs(got[tag] - exact) <= 1e-7 * exact + 1e-12, tag
        # bem_tpu's fp32 jnp.mean is itself off the exact mean by up to
        # 1.04e-6 relative (measured, the largest leaf)
        assert abs(got[tag] - v) <= 2e-6 * abs(v) + 1e-12, tag


def test_no_grad_tags_without_record_grad(step):
    _, _, grads, _ = step
    logs = _port_model(record=False)._apply_updates(grads["port"], {})
    assert "grad_norm" in logs and not _grad_tags(logs)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}|"))
        else:
            out[prefix + k] = v
    return out
