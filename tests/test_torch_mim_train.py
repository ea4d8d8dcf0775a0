"""The MIM mask and mixup in the trainers: one train step of the port vs
bem_tpu's on a ``Network``, where the mask reaches the mask token.

- An ImageEnhancer (n_feat 8, blocks (1,1,1), 32x32, B=2) with the mask,
  mixup and the perceptual and Gram style terms (random VGG features).
- A ConditionGenerator (8x8) with the mask (at gt_size / scale_down) and
  mixup, its weight noise injected into both (test_torch_train.py's
  monkeypatch); past the scheduler's first period the mask is off.
The set-up and the comparison are test_torch_flagship_train.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bem_tpu.nn.layers as jlayers
from bem_tpu_torch.convert import state_dict_to_flax

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_flagship_train import MIXUP, PERCEPTUAL, _setup, random_vgg  # noqa: F401
from test_torch_train import _capture_port_grads, _compare_step


def test_image_enhancer_mask_step_matches_jax():
    batch, jm, pm, params0, noise_rng, lam = _setup(
        "ImageEnhancer", None, 32, perceptual_opt=dict(PERCEPTUAL, style_weight=0.5),
        mixing_augs=MIXUP)
    assert pm._use_mask(batch) and jm._use_mask(batch)
    noise = np.asarray(jax.random.normal(noise_rng, batch["gt_down"].shape, jnp.float32))
    jlogs = jm.train_step(batch)
    pgrads = _capture_port_grads(pm)
    plogs = pm.train_step(batch, noise=torch.from_numpy(noise.copy()), lam=lam)
    assert float(plogs["l_percep"]) == pytest.approx(float(jlogs["l_percep"]), rel=1e-5)
    _compare_step(jm, pm, jlogs, plogs, pgrads, params0)
    assert pgrads["mask_token"].abs().max() > 0


def test_condition_generator_step_matches_jax(monkeypatch):
    batch, jm, pm, params0, _, lam = _setup("ConditionGenerator", None, 32, mixing_augs=MIXUP)
    rng = np.random.default_rng(5)
    eps = {k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
           for k, p in pm.net.named_parameters() if k.rpartition(".")[2].startswith("mu_")}
    eps_tree = state_dict_to_flax(pm.net, eps)

    def bayes_weight(self, name, init_fn, shape, sigma_init):
        mu = self.param(f"mu_{name}", init_fn, shape)
        rho = self.param(f"rho_{name}", jlayers.inits.constant(
            jlayers.rho_from_sigma(sigma_init)), shape)
        if not self.has_rng("bayes"):
            return mu
        node = eps_tree
        for part in self.scope.path:
            node = node[part]
        return mu + jlayers.softplus_sigma(rho) * jnp.asarray(node[f"mu_{name}"])

    monkeypatch.setattr(jlayers._BayesParamMixin, "_bayes_weight", bayes_weight)
    jlogs = jm.train_step(batch)
    pgrads = _capture_port_grads(pm)
    plogs = pm.train_step(batch, eps=eps, lam=lam)
    assert float(plogs["l_kl"]) == pytest.approx(float(jlogs["l_kl"]), rel=1e-5, abs=1e-7)
    _compare_step(jm, pm, jlogs, plogs, pgrads, params0)
    # past the first scheduler period (5) the mask is off in both
    pm.step = 6
    assert not pm._use_mask(batch)
