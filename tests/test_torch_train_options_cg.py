"""One ConditionGenerator train step with option set (b) against
bem_tpu's: a Bayesian FFNv02 net with SAM (a 16x16 input: SAM's quarter
scale needs the 4x4 bottleneck), TrueCosineAnnealingLR, PSNRLoss; n_feat 8,
blocks (1,1,1), B=2. The weight noise is injected into both (bem_tpu's
``_bayes_weight`` reads it, as in test_torch_mim_train.py); the comparison
is test_torch_train.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bem_tpu.nn.layers as jlayers
from bem_tpu_torch.convert import state_dict_to_flax

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_flagship_train import _setup
from test_torch_train import _capture_port_grads, _compare_step
from test_trainers import make_opt


def test_option_set_b_step_matches_bem_tpu(monkeypatch):
    net = dict(make_opt("ConditionGenerator")["network_g"], mlp_type="ffnv02", sam=True)
    batch, jm, pm, params0, _, _ = _setup(
        "ConditionGenerator", net, 64, scheduler=dict(type="TrueCosineAnnealingLR", T_max=8,
                                                      eta_min=1e-6),
        pixel_opt=dict(type="PSNRLoss", loss_weight=1.0))
    batch.pop("mask")
    rng = np.random.default_rng(5)
    eps = {k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
           for k, p in pm.net.named_parameters() if k.rpartition(".")[2].startswith("mu_")}
    assert any(".mlp.net_2." in k for k in eps)  # the Bayesian depthwise conv
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
    plogs = pm.train_step(batch, eps=eps)
    assert float(plogs["l_kl"]) == pytest.approx(float(jlogs["l_kl"]), rel=1e-5, abs=1e-7)
    _compare_step(jm, pm, jlogs, plogs, pgrads, params0)
