"""The flagship's training settings: one ImageEnhancer train step of the
port vs bem_tpu's, same weights, noise, mixup weight and mask.

The flagship (DecompDualBranchDDWavelet, n_feat 8, blocks (1,1,1), QD
model4 frozen, 16x16, B=2) with the perceptual loss (VGG19 conv5_4 at 0.01,
the random features of ``BEM_ALLOW_RANDOM_VGG=1``, which both packages draw
alike), the MIM mask (ratio 0.75, patch 1; the Decomp archs take it and
ignore it) and mixup (``use_identity`` set: read and unused, as in
bem_tpu). bem_tpu runs its XLA scan backend; its condition noise and lam
are the draws its step makes from its state rng, injected into the port.
The comparison is test_torch_train.py's: loss within 1e-5 relative, every
gradient leaf within 1e-3 of its largest entry, the updated params; the
frozen ``decomp`` gets no gradient. The mask on a ``Network`` and the
ConditionGenerator: test_torch_mim_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.models import build_model as jax_build_model
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.models import build_model
from bem_tpu_torch.utils.mask import MaskGenerator

from test_trainers import make_batch, make_opt
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_train import _capture_jax_grads, _capture_port_grads, _compare_step

FLAGSHIP = dict(type="DecompDualBranchDDWavelet", in_channels=6, out_channels=3, n_feat=8,
                num_blocks=(1, 1, 1), d_state=1, ssm_ratio=1, mlp_ratio=4, mlp_type="gdmlp",
                use_pixelshuffle=True, decomp_model="model4")
PERCEPTUAL = dict(type="PerceptualLoss", layer_weights={"conv5_4": 1}, vgg_type="vgg19",
                  use_input_norm=True, range_norm=False, perceptual_weight=0.01,
                  style_weight=0, criterion="l1")
MIXUP = {"mixup": True, "mixup_beta": 1.2, "use_identity": True}


@pytest.fixture(autouse=True)
def random_vgg(monkeypatch, tmp_path):
    monkeypatch.delenv("BEM_VGG19_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("BEM_ALLOW_RANDOM_VGG", "1")


def _setup(model_type, network_g, hw, **train):
    popt = make_opt(model_type)
    if network_g:
        popt["network_g"] = network_g
    popt["train"].update(train)
    net_opt = dict(popt["network_g"])
    if model_type == "ConditionGenerator":
        net_opt.update(bayesian=True, sigma_init=0.05)
    net = build_network(net_opt, torch.Generator().manual_seed(0))
    if hasattr(net, "load_frozen"):
        net.load_frozen()
    params0 = state_dict_to_flax(net)
    params0 = jax.tree_util.tree_map(np.array, params0)
    jopt = make_opt(model_type)
    jopt["network_g"] = dict(popt["network_g"], scan_backend="xla")
    jopt["train"].update(train)
    jm = jax_build_model(jopt)
    rng = np.random.default_rng(0)
    batch = make_batch(rng, H=hw, W=hw, down=4)
    size = hw if model_type == "ImageEnhancer" else hw // 4
    gen = MaskGenerator(size, 1, 1, 0.75, rng)
    batch["mask"] = np.stack([gen(), gen()])
    jm._init_variables = lambda rng, batch: {"params": params0}
    jm.init_state(batch, seed=0)
    _capture_jax_grads(jm)
    pm = build_model(popt, device="cpu", net=net)
    # the draws bem_tpu's step makes (image_enhancer_model.py:64-71)
    _, noise_rng, mix_rng = jax.random.split(jm.state.rng, 3)
    lam = np.float32(jax.random.beta(mix_rng, 1.2, 1.2))
    return batch, jm, pm, params0, noise_rng, lam


def test_flagship_step_matches_jax():
    batch, jm, pm, params0, noise_rng, lam = _setup(
        "ImageEnhancer", FLAGSHIP, 16, perceptual_opt=PERCEPTUAL, mixing_augs=MIXUP)
    assert pm._use_mask(batch) and jm._use_mask(batch)
    noise = np.asarray(jax.random.normal(noise_rng, batch["gt_down"].shape, jnp.float32))
    jlogs = jm.train_step(batch)
    pgrads = _capture_port_grads(pm)
    plogs = pm.train_step(batch, noise=torch.from_numpy(noise.copy()), lam=lam)
    assert float(plogs["l_percep"]) == pytest.approx(float(jlogs["l_percep"]), rel=1e-5)
    _compare_step(jm, pm, jlogs, plogs, pgrads, params0)
    assert pm.optimizer.frozen and all(not pgrads[k].any() for k in pm.optimizer.frozen)
