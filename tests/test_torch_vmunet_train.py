"""One ImageEnhancer train step of the TwoBranch option files, the port vs
bem_tpu's trainer, same weights, noise and mask.

``Options/TwoBranch_1.yml`` (TunedModel) and ``_3.yml`` (FusedTunedModel),
narrowed to n_feat 8, blocks (1,1,1), B=2, 16x16, with the files'
perceptual term (VGG19 conv5_4 at 0.01, the random features of
``BEM_ALLOW_RANDOM_VGG=1``), mixup off as the files set it, and the MIM
mask (ratio 0.75, patch 1; the archs take it and ignore it). bem_tpu runs
its XLA scan backend; its condition noise is the draw its step makes from
its state rng, injected into the port. The comparison is
test_torch_train.py's: loss within 1e-5 relative, every gradient leaf
within 1e-3 of its largest entry, the updated params. TwoBranch_2 / _4
differ from these in their name alone (test_torch_vmunet_archs.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu_torch.utils.options import parse

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_flagship_train import _setup, random_vgg  # noqa: F401  (fixture)
from test_torch_train import _capture_port_grads, _compare_step


@pytest.mark.parametrize("n", [1, 3])
def test_two_branch_step_matches_jax(n):
    opt = parse(f"Options/TwoBranch_{n}.yml", is_train=True)
    network_g = dict(opt["network_g"], n_feat=8, num_blocks=[1, 1, 1])
    batch, jm, pm, params0, noise_rng, _ = _setup(
        "ImageEnhancer", network_g, 16, perceptual_opt=opt["train"]["perceptual_opt"],
        mixing_augs=opt["train"]["mixing_augs"])
    assert pm._use_mask(batch) and jm._use_mask(batch)
    noise = np.asarray(jax.random.normal(noise_rng, batch["gt_down"].shape, jnp.float32))
    jlogs = jm.train_step(batch)
    pgrads = _capture_port_grads(pm)
    plogs = pm.train_step(batch, noise=torch.from_numpy(noise.copy()))
    assert float(plogs["l_percep"]) == pytest.approx(float(jlogs["l_percep"]), rel=1e-5)
    _compare_step(jm, pm, jlogs, plogs, pgrads, params0)
