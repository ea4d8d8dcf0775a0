"""One ImageEnhancer train step with option set (a) against bem_tpu's:
conv down / up sampling, drop-path 0.1 (off in both trainers: bem_tpu's
step passes no "dropout" rng), relu last, Adam, MultiStepRestartLR after a
2-step warm-up, CombinedLoss (the random VGG19 features of
``BEM_ALLOW_RANDOM_VGG=1``, drawn alike in both packages). n_feat 8, blocks
(1,1,1), 32x32, B=2; bem_tpu's condition noise injected into the port. The
set-up and the comparison are test_torch_flagship_train.py's and
test_torch_train.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_flagship_train import _setup, random_vgg  # noqa: F401  (random_vgg: autouse)
from test_torch_train import _capture_port_grads, _compare_step
from test_trainers import make_opt


def test_option_set_a_step_matches_bem_tpu():
    net = dict(make_opt("ImageEnhancer")["network_g"], use_pixelshuffle=False, drop_path=0.1,
               last_act="relu")
    batch, jm, pm, params0, noise_rng, _ = _setup(
        "ImageEnhancer", net, 32, optim_g=dict(type="Adam", lr=2e-4, weight_decay=1e-4,
                                                betas=[0.9, 0.999]),
        warmup_iter=2, scheduler=dict(type="MultiStepRestartLR", milestones=[3, 6],
                                      restarts=[0, 5], restart_weights=[1, 0.5]),
        pixel_opt=dict(type="CombinedLoss", loss_weight=1.0))
    noise = np.asarray(jax.random.normal(noise_rng, batch["gt_down"].shape, jnp.float32))
    batch.pop("mask")
    jlogs = jm.train_step(batch)
    pgrads = _capture_port_grads(pm)
    plogs = pm.train_step(batch, noise=torch.from_numpy(noise.copy()))
    assert pm.optimizer.kind == "Adam" and pm.optimizer.weight_decay == 0.0
    _compare_step(jm, pm, jlogs, plogs, pgrads, params0)
