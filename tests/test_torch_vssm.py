"""The VMamba classifier (VSSM, forward_type v2): the port's logits vs bem_tpu's.

Narrow width (embed 16, depths (1,1), 32x32 images, 5 classes, drop-path
off), bem_tpu with scan_backend="pallas", so its SS2Ds take the fused-core
branch (ss2d.py:440-482) in Pallas interpret mode:

- B=1: pick_group is 1, the unclamped core (kernel 8). bem_tpu's own
  initialized params loaded into the port (convert.load_flax_params,
  strict over every leaf);
- B=2 at d_inner <= 128: pick_group is 2, the clamped core (kernel 10), with
  every third channel's dt bias at +12 so the clamp bites; the port's
  seeded weights converted to flax params;
- (test_torch_vssm_bf16.py) the bf16 stream of the throughput probe.

Tolerances: fp32 logits within 1e-5 of their largest entry (sums in another
order through 2 stages); bf16 within 2 bf16 ulps of it (2^-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.nn.vssm import VSSM as JaxVSSM
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.nn import init
from bem_tpu_torch.nn.ss2d import SS2D
from bem_tpu_torch.nn.vssm import VSSM

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def narrow(**kw):
    return dict(dict(depths=(1, 1), dims=16, num_classes=5, drop_path_rate=0.0,
                     forward_type="v2", patchembed_version="v2", downsample_version="v2"), **kw)


def images(B, seed=1):
    return np.random.default_rng(seed).random((B, 32, 32, 3)).astype(np.float32)


def jax_logits(kw, params, x, dtype=jnp.float32):
    jm = JaxVSSM(scan_backend="pallas", **kw)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return np.asarray(jm.apply({"params": params}, jnp.asarray(x, dtype)).astype(jnp.float32))


def port_model(kw, seed=0, clamp=False):
    model = init.initialize(VSSM(**kw), torch.Generator().manual_seed(seed))
    if clamp:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, SS2D):
                    m.dt_projs_bias[:, ::3] = 12.0
    return model


def _close(got, want, rel):
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def test_logits_b1_from_bem_tpu_params():
    kw = narrow(ssm_d_state=4, ssm_ratio=1.0)
    x = images(1)
    jm = JaxVSSM(scan_backend="pallas", **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    model = load_flax_params(VSSM(**kw), jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, jax_logits(kw, params, x), 1e-5)


@pytest.mark.parametrize("d_state,ratio", [(16, 2.0), (4, 1.0)])
def test_logits_b2_clamped_core(d_state, ratio):
    kw = narrow(ssm_d_state=d_state, ssm_ratio=ratio)
    model = port_model(kw, clamp=True)
    x = images(2)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, jax_logits(kw, state_dict_to_flax(model), x), 1e-5)
