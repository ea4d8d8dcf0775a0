"""The scan-pattern forward types v051d (unidi) and v052d (bidi): the port vs bem_tpu.

bem_tpu runs with scan_backend="pallas", so its SS2Ds take the
non-cross2d branch (ss2d.py:521-541 in NHWC): cross_scan_cf, the two
projections, selective_scan_fused (its Pallas kernel in interpret mode),
cross_merge_cf. The port's SS2D must take the same branch: run through
the cross2d fused core (the ``_noz`` forms would, if its dispatch ignored
the scan mode) it gives other numbers and these tests fail.

- the channel-first cross-scan / merge forms for scans 0-2 (exact: the
  same data movement and sums in the same order, fp32);
- SS2D maps (d_state 4, ssm_ratio 2, conv bias) for v051d, v052d and their
  _noz forms in NHWC, bem_tpu's initialized params loaded into the port
  (convert.load_flax_params), every third channel's dt bias +12: fp32
  within 1e-5 of the output's largest entry;
- the narrow VSSM's logits for v052dc (the cascade, ported since the test
  that checked its refusal was written; the test keeps its name) in fp32;
- the narrow VSSM's logits for v052d (d_state 16) in fp32 (1e-5) and (in
  test_torch_vssm_scans_train.py, with one make_trainer step for v052d,
  checked as test_torch_classify_train.py checks v2's) in the bf16 stream
  (2 bf16 ulps of the largest, 2^-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.nn.ss2d import SS2D as JSS2D
from bem_tpu.ops.cross_scan import (cross_merge_cf, cross_merge_cf_output, cross_scan_cf,
                                    cross_scan_cf_input)
from bem_tpu_torch.ops import cross_scan as cs
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.nn import SS2D

from test_torch_vssm import _close, images, jax_logits, narrow, port_model
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

SS2D_KW = dict(d_model=8, d_state=4, ssm_ratio=2.0, conv_bias=True)


def check_v052d_logits(dtype):
    """The narrow v052d VSSM's logits on a seeded batch of two images."""
    kw = narrow(ssm_d_state=16, ssm_ratio=2.0, forward_type="v052d")
    model = port_model(kw, seed=2, clamp=True)
    x = images(2, seed=4)
    want = jax_logits(kw, state_dict_to_flax(model), x,
                      jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    _close(got.float().numpy(), want, 1e-5 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.parametrize("scans", [0, 1, 2])
def test_cross_scan_forms_match(scans):
    rng = np.random.default_rng(scans)
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)   # (B, H, W, C)
    y = rng.standard_normal((2, 4, 3, 30)).astype(np.float32)  # (B, K, C, L)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    pairs = [(cs.cross_scan_cf(xt, scans), cross_scan_cf(jnp.asarray(x), scans)),
             (cs.cross_scan_cf_input(xt.permute(0, 3, 1, 2), scans),
              cross_scan_cf_input(jnp.asarray(x.transpose(0, 3, 1, 2)), scans)),
             (cs.cross_merge_cf(yt, 5, 6, scans), cross_merge_cf(jnp.asarray(y), 5, 6, scans)),
             (cs.cross_merge_cf_output(yt, 5, 6, scans),
              cross_merge_cf_output(jnp.asarray(y), 5, 6, scans))]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ftype", ["v051d", "v052d", "v051d_noz", "v052d_noz"])
def test_ss2d_map_matches_pallas(ftype):
    B, H, W = 2, 6, 7
    x = np.random.default_rng(5).standard_normal((B, H, W, SS2D_KW["d_model"]))
    x = x.astype(np.float32)
    jm = JSS2D(scan_backend="pallas", forward_type=ftype, **SS2D_KW)
    params = jax.tree_util.tree_map(np.array, jax.jit(jm.init)(jax.random.PRNGKey(1),
                                                              jnp.asarray(x))["params"])
    params["dt_projs_bias"][:, ::3] = 12.0
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    m = load_flax_params(SS2D(forward_type=ftype, **SS2D_KW), params)
    assert m.scans in (1, 2) and not m.fused_core
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _close(got, want, 1e-5)


def test_v052d_logits_fp32():
    check_v052d_logits(torch.float32)


def test_v052dc_still_raises():
    """v052dc (cascade2d) is ported: the narrow v052dc VSSM's fp32 logits
    match bem_tpu's (1e-5 of the largest), its scans on linear_scan."""
    kw = narrow(ssm_d_state=4, ssm_ratio=2.0, forward_type="v052dc")
    model = port_model(kw, seed=3)
    assert all(m.scans == 3 for m in model.modules() if isinstance(m, SS2D))
    x = images(2, seed=5)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _close(got.numpy(), jax_logits(kw, state_dict_to_flax(model), x), 1e-5)
