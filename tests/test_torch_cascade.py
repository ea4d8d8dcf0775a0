"""The cascade SS2D (v052dc) and its selective scan: the port vs bem_tpu.

- ``ops.scan.selective_scan`` (channels-last, fp32 out, its recurrence on
  ``linear_scan``) against bem_tpu's with backend "pallas" (its linear-scan
  kernel in interpret mode) and "xla", on fp32 and bf16 inputs, grouped
  B / C (K = 2 groups), with and without D and the dt bias: fp32 within
  1e-5 of max(1, |ref|), bf16 within 2e-2;
- SS2D ``v052dc`` / ``v052dc_noz`` maps (NHWC in bem_tpu, channel-first
  in the port) from the port's seeded weights carried to bem_tpu with
  ``state_dict_to_flax``, bem_tpu with scan_backend="pallas": fp32 within
  1e-5 of max(1, |ref|), bf16 within 2e-2;
- the cascade's gradients (input and every parameter) against jax.vjp,
  each within 1e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.nn.ss2d import SS2D as JSS2D
from bem_tpu.ops.scan import selective_scan as jax_selective_scan
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.nn import SS2D, init
from bem_tpu_torch.ops.scan import selective_scan

from test_torch_train import _flat
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

SS2D_KW = dict(d_model=8, d_state=4, ssm_ratio=2.0, conv_bias=True)


def close(got, want, tol):
    """|got - want| <= tol * max(1, |want|) elementwise over the array's scale."""
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol * max(1.0, float(np.abs(want).max())), (err, np.abs(want).max())


def grads_close(got: dict, want: dict, tol=1e-4):
    """Each gradient leaf within ``tol`` of its largest entry."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = np.abs(np.asarray(got[k]) - np.asarray(w)).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (k, err, np.abs(w).max())


def port_ss2d(forward_type, seed=0, **kw):
    return init.initialize(SS2D(forward_type=forward_type, **dict(SS2D_KW, **kw)),
                           torch.Generator().manual_seed(seed))


def jax_ss2d(forward_type, **kw):
    return JSS2D(scan_backend="pallas", forward_type=forward_type, **dict(SS2D_KW, **kw))


def jparams(model):
    return jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(model))


def nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


def map_input(B=2, H=5, W=6, C=8, seed=3):
    return np.random.default_rng(seed).standard_normal((B, C, H, W)).astype(np.float32)


def scan_inputs(Bt=2, L=9, K=2, Cd=3, N=4, seed=0):
    rng = np.random.default_rng(seed)
    KD = K * Cd
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(u=f(Bt, L, KD), delta=f(Bt, L, KD), A=-np.exp(f(KD, N)), B=f(Bt, L, K, N),
                C=f(Bt, L, K, N), D=f(KD), delta_bias=f(KD))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extras", [True, False])
def test_selective_scan_matches(backend, dtype, extras):
    a = scan_inputs(seed=1 + extras)
    if not extras:
        a["D"] = a["delta_bias"] = None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_selective_scan(*(None if v is None else jnp.asarray(v, jd) for v in a.values()),
                              delta_softplus=True, backend=backend)
    got = selective_scan(*(None if v is None else torch.from_numpy(v).to(td)
                           for v in a.values()))
    assert got.dtype == torch.float32 and got.shape == want.shape
    close(got.numpy(), np.asarray(want), 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("ftype", ["v052dc", "v052dc_noz"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cascade_map_matches_pallas(ftype, dtype):
    model = port_ss2d(ftype)
    assert model.scans == 3 and not model.fused_core
    x = map_input()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(jax_ss2d(ftype).apply)({"params": jparams(model)}, jnp.asarray(nhwc(x), jd))
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(td))
    assert got.dtype == td
    close(nhwc(got.float().numpy()), np.asarray(want.astype(jnp.float32)),
          1e-5 if dtype == "float32" else 2e-2)


def test_cascade_gradients_match_vjp():
    model = port_ss2d("v052dc", seed=1)
    x = map_input(seed=4)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    params = jparams(model)
    jm = jax_ss2d("v052dc")
    _, vjp = jax.vjp(lambda p, v: jm.apply({"params": p}, v), params, jnp.asarray(nhwc(x)))
    jg_params, jg_x = vjp(jnp.asarray(nhwc(cot)))
    xt = torch.from_numpy(x).requires_grad_()
    names = [k for k, _ in model.named_parameters()]
    out = model(xt)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [xt] + [p for _, p in model.named_parameters()])
    grads_close({"x": nhwc(grads[0].numpy()),
                 **_flat(state_dict_to_flax(model, dict(zip(names, grads[1:]))))},
                {"x": np.asarray(jg_x), **_flat(jg_params)})
