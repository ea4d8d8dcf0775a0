"""Layer parity: the port's SS2D / VSSBlock / U-Net seams vs bem_tpu's.

Weights come from the JAX module's init and reach the port through
bem_tpu_torch.convert; inputs are numpy-seeded. The JAX side runs both the
fused Pallas path (interpret mode, channel-first) and the XLA composition
(NHWC). Tolerances: SS2D / VSSBlock 1e-3 (test_ss2d_seq_tail.py:182-198),
plain fp32 layers 1e-5, the bf16 folded DualUpSample 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from bem_tpu.archs.arch_util import DualUpSample as JDualUpSample
from bem_tpu.archs.arch_util import PatchMerging as JPatchMerging
from bem_tpu.nn.layers import Conv2d as JConv2d
from bem_tpu.nn.layers import Dense as JDense
from bem_tpu.nn.ss2d import SS2D as JSS2D
from bem_tpu.nn.vss import VSSBlock as JVSSBlock
from bem_tpu_torch.archs.arch_util import DualUpSample, PatchMerging
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.nn import SS2D, Conv2d, Dense, VSSBlock, sample_bayes

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _to_nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


B, H, W, C = 2, 8, 12, 16
SS2D_KW = dict(d_model=C, d_state=1, ssm_ratio=1.0, forward_type="v05_noz")
VSS_KW = dict(hidden_dim=C, forward_type="v05_noz", mlp_ratio=4.0, mlp_type="gdmlp")


@pytest.fixture(scope="module")
def block_params():
    """One jitted bem_tpu init each of SS2D and VSSBlock at (B, H, W, C)."""
    x0 = jnp.zeros((B, H, W, C))
    return (jax.jit(JSS2D(scan_backend="xla", **SS2D_KW).init)(jax.random.PRNGKey(0), x0),
            jax.jit(JVSSBlock(scan_backend="xla", **VSS_KW).init)(jax.random.PRNGKey(0), x0))


@pytest.mark.parametrize("backend,layout", [("pallas", "NCHW"), ("xla", "NHWC")])
@pytest.mark.parametrize("fold_ln_residual", [False, True])
def test_ss2d_matches_jax(block_params, backend, layout, fold_ln_residual):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ln = (rng.standard_normal(C) * 0.2 + 1.0).astype(np.float32), \
        (rng.standard_normal(C) * 0.1).astype(np.float32)
    jm = JSS2D(scan_backend=backend, layout=layout, **SS2D_KW)
    xj = jnp.asarray(x) if layout == "NHWC" else jnp.asarray(
        np.transpose(x, (0, 3, 1, 2)).reshape(B, C, H * W))
    v = block_params[0]
    lnj = tuple(map(jnp.asarray, ln))
    if fold_ln_residual:
        if layout == "NHWC":  # the NHWC composition applies LN / residual as plain ops
            from bem_tpu.nn.ss2d import _plain_ln
            fn = lambda v, x: jm.apply(v, _plain_ln(x, lnj, -1)) + x  # noqa: E731
        else:
            fn = lambda v, x: jm.apply(v, x, (H, W), lnj, True)  # noqa: E731
    else:
        fn = jm.apply if layout == "NHWC" else lambda v, x: jm.apply(v, x, (H, W))  # noqa: E731
    y_ref = jax.jit(fn)(v, xj)
    y_ref = np.asarray(y_ref)
    if layout == "NCHW":
        y_ref = np.transpose(y_ref.reshape(B, C, H, W), (0, 2, 3, 1))

    m = load_flax_params(SS2D(C), v)
    xt = _nchw(x).reshape(B, C, H * W)
    args = ((torch.from_numpy(ln[0]), torch.from_numpy(ln[1])), True) \
        if fold_ln_residual else ()
    with torch.no_grad():
        y = m(xt, (H, W), *args)
    np.testing.assert_allclose(_to_nhwc(y.reshape(B, C, H, W)), y_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("backend,layout", [("pallas", "NCHW"), ("xla", "NHWC")])
def test_vssblock_matches_jax(block_params, backend, layout):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    v = block_params[1]
    jm = JVSSBlock(scan_backend=backend, layout=layout, **VSS_KW)
    if layout == "NCHW":
        y_ref = np.transpose(np.asarray(jax.jit(jm.apply)(
            v, jnp.asarray(np.transpose(x, (0, 3, 1, 2))))), (0, 2, 3, 1))
    else:
        y_ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    m = load_flax_params(VSSBlock(C, mlp_ratio=4.0), v)
    with torch.no_grad():
        y = m(_nchw(x))
    np.testing.assert_allclose(_to_nhwc(y), y_ref, rtol=1e-3, atol=1e-3)


def test_patch_merging_matches_jax():
    c = 6
    x = np.random.default_rng(1).standard_normal((B, H, W, c)).astype(np.float32)
    jm = JPatchMerging(c, layout="NCHW")
    xc = jnp.asarray(np.transpose(x, (0, 3, 1, 2)))
    v = jm.init(jax.random.PRNGKey(1), xc)
    y_ref = np.asarray(jm.apply(v, xc))
    m = load_flax_params(PatchMerging(c), v)
    with torch.no_grad():
        y = m(_nchw(x))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,fold_tail", [("float32", False), ("bfloat16", False),
                                             ("bfloat16", True)])
def test_dual_upsample_matches_jax(dtype, fold_tail, monkeypatch):
    """fp32: the reference op order on both sides. bf16: the port's folded
    form vs bem_tpu's folded form, which the CPU backend runs in fp32 only
    (BEM_FUSED_UPSAMPLE=1 selects it there)."""
    c = 8
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, c, 4, 6)).astype(np.float32)
    jm = JDualUpSample(c, layout="NCHW")
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ft = rng.standard_normal((c // 2, c // 2)).astype(np.float32) if fold_tail else None
    if dtype == "bfloat16":
        monkeypatch.setenv("BEM_FUSED_UPSAMPLE", "1")
    y_ref = jm.apply(v, jnp.asarray(x), fold_tail=None if ft is None else jnp.asarray(ft))
    m = load_flax_params(DualUpSample(c), v)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    with torch.no_grad():
        y = m(torch.from_numpy(x).to(tdt),
              fold_tail=None if ft is None else torch.from_numpy(ft))
    assert y.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_ref, np.float32),
                               rtol=tol, atol=tol)


def test_dual_upsample_forms_agree():
    """The folded form (bf16 path) computes the unfolded form's function."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 8, 4, 6)).astype(np.float32))
    m = DualUpSample(8)
    from bem_tpu_torch.nn.init import initialize
    initialize(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = m(x)
        folded = m(x.bfloat16())
    np.testing.assert_allclose(folded.float().numpy(), ref.numpy(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("kind", ["conv", "conv_dw", "dense"])
def test_bayesian_sample_with_injected_eps(kind):
    """w = mu + softplus(rho) * eps with numpy eps == the JAX layer run
    deterministically on mu := mu + softplus(rho) * eps."""
    rng = np.random.default_rng(4)
    c = 8
    x = rng.standard_normal((B, c, 6, 10)).astype(np.float32)
    if kind == "dense":
        jm, m = JDense(12, bayesian=True, axis=1), Dense(c, 12, bayesian=True)
    elif kind == "conv_dw":
        jm = JConv2d(c, 3, padding=1, groups=c, bayesian=True, data_format="NCHW")
        m = Conv2d(c, c, 3, padding=1, groups=c, bayesian=True)
    else:
        jm = JConv2d(12, 3, padding=1, bayesian=True, data_format="NCHW")
        m = Conv2d(c, 12, 3, padding=1, bayesian=True)
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    # rho is a constant at init: perturb it so softplus(rho) varies
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    for k in list(params):
        if k.startswith("rho_"):
            params[k] = params[k] + rng.uniform(-1, 1, params[k].shape).astype(np.float32)
    load_flax_params(m, params)
    eps = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
           for n, p in m.named_parameters() if n.startswith("mu_")}
    sampled = sample_bayes(m, eps=eps)
    with torch.no_grad():
        y = functional_call(m, sampled, (torch.from_numpy(x),))
        y_mu = m(torch.from_numpy(x))
    jax_params = state_dict_to_flax(m, sampled)
    y_ref = np.asarray(jm.apply({"params": jax_params}, jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
    # without a generator or eps the layer runs on mu
    assert sample_bayes(m) == {}
    y_det = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(y_mu.numpy(), y_det, rtol=1e-5, atol=1e-5)
    assert np.abs(y_det - y_ref).max() > 1e-3


def test_sample_bayes_generator_is_reproducible():
    m = Conv2d(4, 4, 3, padding=1, bayesian=True)
    from bem_tpu_torch.nn.init import initialize
    initialize(m, torch.Generator().manual_seed(0))
    a = sample_bayes(m, torch.Generator().manual_seed(5))
    b = sample_bayes(m, torch.Generator().manual_seed(5))
    c = sample_bayes(m, torch.Generator().manual_seed(6))
    assert set(a) == {"mu_weight", "mu_bias"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mu_weight"], c["mu_weight"])
