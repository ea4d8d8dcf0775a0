"""Kernel parity: the port's kernel functions vs bem_tpu's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernels in interpret mode (as tests/test_ss2d_seq_tail.py
does). Same numpy-seeded inputs on both sides. Tolerances: fp32 2e-4
(test_ss2d_seq_tail.py:49-51), bf16 2e-2 (:155-157). The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py and by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.gdmlp_fused import gdmlp_fused_cf as jax_gdmlp
from bem_tpu.ops.gdmlp_fused import stem_fused_cf as jax_stem
from bem_tpu.ops.ss2d_seq import _seq_pair_ref
from bem_tpu.ops.ss2d_seq import ss2d_col_pair_g as jax_col_pair
from bem_tpu.ops.ss2d_seq import ss2d_seq_pair_g as jax_seq_pair
from bem_tpu.ops.ss2d_tail import ss2d_tail_cf as jax_tail
from bem_tpu_torch.ops import (gdmlp_fused_cf, ss2d_seq_pair, ss2d_tail_cf,
                               stem_fused_cf)

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype="float32"):
    """numpy fp32 array -> (jax array, torch tensor) of the same values."""
    j = jnp.asarray(a, JDT[dtype])
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])
    return j, t


def _close(t_out, j_out, dtype):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _conv_weights(rng, C, Dh, with_bias):
    w = dict(W1=rng.standard_normal((Dh, C)) * C ** -0.5,
             dw=rng.standard_normal((Dh, 9)) * 0.3,
             b1=rng.standard_normal(Dh) * 0.1 if with_bias else None,
             bdw=rng.standard_normal(Dh) * 0.1 if with_bias else None,
             lns=rng.standard_normal(C) * 0.2 + 1.0,
             lnb=rng.standard_normal(C) * 0.1)
    return {k: None if v is None else v.astype(np.float32) for k, v in w.items()}


def _both(w):
    return ({k: None if v is None else jnp.asarray(v) for k, v in w.items()},
            {k: None if v is None else torch.from_numpy(v) for k, v in w.items()})


# (B, C, H, W): the last case has C >= 64, where bem_tpu folds the taps
# into W1 (use_folded_conv) — the same function, another kernel form
CONV_SHAPES = [(2, 16, 8, 16), (1, 24, 12, 20), (1, 64, 4, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_ln,with_bias", [(True, True), (False, False)])
@pytest.mark.parametrize("B,C,H,W", CONV_SHAPES)
def test_stem_matches_pallas(B, C, H, W, use_ln, with_bias, dtype):
    rng = np.random.default_rng(0)
    w = _conv_weights(rng, C, C, with_bias)
    xj, xt = _pair(rng.standard_normal((B, C, H * W)), dtype)
    wj, wt = _both(w)
    ln_j = (wj["lns"], wj["lnb"]) if use_ln else (None, None)
    ln_t = (wt["lns"], wt["lnb"]) if use_ln else (None, None)
    ref = jax_stem(xj, wj["W1"], wj["b1"], wj["dw"], wj["bdw"], H, W, *ln_j)
    out = stem_fused_cf(xt, wt["W1"], wt["b1"], wt["dw"], wt["bdw"], H, W, *ln_t)
    assert out.dtype == TDT[dtype] and out.shape == (B, C, H * W)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_ln,residual,with_bias",
                         [(True, True, True), (False, False, False)])
@pytest.mark.parametrize("B,C,H,W", CONV_SHAPES)
def test_gdmlp_matches_pallas(B, C, H, W, use_ln, residual, with_bias, dtype):
    rng = np.random.default_rng(1)
    h = 2 * C  # mlp_ratio 2 keeps the CPU interpret run short
    w = _conv_weights(rng, C, 2 * h, with_bias)
    w["W2"] = (rng.standard_normal((C, h)) * h ** -0.5).astype(np.float32)
    w["b2"] = (rng.standard_normal(C) * 0.1).astype(np.float32) if with_bias else None
    xj, xt = _pair(rng.standard_normal((B, C, H * W)), dtype)
    wj, wt = _both(w)
    ln_j = (wj["lns"], wj["lnb"]) if use_ln else (None, None)
    ln_t = (wt["lns"], wt["lnb"]) if use_ln else (None, None)
    ref = jax_gdmlp(xj, wj["W1"], wj["b1"], wj["dw"], wj["bdw"], wj["W2"],
                    wj["b2"], H, W, *ln_j, residual)
    out = gdmlp_fused_cf(xt, wt["W1"], wt["b1"], wt["dw"], wt["bdw"], wt["W2"],
                         wt["b2"], H, W, *ln_t, residual)
    assert out.dtype == TDT[dtype] and out.shape == (B, C, H * W)
    _close(out, ref, dtype)


def scan_weights(C, R, N, seed, clamp_hit=False):
    """As test_ss2d_seq_tail.make_weights; with ``clamp_hit`` a third of the
    channels get bias ~ +12, so dt ~ 12 and dt*A < -10 (the clamp bites)."""
    rng = np.random.default_rng(seed)
    P = R + 2 * N
    bias = rng.standard_normal((4, C)) * 0.5
    if clamp_hit:
        bias[:, ::3] = 12.0 + rng.standard_normal((4, len(range(0, C, 3))))
    w = dict(Wx=rng.standard_normal((4, P, C)) * 0.2,
             Wdt=rng.standard_normal((4, C, R)) * 0.2,
             bias=bias,
             A=-np.exp(rng.standard_normal((4, C, N)) * 0.3),
             D=rng.standard_normal((4, C)))
    return {k: v.astype(np.float32) for k, v in w.items()}


SCAN_KEYS = ("Wx", "Wdt", "bias", "A", "D")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pair", ["row", "col"])
@pytest.mark.parametrize("B,C,L,R,N,clamp_hit", [
    (2, 24, 96, 3, 1, False),     # single padded Pallas block
    (1, 40, 1296, 3, 1, True),    # multi-block carry, clamp hit
    (2, 16, 640, 4, 2, True),     # N=2, clamp hit
])
def test_seq_pair_matches_pallas(B, C, L, R, N, clamp_hit, pair, dtype):
    w = scan_weights(C, R, N, seed=L, clamp_hit=clamp_hit)
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((B, C, L)), dtype)
    wj, wt = _both(w)
    ref = jax_seq_pair(xj, *(wj[k] for k in SCAN_KEYS), 1, pair)
    out = ss2d_seq_pair(xt, *(wt[k] for k in SCAN_KEYS), pair)
    assert out.dtype == TDT[dtype] and out.shape == (B, C, L)
    _close(out, ref, dtype)


def test_clamp_changes_the_result():
    """On clamp-hitting inputs the unclamped composition (_seq_pair_ref)
    disagrees with the kernel: the test inputs above really exercise it."""
    B, C, L, R, N = 1, 24, 256, 3, 1
    w = scan_weights(C, R, N, seed=5, clamp_hit=True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, C, L)).astype(np.float32)
    wj, wt = _both(w)
    xdbl = np.einsum("pc,bcl->bpl", w["Wx"][0], x)
    dtr = np.einsum("cr,brl->bcl", w["Wdt"][0], xdbl[:, :R]) + w["bias"][0][None, :, None]
    dt = np.logaddexp(0.0, dtr)
    assert (dt * w["A"][0][None, :, :1] < -10).any()
    out = ss2d_seq_pair(torch.from_numpy(x), *(wt[k] for k in SCAN_KEYS), "row")
    unclamped = jax.jit(_seq_pair_ref, static_argnums=(6, 7))(
        jnp.asarray(x), *(wj[k] for k in SCAN_KEYS), 0, 2)
    assert np.abs(out.numpy() - np.asarray(unclamped)).max() > 1e-3


@pytest.mark.parametrize("B,C,H,W,N", [(2, 24, 12, 16, 1), (1, 16, 8, 32, 2)])
def test_col_pair_via_transpose_matches_col_kernel(B, C, H, W, N):
    """The port computes the column pair by transposing the sequence and
    running the same pair kernel; bem_tpu's transpose-free column kernel
    (ss2d_col_pair_g) computes the same function."""
    L = H * W
    w = scan_weights(C, 3, N, seed=H, clamp_hit=True)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, C, L)).astype(np.float32)
    wj, wt = _both(w)
    ref = jax_col_pair(jnp.asarray(x), *(wj[k] for k in SCAN_KEYS), None, 1, H, W)
    xt = torch.from_numpy(x).reshape(B, C, H, W).transpose(2, 3).reshape(B, C, L)
    y = ss2d_seq_pair(xt.contiguous(), *(wt[k] for k in SCAN_KEYS), "col")
    y = y.reshape(B, C, W, H).transpose(2, 3).reshape(B, C, L)
    _close(y, ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("merged,use_bias,use_res",
                         [(False, False, False), (False, True, True),
                          (True, False, True)])
def test_tail_matches_pallas(merged, use_bias, use_res, dtype):
    B, C, Cout, L = 2, 24, 24, 200
    rng = np.random.default_rng(4)
    yrj, yrt = _pair(rng.standard_normal((B, C, L)) + 3.0, dtype)
    ycj, yct = (None, None) if merged else _pair(rng.standard_normal((B, C, L)), dtype)
    resj, rest = _pair(rng.standard_normal((B, Cout, L)), dtype) if use_res else (None, None)
    w = dict(sc=rng.standard_normal(C) * 0.2 + 1.0, bi=rng.standard_normal(C) * 0.1,
             W=rng.standard_normal((C, Cout)) * 0.2,
             bo=rng.standard_normal(Cout) * 0.1 if use_bias else None)
    wj, wt = _both({k: None if v is None else v.astype(np.float32) for k, v in w.items()})
    ref = jax_tail(yrj, ycj, wj["sc"], wj["bi"], wj["W"], wj["bo"], 1, resj)
    out = ss2d_tail_cf(yrt, yct, wt["sc"], wt["bi"], wt["W"], wt["bo"], rest)
    assert out.dtype == TDT[dtype] and out.shape == (B, Cout, L)
    _close(out, ref, dtype)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4, 16, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        ss2d_tail_cf(x, None, torch.ones(4), torch.zeros(4), torch.eye(4), None)

