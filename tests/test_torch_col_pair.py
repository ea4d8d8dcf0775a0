"""The transpose-free column pair and the scan-pair gradients vs bem_tpu.

``ss2d_col_pair`` (on the CPU: its plain summary / cross-scan / direction
passes) against bem_tpu's ``ss2d_col_pair_g`` in interpret mode, with
row-blocked (th < H) and whole-image (th = H) shapes, N in {1, 2}, y0
given or not, clamp-hitting biases (dt*A < -10), fp32 and bf16; the SS2D
with the column-pair dispatch against bem_tpu's SS2D; and the gradients
of both pairs against the JAX custom VJPs. Tolerances: fp32 1e-5 of the
output's magnitude, bf16 2e-2 relative (a few bf16 ulps), gradients 1e-4
of each gradient's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.nn.ss2d import SS2D as JSS2D
from bem_tpu.ops.ss2d_seq import _pick_col_rows as jax_pick_col_rows
from bem_tpu.ops.ss2d_seq import ss2d_col_pair_g as jax_col_pair
from bem_tpu.ops.ss2d_seq import ss2d_seq_pair_g as jax_seq_pair
from bem_tpu_torch.convert import load_flax_params
from bem_tpu_torch.nn import SS2D
from bem_tpu_torch.ops.ss2d_seq import (_pick_col_rows, col_pair_supported, ss2d_col_pair,
                                        ss2d_seq_pair)

from test_torch_ops import SCAN_KEYS, scan_weights

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _close(out, ref, dtype):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(ref).max()))
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-2 * max(1.0, np.abs(ref).max()))


# (B, C, H, W, N): th = 8 < H = 16 at W = 128, whole-image th at 8x12 / 6x10
COL_CASES = [(1, 16, 16, 128, 1), (2, 24, 8, 12, 1), (1, 16, 6, 10, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_y0", [True, False])
@pytest.mark.parametrize("B,C,H,W,N", COL_CASES)
def test_col_pair_matches_pallas(B, C, H, W, N, with_y0, dtype):
    w = scan_weights(C, 3, N, seed=H * W, clamp_hit=True)
    rng = np.random.default_rng(H + W)
    x = rng.standard_normal((B, C, H * W)).astype(np.float32)
    y0 = rng.standard_normal((B, C, H * W)).astype(np.float32) if with_y0 else None
    cast = lambda a: None if a is None else jnp.asarray(a, JDT[dtype])  # noqa: E731
    tcast = lambda a: None if a is None else torch.from_numpy(a).to(TDT[dtype])  # noqa: E731
    ref = jax.jit(jax_col_pair, static_argnums=(7, 8, 9))(
        cast(x), *(jnp.asarray(w[k]) for k in SCAN_KEYS), cast(y0), 1, H, W)
    out = ss2d_col_pair(tcast(x), *(torch.from_numpy(w[k]) for k in SCAN_KEYS), tcast(y0), H, W)
    assert out.dtype == TDT[dtype] and out.shape == (B, C, H * W)
    _close(out, ref, dtype)


@pytest.mark.parametrize("H,W", [(16, 128), (8, 8), (448, 640), (28, 40), (7, 10), (72, 72),
                                 (100, 100), (128, 128)])
def test_col_dispatch_matches_bem_tpu(H, W):
    assert _pick_col_rows(H, W) == jax_pick_col_rows(H, W)
    assert col_pair_supported(H, W) == (jax_pick_col_rows(H, W) is not None)


@pytest.mark.parametrize("H,W", [(16, 128), (72, 72)])
def test_ss2d_dispatch_matches_jax(H, W):
    """The port's SS2D (column pair where supported, transposed row-pair
    kernel at 72x72) vs bem_tpu's fused Pallas SS2D."""
    B, C = 1, 8
    x = np.random.default_rng(1).standard_normal((B, C, H * W)).astype(np.float32)
    jm = JSS2D(scan_backend="pallas", layout="NCHW", d_model=C, d_state=1, ssm_ratio=1.0,
               forward_type="v05_noz")
    v = jax.jit(lambda k, x: jm.init(k, x, (H, W)))(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, (H, W)))(v, jnp.asarray(x)))
    m = load_flax_params(SS2D(C), v)
    with torch.no_grad():
        y = m(torch.from_numpy(x), (H, W))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-3, atol=1e-3)


def _grad_inputs(B, C, H, W, N, seed):
    w = scan_weights(C, 3, N, seed=seed, clamp_hit=True)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((B, C, H * W)).astype(np.float32)
    g = rng.standard_normal((B, C, H * W)).astype(np.float32)
    return w, x, g


def _jax_grads(fn, g, *args):
    """jax.vjp of ``fn`` at ``args`` for cotangent g, jitted."""
    return jax.jit(lambda g, *a: jax.vjp(fn, *a)[1](g))(jnp.asarray(g), *args)


def _grad_close(outs, refs):
    for out, ref in zip(outs, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("pair", ["row", "col"])
@pytest.mark.parametrize("B,C,H,W,N", [(2, 16, 8, 12, 1), (1, 8, 6, 10, 2)])
def test_seq_pair_grads_match_jax(B, C, H, W, N, pair):
    w, x, g = _grad_inputs(B, C, H, W, N, seed=H * W)
    wj = [jnp.asarray(w[k]) for k in SCAN_KEYS]
    refs = _jax_grads(lambda x, *w: jax_seq_pair(x, *w, 1, pair), g, jnp.asarray(x), *wj)
    ins = [torch.from_numpy(x).requires_grad_()] + [
        torch.from_numpy(w[k]).requires_grad_() for k in SCAN_KEYS]
    outs = torch.autograd.grad(ss2d_seq_pair(*ins, pair), ins, torch.from_numpy(g))
    _grad_close(outs, refs)


@pytest.mark.parametrize("with_y0", [True, False])
@pytest.mark.parametrize("B,C,H,W,N", [(2, 16, 8, 12, 1), (1, 8, 16, 128, 2)])
def test_col_pair_grads_match_jax(B, C, H, W, N, with_y0):
    w, x, g = _grad_inputs(B, C, H, W, N, seed=H + W)
    y0 = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    wj = [jnp.asarray(w[k]) for k in SCAN_KEYS]
    if with_y0:
        refs = _jax_grads(lambda x, y0, *w: jax_col_pair(x, *w, y0, 1, H, W), g,
                          jnp.asarray(x), jnp.asarray(y0), *wj)
    else:
        refs = _jax_grads(lambda x, *w: jax_col_pair(x, *w, None, 1, H, W), g,
                          jnp.asarray(x), *wj)
    xt = torch.from_numpy(x).requires_grad_()
    y0t = torch.from_numpy(y0).requires_grad_() if with_y0 else None
    wt = [torch.from_numpy(w[k]).requires_grad_() for k in SCAN_KEYS]
    y = ss2d_col_pair(xt, *wt, y0t, H, W)
    ins = [xt] + ([y0t] if with_y0 else []) + wt
    _grad_close(torch.autograd.grad(y, ins, torch.from_numpy(g)), refs)
