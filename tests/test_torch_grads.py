"""Gradients of the stem, gdMlp and tail wrappers vs bem_tpu's custom VJPs.

The port's autograd.Functions recompute through their oracles; bem_tpu's
custom_vjps recompute through the jnp oracles. Same numpy-seeded inputs
and cotangent; every argument that is not None is compared, fp32, within
1e-4 of each gradient's largest entry (two fp32 compositions summing in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.gdmlp_fused import gdmlp_fused_cf as jax_gdmlp
from bem_tpu.ops.gdmlp_fused import stem_fused_cf as jax_stem
from bem_tpu.ops.ss2d_tail import ss2d_tail_cf as jax_tail
from bem_tpu_torch.ops import gdmlp_fused_cf, ss2d_tail_cf, stem_fused_cf

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def _check(jax_fn, torch_fn, args, g):
    """args: list of numpy arrays or None (None stays None on both sides)."""
    idx = [i for i, a in enumerate(args) if a is not None]

    def jf(*present):
        full = list(args)
        for i, v in zip(idx, present):
            full[i] = v
        return jax_fn(*full)

    refs = jax.jit(lambda g, *a: jax.vjp(jf, *a)[1](g))(
        jnp.asarray(g), *(jnp.asarray(args[i]) for i in idx))
    ts = [None if a is None else torch.from_numpy(a).requires_grad_() for a in args]
    outs = torch.autograd.grad(torch_fn(*ts), [ts[i] for i in idx], torch.from_numpy(g))
    assert len(outs) == len(refs) == len(idx)
    for i, out, ref in zip(idx, outs, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=f"argument {i}")


def _f32(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


# (B, C, H, W): a row-blocked image and a whole-image one below a row tile
SHAPES = [(2, 8, 16, 16), (2, 16, 4, 4)]


@pytest.mark.parametrize("with_ln,with_bias", [(True, True), (False, False)])
@pytest.mark.parametrize("B,C,H,W", SHAPES)
def test_stem_grads_match_jax(B, C, H, W, with_ln, with_bias):
    rng = np.random.default_rng(C + H)
    Dh = C
    args = [_f32(rng, (B, C, H * W)), _f32(rng, (Dh, C), C ** -0.5),
            _f32(rng, Dh, 0.1) if with_bias else None, _f32(rng, (Dh, 9), 0.3),
            _f32(rng, Dh, 0.1) if with_bias else None,
            _f32(rng, C, 0.2, 1.0) if with_ln else None, _f32(rng, C, 0.1) if with_ln else None]
    g = _f32(rng, (B, Dh, H * W))
    _check(lambda x, W1, b1, dw, bdw, s, b: jax_stem(x, W1, b1, dw, bdw, H, W, s, b),
           lambda x, W1, b1, dw, bdw, s, b: stem_fused_cf(x, W1, b1, dw, bdw, H, W, s, b),
           args, g)


@pytest.mark.parametrize("with_ln,residual,with_bias",
                         [(True, True, True), (False, False, False)])
@pytest.mark.parametrize("B,C,H,W", SHAPES)
def test_gdmlp_grads_match_jax(B, C, H, W, with_ln, residual, with_bias):
    rng = np.random.default_rng(C * H)
    h = 2 * C
    args = [_f32(rng, (B, C, H * W)), _f32(rng, (2 * h, C), C ** -0.5),
            _f32(rng, 2 * h, 0.1) if with_bias else None, _f32(rng, (2 * h, 9), 0.3),
            _f32(rng, 2 * h, 0.1) if with_bias else None, _f32(rng, (C, h), h ** -0.5),
            _f32(rng, C, 0.1) if with_bias else None,
            _f32(rng, C, 0.2, 1.0) if with_ln else None, _f32(rng, C, 0.1) if with_ln else None]
    g = _f32(rng, (B, C, H * W))

    def jf(x, W1, b1, dw, bdw, W2, b2, s, b):
        return jax_gdmlp(x, W1, b1, dw, bdw, W2, b2, H, W, s, b, residual)

    def tf(x, W1, b1, dw, bdw, W2, b2, s, b):
        return gdmlp_fused_cf(x, W1, b1, dw, bdw, W2, b2, H, W, s, b, residual)

    _check(jf, tf, args, g)


@pytest.mark.parametrize("merged,with_bias,with_res",
                         [(False, False, False), (False, True, True), (True, False, True)])
def test_tail_grads_match_jax(merged, with_bias, with_res):
    B, C, Cout, L = 2, 16, 24, 96
    rng = np.random.default_rng(4)
    args = [_f32(rng, (B, C, L), 1.0, 3.0), None if merged else _f32(rng, (B, C, L)),
            _f32(rng, C, 0.2, 1.0), _f32(rng, C, 0.1), _f32(rng, (C, Cout), 0.2),
            _f32(rng, Cout, 0.1) if with_bias else None,
            _f32(rng, (B, Cout, L)) if with_res else None]
    g = _f32(rng, (B, Cout, L))
    _check(lambda yr, yc, s, b, w, bo, r: jax_tail(yr, yc, s, b, w, bo, 1, r),
           ss2d_tail_cf, args, g)
