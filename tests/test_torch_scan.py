"""linear_scan parity: the port vs bem_tpu's Pallas scan (interpret mode).

Same numpy-seeded inputs on both sides, forward and reverse, with L not a
multiple of the Pallas block (256) and D above its lane block (128). The
gradient is held against jax.vjp of the custom-VJP scan. Tolerance rtol
1e-5 (fp32 on both sides; the doubling and sequential sums differ only in
their order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.scan import _linear_scan_pallas as jax_scan_pallas
from bem_tpu.ops.scan import linear_scan as jax_scan
from bem_tpu_torch.ops.scan import linear_scan, linear_scan_plain, scan_plain

SHAPES = [(2, 300, 40), (1, 3, 64, 136), (3, 1, 5)]


@pytest.fixture(autouse=True, scope="module")
def _drop_interpret_traces():
    """bem_tpu's jitted Pallas scan caches the interpret-mode traces these
    tests make; dropping them afterwards keeps a later test in the same
    process that lowers the same shapes for the TPU (test_tpu_lowering.py)
    from reusing them."""
    yield
    jax_scan_pallas.clear_cache()


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return a, b


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_linear_scan_matches_pallas(shape, reverse):
    a, b = _inputs(shape, seed=len(shape))
    ref = np.asarray(jax_scan(jnp.asarray(a), jnp.asarray(b), backend="pallas", reverse=reverse))
    out = linear_scan(torch.from_numpy(a), torch.from_numpy(b), reverse)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_linear_scan_grad_matches_jax(shape, reverse):
    a, b = _inputs(shape, seed=7)
    g = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_scan(a, b, backend="pallas", reverse=reverse),
                     jnp.asarray(a), jnp.asarray(b))
    da_ref, db_ref = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    at = torch.from_numpy(a).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    da, db = torch.autograd.grad(linear_scan(at, bt, reverse), (at, bt), torch.from_numpy(g))
    for out, ref in ((da, da_ref), (db, db_ref)):
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_scan_plain_along_other_dims():
    """The shared doubling scan on the last axis equals the scan on axis -2
    of the transposed operands, in both directions."""
    a, b = _inputs((2, 37, 6), seed=3)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    for reverse in (False, True):
        h = scan_plain(at.transpose(1, 2), bt.transpose(1, 2), reverse, dim=-1)
        torch.testing.assert_close(h.transpose(1, 2), linear_scan_plain(at, bt, reverse))
