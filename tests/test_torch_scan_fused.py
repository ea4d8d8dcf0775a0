"""selective_scan_fused (kernel 11): the port vs bem_tpu's Pallas kernel.

bem_tpu's selective_scan_fused runs its Pallas kernel in interpret mode on
the CPU; the port's wrapper runs its plain version (bem_tpu's unfolded
composition on the doubling scan). Same numpy-seeded inputs on both
sides: u, delta, B, C in the stream dtype, A (K*C, N), D and the dt bias
(K*C,) fp32, every third channel's bias +12 so that dt*A < -10 there, and
x zero at every other position of those channels (the clamp probe, whose
elements are held as rows of their own, as chip_smoke.py does). One shape
has L > 4096, crossing the Pallas kernel's L-block carry.

Tolerances, per (image, direction, channel) row against its own largest
entry: fp32 2e-4 (sums in another order); bf16 2e-2 (both sides round the
fp32 result once to bf16; a few ulps where they straddle a rounding
point). The same check must fail against the function with the -10
clamp, which this kernel does not apply. The gradients are in
test_torch_scan_fused_grad.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.scan_fused import selective_scan_fused as jax_scan_fused
from bem_tpu_torch.ops.scan_fused import selective_scan_fused, selective_scan_fused_plain
from bem_tpu_torch.smoke import row_scaled

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

# (Bt, K, C, L, N)
SHAPES = [(2, 4, 16, 64, 1), (2, 4, 40, 100, 1), (1, 4, 8, 32, 16), (1, 4, 8, 4160, 1)]
TOL = {np.float32: 2e-4, jnp.bfloat16: 2e-2}


def _inputs(shape, seed, optionals=True):
    """numpy inputs (u, delta, A, B, C, D, bias) and the probe mask."""
    Bt, K, Cd, L, N = shape
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((Bt, K, Cd, L)).astype(np.float32)
    probe = np.zeros(u.shape, bool)
    probe[:, :, ::3, 1::2] = True
    u[probe] = 0.0
    delta = (0.5 * rng.standard_normal((Bt, K, Cd, L))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, np.log(N + 1), (K * Cd, N))).astype(np.float32)
    B = rng.standard_normal((Bt, K, N, L)).astype(np.float32)
    C = rng.standard_normal((Bt, K, N, L)).astype(np.float32)
    D = rng.standard_normal(K * Cd).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (K, Cd)))
    bias = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    bias[:, ::3] = 12.0
    if not optionals:
        # without the bias, delta itself must carry the large steps
        delta[:, :, ::3] += 12.0
        return (u, delta, A, B, C, None, None), probe
    return (u, delta, A, B, C, D, bias.reshape(-1)), probe


def _jax(args, dtype):
    conv = [None if a is None else jnp.asarray(a, dtype if i in (0, 1, 3, 4) else jnp.float32)
            for i, a in enumerate(args)]
    return np.array(jax_scan_fused(*conv).astype(jnp.float32))


def _torch(args, dtype):
    return [None if a is None else torch.from_numpy(a).to(dtype if i in (0, 1, 3, 4)
                                                          else torch.float32)
            for i, a in enumerate(args)]


@pytest.mark.parametrize("optionals", [True, False], ids=["D_bias", "no_D_bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_pallas(shape, dtype, optionals):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    args, probe = _inputs(shape, seed=sum(shape), optionals=optionals)
    want = torch.from_numpy(_jax(args, jdt))
    ins = _torch(args, tdt)
    got = selective_scan_fused(*ins)
    assert got.shape == shape[:4] and got.dtype == tdt
    probe = torch.from_numpy(probe)
    rel = TOL[np.float32 if dtype == "float32" else jnp.bfloat16]
    err, tol = row_scaled(got, want, rel, probe)
    assert err <= tol, (err, tol)
    # the same check cannot pass the function with the -10 clamp
    clamped = selective_scan_fused_plain(*ins, clamp=True)
    err_c, tol_c = row_scaled(clamped, want, rel, probe)
    assert err_c > 10 * tol_c, (err_c, tol_c)


def test_forward_without_softplus():
    """delta_softplus=False: delta + bias is the step itself (kept positive)."""
    args, probe = _inputs((2, 4, 16, 64, 4), seed=9)
    args = (args[0], np.abs(args[1]), *args[2:])
    want = _jax_nosoftplus(args)
    got = selective_scan_fused(*_torch(args, torch.float32), delta_softplus=False)
    err, tol = row_scaled(got, torch.from_numpy(want), 2e-4, torch.from_numpy(probe))
    assert err <= tol, (err, tol)


def _jax_nosoftplus(args):
    conv = [jnp.asarray(a) for a in args]
    return np.array(jax_scan_fused(*conv, delta_softplus=False))


def test_refuses_unsupported_state_count():
    args, _ = _inputs((1, 4, 8, 16, 1), seed=0)
    u, delta, _, B, C, D, bias = _torch(args, torch.float32)
    with pytest.raises(ValueError, match="d_state"):
        selective_scan_fused(u, delta, -torch.ones(32, 3), B.expand(1, 4, 3, 16),
                             C.expand(1, 4, 3, 16), D, bias)
