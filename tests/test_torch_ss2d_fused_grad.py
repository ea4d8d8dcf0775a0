"""Kernel 9 (the fused SS2D core's backward): the port's gradients vs
bem_tpu's custom VJPs (run_bwd in Pallas interpret mode), and the plain
backward's formulas vs torch autograd. Inputs and tolerances as in
test_torch_ss2d_fused.py (every gradient within 2e-4 of its largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.ss2d_fused import ss2d_dir_fused as jax_fused
from bem_tpu.ops.ss2d_fused_g import ss2d_dir_fused_g as jax_fused_g
from bem_tpu_torch.ops import ss2d_fused as pf

from test_torch_ss2d_fused import NAMES, _close, _group, _ungroup, make
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def _port_grads(fn, a, g):
    ts = [torch.from_numpy(x).requires_grad_() for x in a]
    return torch.autograd.grad(fn(*ts), ts, torch.from_numpy(g))


@pytest.mark.parametrize("B,C,L,R,N", [(1, 16, 96, 3, 1), (2, 8, 160, 2, 16)])
def test_gradients_match_pallas_vjp(B, C, L, R, N):
    """All six gradients of the autograd wrapper vs jax.vjp through
    bem_tpu's custom VJP (run_bwd in interpret mode)."""
    a = make(B, C, L, R, N, seed=3)
    g = np.random.default_rng(4).standard_normal((B, 2, C, L)).astype(np.float32)
    _, vjp = jax.vjp(jax_fused, *map(jnp.asarray, a))
    for name, got, want in zip(NAMES, _port_grads(pf.ss2d_dir_fused, a, g), vjp(jnp.asarray(g))):
        _close(got, want, 2e-4, f"d{name}")


def test_clamped_gradients_are_unclamped_vjp():
    """The clamped form's gradient is the unclamped function's
    (ss2d_fused_g.py:323-339), on clamp-hitting inputs."""
    B, C, L, R, N, G = 4, 8, 64, 2, 4, 4
    a = make(B, C, L, R, N, seed=5, clamp=True)
    g = np.random.default_rng(6).standard_normal((B, 2, C, L)).astype(np.float32)
    jx = [jnp.asarray(_group(a[0], G))] + list(map(jnp.asarray, a[1:]))
    _, vjp = jax.vjp(lambda *t: jax_fused_g(*t, G), *jx)
    want = list(vjp(jnp.asarray(_group(g, G))))
    want[0] = _ungroup(want[0], B)
    for name, got, w in zip(NAMES, _port_grads(pf.ss2d_dir_fused_g, a, g), want):
        _close(got, w, 2e-4, f"d{name}")


def test_backward_formulas_match_autograd():
    """The plain backward (kernel 9's formulas) vs torch autograd through
    the plain forward (2e-5: one fp32 computation in two orders), and the
    bf16 stream's gradient dtypes."""
    a = make(2, 8, 70, 2, 4, seed=7)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 2, 8, 70)).astype(np.float32))
    ts = [torch.from_numpy(x).requires_grad_() for x in a]
    want = torch.autograd.grad(pf.ss2d_dir_fused_plain(*ts), ts, g)
    got = pf.ss2d_dir_fused_bwd(*[t.detach() for t in ts], g)
    for name, u, w in zip(NAMES, got, want):
        _close(u.numpy(), w.numpy(), 2e-5, f"d{name}")
    xb = torch.from_numpy(a[0]).to(torch.bfloat16)
    grads = pf.ss2d_dir_fused_bwd(xb, *map(torch.from_numpy, a[1:]), g)
    assert grads[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in grads[1:])
