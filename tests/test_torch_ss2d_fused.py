"""Kernels 8, 9 and 10 (the 4-direction fused SS2D core, its backward and
its clamped form): the port's wrappers vs bem_tpu's Pallas kernels.

On the CPU the port's wrappers run their plain versions (forward: the
composition on the doubling scan; backward: the gradient formulas of
ss2d_fused_bwd.py written out); bem_tpu runs its Pallas kernels in interpret
mode. Inputs are numpy-seeded, at the scales of tests/test_ss2d_fused_v2.py.
Tolerances: fp32 outputs within 2e-4 of the output's largest entry (sums
in another order, a sequential scan against a blocked doubling one); bf16
within 2 bf16 ulps of it; every gradient within 2e-4 of its largest entry.
The clamped form is held to 2e-6: the clamp moves the output by ~2e-5 of
its largest entry on these inputs, and the two sides agree to ~1e-7; and
per row on smoke's clamp probe, where the clamp moves y by 100 % or more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.ss2d_fused import ss2d_dir_fused as jax_fused
from bem_tpu.ops.ss2d_fused_g import pick_group as jax_pick_group
from bem_tpu.ops.ss2d_fused_g import ss2d_dir_fused_g as jax_fused_g
from bem_tpu_torch import smoke
from bem_tpu_torch.ops import ss2d_fused as pf

NAMES = ("xs2", "Wx", "Wdt", "bias", "A", "D")


def make(B, C, L, R, N, seed=0, clamp=False):
    """(xs2, Wx, Wdt, bias, A, D) fp32; ``clamp`` sets bias +12 on every
    third channel, so dt*A reaches below -10 there."""
    rng = np.random.default_rng(seed)
    P = R + 2 * N
    a = [rng.standard_normal((B, 2, C, L)), rng.standard_normal((4, P, C)) * 0.2,
         rng.standard_normal((4, C, R)) * 0.2, rng.standard_normal((4, C)) * 0.5,
         -np.exp(rng.standard_normal((4, C, N)) * 0.3), rng.standard_normal((4, C))]
    if clamp:
        a[3][:, ::3] = 12.0
    return [x.astype(np.float32) for x in a]


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel} * {scale:.3e}"


def _group(xs2, G):
    """(B, 2, C, L) -> bem_tpu's grouped (B/G, 2, G*C, L) (ss2d.py:455-459)."""
    B, _, C, L = xs2.shape
    return np.stack([xs2[:, s].reshape(B // G, G * C, L) for s in (0, 1)], 1)


def _ungroup(y2g, B):
    return np.stack([np.asarray(y2g)[:, s].reshape(B, -1, y2g.shape[-1]) for s in (0, 1)], 1)


@pytest.mark.parametrize("B,C,L,R,N", [
    (2, 24, 96, 3, 1),     # bem_tpu's shapes (test_ss2d_fused_v2.py:24-31)
    (1, 40, 1296, 3, 1),   # multi-block carry + padding
    (2, 16, 640, 4, 2),    # N=2
    (1, 8, 200, 2, 16),    # d_state 16, as the VMamba-T classifier
])
def test_forward_matches_pallas(B, C, L, R, N):
    a = make(B, C, L, R, N)
    want = jax_fused(*map(jnp.asarray, a))
    _close(pf.ss2d_dir_fused(*map(torch.from_numpy, a)), want, 2e-4, "fp32 forward")


def test_forward_bf16_matches_pallas():
    """The bf16 stream: each direction rounds to bf16 before the sum."""
    a = make(2, 16, 160, 2, 4, seed=1)
    xb = jnp.asarray(a[0], jnp.bfloat16)
    want = jax_fused(xb, *map(jnp.asarray, a[1:])).astype(jnp.float32)
    x = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = pf.ss2d_dir_fused(x, *map(torch.from_numpy, a[1:]))
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, 2 ** -7, "bf16 forward")


@pytest.mark.parametrize("B,C,L,R,N,G", [(4, 16, 64, 2, 4, 4), (6, 64, 96, 2, 1, 2)])
def test_clamped_matches_grouped_pallas(B, C, L, R, N, G):
    """ss2d_dir_fused_g (the -10 clamp) vs the grouped Pallas kernel on
    clamp-hitting inputs with smoke's clamp probe (x zero at the odd
    positions of the clamped channels, where y is the clamped decay alone):
    within 2e-6 of the largest output, and per row (each channel's probe
    positions apart) within 1e-5 of the row's largest entry; the unclamped
    form misses the per-row check by orders of magnitude."""
    assert jax_pick_group(B, C) == pf.pick_group(B, C) == G
    a = make(B, C, L, R, N, seed=2, clamp=True)
    probe = torch.from_numpy(smoke._clamp_probe(a[0]))
    want = _ungroup(jax_fused_g(jnp.asarray(_group(a[0], G)), *map(jnp.asarray, a[1:]), G), B)
    ta = list(map(torch.from_numpy, a))
    for got in (pf.ss2d_dir_fused_g(*ta), pf.ss2d_dir_fused(*ta, clamp=True)):
        _close(got, want, 2e-6, "clamped forward")
        err, tol = smoke.row_scaled(got, torch.from_numpy(want), 1e-5, probe)
        assert err <= tol, f"clamped forward per row: {err:.3e} > {tol:.3e}"
    err, tol = smoke.row_scaled(pf.ss2d_dir_fused(*ta), torch.from_numpy(want), 1e-5, probe)
    assert err > 100 * tol, "the probe does not reveal the clamp"


def test_smoke_check_catches_a_kernel_ignoring_the_clamp():
    """smoke.compare's check of the fused forward: the plain version passes
    it (the CPU runs the plain version for the kernel) and fails the other
    clamp setting (``other_clamp`` > 1); a 'kernel' that ignored the clamp
    flag, or the bf16 rounding of the normal channels, would fail it."""
    for case in smoke._cls_cases("small", 2, 24, 6, 10, 2, 16, "cpu", seed=0):
        err, tol = smoke.compare(case)
        assert err <= tol
        if case.name != "ss2d_dir_fused_bwd":
            assert case.other_clamp > 10, (case.name, case.dtype, case.other_clamp)
        if case.name == "ss2d_dir_fused_g":
            ref = case.plain(*case.args)
            ignored = pf.ss2d_dir_fused_plain(*case.args, clamp=False)
            err, tol = smoke.row_scaled(ignored, ref, smoke.TOL[case.dtype], case.probe)
            assert err > 10 * tol, (case.dtype, err, tol)
            # four tolerances off on a normal channel's largest entry: far below
            # the scale of the clamped channels, where a global scale would sit
            row = case.probe.logical_not() & (torch.arange(24) % 3 != 0)[None, None, :, None]
            bad = ref.clone()
            i = int(torch.where(row, ref.float().abs(), 0.0).argmax())
            bad.view(-1)[i] = bad.view(-1)[i].float() * (1 + 4 * smoke.TOL[case.dtype])
            err, tol = smoke.row_scaled(bad, ref, smoke.TOL[case.dtype], case.probe)
            assert err > tol, (case.dtype, err, tol)


def test_pick_group_and_counts():
    """pick_group is bem_tpu's (256 budget); the CPU path launches nothing."""
    for B in (1, 2, 3, 4, 6, 8, 16, 128):
        for C in (16, 32, 64, 128, 192, 1536):
            assert pf.pick_group(B, C) == jax_pick_group(B, C)
    before = (pf.ss2d_dir_fused.launches, pf.ss2d_dir_fused_g.launches,
              pf.ss2d_dir_fused_bwd.launches)
    a = list(map(torch.from_numpy, make(1, 8, 32, 2, 1)))
    pf.ss2d_dir_fused(*a)
    pf.ss2d_dir_fused_g(*a)
    assert before == (pf.ss2d_dir_fused.launches, pf.ss2d_dir_fused_g.launches,
                      pf.ss2d_dir_fused_bwd.launches)
