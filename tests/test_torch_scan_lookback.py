"""linear_scan's single-pass design, mirrored in torch on the CPU.

The CUDA kernel (bem_tpu_torch/csrc/scan.cu) runs each call as one launch
planned by ``scan_plan``: a walk per (sequence, channel) for short L, or
scan_lookback_kernel, whose blocks take chunks of P * SCAN_SEG positions x
DT channels, reduce each thread's segment and then the chunk to an
aggregate (prod a, the end state from 0), and find the state entering the
chunk in a fixed order: group g - 1's anchor state (the anchors, every
SCAN_ANCHOR-th chunk, publish their inclusive state), then the chunk's
group predecessors' aggregates, folded by the P threads of a channel in
consecutive ranges that the lead composes in order. This file mirrors
that arithmetic step for step (fp32) and holds it against
``linear_scan_plain`` and bem_tpu's ``_linear_scan_pallas`` in interpret
mode (rtol 1e-5, as test_torch_scan.py), forward and reverse, with L
below, at and off a multiple of the chunk, several anchor groups, D = 40
and 3072, decays in (0.9, 1) with exact zeros; and shows that the
entering states do not depend on the order in which chunks publish.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.scan import _linear_scan_pallas as jax_scan_pallas
from bem_tpu_torch.ops.scan import (SCAN_ANCHOR, SCAN_SEG, SCAN_THREADS, ScanPlan,
                                    linear_scan, linear_scan_plain, scan_plan)


@pytest.fixture(autouse=True, scope="module")
def _drop_interpret_traces():
    """Drop the interpret-mode traces of bem_tpu's jitted Pallas scan (see
    test_torch_scan.py): a later test lowering the same shapes for the TPU
    must not reuse them."""
    yield
    jax_scan_pallas.clear_cache()


def _inputs(M, L, D, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.9, 1.0, (M, L, D)).astype(np.float32)
    a[rng.random((M, L, D)) < 0.01] = 0.0  # states that restart
    b = rng.standard_normal((M, L, D)).astype(np.float32)
    return a, b


def _compose(fa, fb, va, vb):
    """(fa, fb) followed by (va, vb): the kernel's fb = fmaf(va, fb, vb),
    fa *= va (in fp32, unfused here)."""
    return fa * va, va * fb + vb


def mirror(a, b, reverse, plan, order=None):
    """h of the kernel's plan for (M, L, D) fp32 a, b (torch). ``order``: a
    permutation of the chunks in which the look-back form's blocks reach
    their entering states (a chunk whose anchor has not published waits,
    i.e. goes to the back of the queue)."""
    M, L, D = a.shape
    if reverse:  # the kernel walks positions back to front: the same arithmetic
        return mirror(a.flip(1), b.flip(1), False, plan, order).flip(1)
    if plan.walk:
        h, hv = torch.empty_like(a), torch.zeros_like(a[:, 0])
        for t in range(L):
            hv = a[:, t] * hv + b[:, t]
            h[:, t] = hv
        return h
    P, nch, K = plan.P, plan.nch, SCAN_ANCHOR
    T = P * SCAN_SEG
    pad = nch * T - L  # identity steps past L (a = 1, b = 0)
    ap = torch.cat([a, a.new_ones(M, pad, D)], 1).reshape(M, nch, P, SCAN_SEG, D)
    bp = torch.cat([b, b.new_zeros(M, pad, D)], 1).reshape(M, nch, P, SCAN_SEG, D)
    # each thread's segment from 0, then the chunk's aggregate and each
    # segment's exclusive prefix (the lead's walk over the P segments)
    sa, sb = ap.new_ones(M, nch, P, D), ap.new_zeros(M, nch, P, D)
    for k in range(SCAN_SEG):
        sa, sb = _compose(sa, sb, ap[:, :, :, k], bp[:, :, :, k])
    ea, eb = torch.empty_like(sa), torch.empty_like(sb)
    ga, gb = ap.new_ones(M, nch, D), ap.new_zeros(M, nch, D)
    for s in range(P):
        ea[:, :, s], eb[:, :, s] = ga, gb
        ga, gb = _compose(ga, gb, sa[:, :, s], sb[:, :, s])
    # the entering states, chunk by chunk in ``order``
    pre, h_in = {}, {}
    queue = list(order if order is not None else range(nch))
    while queue:
        j = queue.pop(0)
        g = j // K
        if g > 0 and g - 1 not in pre:
            queue.append(j)  # waits for its anchor
            continue
        j0, n = g * K, j - g * K
        rr = -(-n // P)
        hv = pre[g - 1] if g > 0 else ap.new_zeros(M, D)
        for p in range(P):  # thread p folds j0 + p rr .. (< j), the lead composes
            fa, fb = ap.new_ones(M, D), ap.new_zeros(M, D)
            for i in range(j0 + p * rr, min(j, j0 + (p + 1) * rr)):
                fa, fb = _compose(fa, fb, ga[:, i], gb[:, i])
            hv = fa * hv + fb
        h_in[j] = hv
        if j % K == K - 1 and j + 1 < nch:
            pre[g] = ga[:, j] * hv + gb[:, j]
    hin = torch.stack([h_in[j] for j in range(nch)], 1)       # (M, nch, D)
    hv = ea * hin[:, :, None] + eb                              # entering each segment
    h = torch.empty_like(ap)
    for k in range(SCAN_SEG):
        hv = ap[:, :, :, k] * hv + bp[:, :, :, k]
        h[:, :, :, k] = hv
    return h.reshape(M, nch * T, D)[:, :L]


def _lookback(M, L, D):
    """The look-back plan for these sizes, also where scan_plan would walk."""
    plan = scan_plan(M, L, D)
    if plan.walk:
        DT = min(D, SCAN_THREADS)
        P = SCAN_THREADS // DT
        plan = ScanPlan(False, DT, P, -(-L // (P * SCAN_SEG)))
    return plan


# (M, L, D): D = 40 (chunks of 96): below, at and off the chunk, two anchor
# groups; D = 3072 (one-thread segments of 16, 12 channel tiles): below
# and off the chunk
CASES = [(2, 50, 40), (2, 96, 40), (3, 203, 40), (2, 96 * 33 + 7, 40),
         (2, 10, 3072), (2, 83, 3072)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("M,L,D", CASES)
def test_mirror_matches_plain_and_pallas(M, L, D, reverse):
    a, b = _inputs(M, L, D, seed=L + D)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    ref = linear_scan_plain(at, bt, reverse)
    pal = np.asarray(jax_scan_pallas(jnp.asarray(a), jnp.asarray(b), reverse=reverse))
    for plan in {scan_plan(M, L, D), _lookback(M, L, D)}:
        out = mirror(at, bt, reverse, plan)
        assert out.shape == (M, L, D)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out.numpy(), pal, rtol=1e-5, atol=1e-5)
    # the wrapper on the CPU is the plain version
    torch.testing.assert_close(linear_scan(at, bt, reverse), ref, rtol=0, atol=0)


def test_entering_states_do_not_depend_on_publish_order():
    """The look-back's entering states are a fixed composition: chunks
    reaching them in any order (waiting on unpublished anchors) give the
    same bits; and the mirror misses the plain scan in the other
    direction (the test sees the direction)."""
    M, L, D = 2, 96 * 70 + 5, 40  # 71 chunks, 3 anchor groups
    a, b = (torch.from_numpy(x) for x in _inputs(M, L, D, seed=3))
    plan = _lookback(M, L, D)
    assert plan.nch > 2 * SCAN_ANCHOR
    base = mirror(a, b, False, plan)
    rng = np.random.default_rng(0)
    for _ in range(3):
        order = rng.permutation(plan.nch).tolist()
        assert torch.equal(mirror(a, b, False, plan, order), base)
    ref = linear_scan_plain(a, b, False)
    assert (base - ref).abs().max() <= 1e-5 * ref.abs().max()
    other = linear_scan_plain(a, b, True)
    assert (base - other).abs().max() > 1e-2 * other.abs().max()


def test_plan_forms():
    """Short or many sequences walk; long ones take the look-back form with
    all SCAN_THREADS threads of a block on (channels x segments)."""
    assert scan_plan(2, 35, 40).walk and scan_plan(8, 17, 3072).walk
    assert scan_plan(512, 98, 3072).walk  # M * D alone fills the card
    p = scan_plan(8, 16384, 40)
    assert not p.walk and (p.DT, p.P) == (40, 6) and p.nch == -(-16384 // 96)
    p = scan_plan(2, 300, 3072)
    assert not p.walk and (p.DT, p.P, p.nch) == (256, 1, -(-300 // SCAN_SEG))
