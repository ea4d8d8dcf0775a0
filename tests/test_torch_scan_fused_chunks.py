"""Kernel 11's chunked scan (csrc/scan_fused.cu), pinned on the CPU.

No kernel runs here, so this file mirrors the card's three passes in plain
PyTorch over super-chunks of S positions (S a multiple of the 32-position
chunk the kernels stage), per sequence m = image * K + direction:

  1. summaries: per super-chunk and (channel, state), the decay
     exp(sum of dt A_n) and the end state from h = 0, in the kernels'
     (M, m, C*N) layout;
  2. the carry: ``linear_scan_plain`` forward over the super-chunks;
  3. every super-chunk walked from the state entering it (0 for the
     first), y = sum_n C_n h_n + D u rounded once to u's dtype.

The mirror's y is held against the port's plain version
(``selective_scan_fused_plain``, bem_tpu's unfolded composition) and
against bem_tpu's ``selective_scan_fused`` (its Pallas kernel in
interpret mode), on test_torch_scan_fused's numpy-seeded inputs: every
third channel's dt bias +12 so that dt*A < -10 there, u zero at every
other position of those channels (the clamp probe, whose elements are
held as rows of their own, as chip_smoke.py does). The same check must
fail against the function with the -10 clamp, which this kernel does not
apply.

Cases: one super-chunk (S >= L), two, and several with a ragged last one
(S = 32 and 64 positions); N = 1, 4 and 16; fp32 and bf16; with and
without D and the dt bias. Tolerances: smoke.TOL (fp32 2e-4, bf16 2e-2)
of each (image, direction, channel) row's largest entry.
"""

import jax
import numpy as np
import pytest
import torch

from bem_tpu_torch import smoke
from bem_tpu_torch.ops.scan import linear_scan_plain
from bem_tpu_torch.ops.scan_fused import selective_scan_fused_plain
from bem_tpu_torch.ops.ss2d_fused import _softplus

from test_torch_scan_fused import _inputs, _jax, _torch

CK = 32
FP32, BF16 = torch.float32, torch.bfloat16
JDT = {FP32: np.float32, BF16: "bfloat16"}


@pytest.fixture(autouse=True, scope="module")
def _drop_interpret_traces():
    """Drop the jitted interpret-mode traces when the module ends, so that a
    later test lowering the same shapes for the TPU does not reuse them."""
    yield
    jax.clear_caches()


def chunked_scan(u, delta, A, B, C, D, bias, S, softplus=True):
    """The mirror of the card's passes at super-chunks of S positions: y
    (Bt, K, C, L) in u's dtype."""
    Bt, K, Cd, L = u.shape
    N = A.shape[-1]
    M, m = Bt * K, -(-L // S)
    dt = delta.float()
    if bias is not None:
        dt = dt + bias.reshape(1, K, Cd, 1)
    if softplus:
        dt = _softplus(dt)
    uf = u.float().reshape(M, Cd, L)
    dt = dt.reshape(M, Cd, L)
    Am = A.reshape(1, K, Cd, N).expand(Bt, K, Cd, N).reshape(M, Cd, N)
    w = dt[..., None] * Am[:, :, None]                                   # (M, C, L, N)
    b = (dt * uf)[..., None] * B.float().reshape(M, N, L).transpose(1, 2)[:, None]
    Cr = C.float().reshape(M, N, L)
    # pass 1: each super-chunk from h = 0
    summ = torch.zeros(2, M, m, Cd, N)  # decay | end state
    for j in range(m):
        h = torch.zeros(M, Cd, N)
        for t in range(j * S, min(L, (j + 1) * S)):
            h = torch.exp(w[:, :, t]) * h + b[:, :, t]
        summ[0, :, j] = torch.exp(w[:, :, j * S:(j + 1) * S].sum(2))
        summ[1, :, j] = h
    # pass 2: the state leaving each super-chunk
    carry = linear_scan_plain(*(q.reshape(M, m, Cd * N) for q in summ)).reshape(M, m, Cd, N)
    # pass 3: every super-chunk from the state entering it
    y = torch.zeros(M, Cd, L)
    Dm = (torch.zeros(M, Cd) if D is None
          else D.reshape(1, K, Cd).expand(Bt, K, Cd).reshape(M, Cd))
    for j in range(m):
        h = carry[:, j - 1] if j else torch.zeros(M, Cd, N)
        for t in range(j * S, min(L, (j + 1) * S)):
            h = torch.exp(w[:, :, t]) * h + b[:, :, t]
            y[:, :, t] = (h * Cr[:, None, :, t]).sum(-1) + Dm * uf[:, :, t]
    return y.reshape(Bt, K, Cd, L).to(u.dtype)


# (Bt, K, C, L, N): L a multiple of 32, not a multiple (ragged last chunk
# and super-chunk), shorter than 64; N = 1, 4, 16
SHAPES = [(2, 4, 16, 96, 1), (1, 4, 12, 101, 4), (1, 4, 8, 49, 16)]


@pytest.mark.parametrize("optionals", [True, False], ids=["D_bias", "no_D_bias"])
@pytest.mark.parametrize("dtype", [FP32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_chunked_scan_matches_plain_and_pallas(shape, dtype, optionals):
    args, probe = _inputs(shape, seed=3 * sum(shape), optionals=optionals)
    ins = _torch(args, dtype)
    probe = torch.from_numpy(probe)
    plain = selective_scan_fused_plain(*ins)
    pallas = torch.from_numpy(_jax(args, JDT[dtype]))
    clamped = selective_scan_fused_plain(*ins, clamp=True)
    tol = smoke.TOL[dtype]
    L = shape[3]
    for S in sorted({CK, 2 * CK, -(-L // CK) * CK}):
        y = chunked_scan(*ins, S)
        assert y.shape == ins[0].shape and y.dtype == dtype
        for ref, what in ((plain, "plain"), (pallas, "Pallas")):
            err, bound = smoke.row_scaled(y, ref, tol, probe)
            assert err <= bound, f"y vs {what}, S={S}: {err:.3e} > {bound:.3e}"
        # the probe sees the clamp the function does not have
        err, bound = smoke.row_scaled(y, clamped, tol, probe)
        assert err > bound, f"S={S}: the mirror matches the clamped function"


def test_chunked_scan_without_softplus():
    """delta_softplus=False: delta + bias is the step itself (kept positive)."""
    args, probe = _inputs((2, 4, 16, 70, 4), seed=9)
    args = (args[0], np.abs(args[1]), *args[2:])
    ins = _torch(args, FP32)
    plain = selective_scan_fused_plain(*ins, delta_softplus=False)
    for S in (CK, 3 * CK):
        err, bound = smoke.row_scaled(chunked_scan(*ins, S, softplus=False), plain,
                                      smoke.TOL[FP32], torch.from_numpy(probe))
        assert err <= bound, (S, err, bound)
