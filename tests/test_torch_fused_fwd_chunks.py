"""Kernels 8 and 10's chunked forward scan (csrc/ss2d_fused.cu), pinned on the CPU.

No kernel runs here, so this file mirrors the forward's three passes in
plain PyTorch, per direction in its scan order (position i for direction
0, L - 1 - i for direction 1), over super-chunks of S positions (S a
multiple of the 32-position checkpoint chunk):

  1. summaries: per super-chunk, (image, stream, direction) and (channel,
     state), the decay exp(sum of w), w = dt A_n (max(w, -10) under the
     clamp), and the end state from h = 0, in the kernels' (B*2*2, m,
     C*N) layout;
  2. the carry: ``linear_scan_plain`` forward over the super-chunks;
  3. every super-chunk walked from the state entering it (0 for the
     first), writing y and the state entering every 32-position chunk;
     direction 0's y rounded to the stream dtype, direction 1's rounded
     y added to it and the sum rounded, cast(cast(y_f) + cast(y_r)).

The mirror's y is held against the port's plain version
(``ss2d_dir_fused_plain``) and against bem_tpu's ``ss2d_dir_fused`` and
``ss2d_dir_fused_g`` (Pallas interpret mode), and its checkpoints against
``fused_checkpoints_plain`` (the plain scan's state entering every chunk),
on the same numpy-seeded inputs.

Cases: L a multiple of 32, not a multiple, shorter than 32; super-chunks of
32 and 64 positions and one >= L (no summary pass, no carry); N = 1, 4 and
16; fp32 and bf16 (d_state 16 on fp32 only: its two Pallas calls take ~13
s in interpret mode); smoke's clamp probe (bias +12 on every third channel, x
zero at their odd positions), where the clamped mirror must miss the
unclamped function. Tolerances: smoke.TOL (fp32 2e-4, bf16 2e-2) of each
row's largest entry, as smoke.compare holds the fused forward (y per
(image, stream, channel) with the probe's positions apart; the fp32
checkpoints per (image, stream, direction, channel) over chunks and
states, as smoke.compare_checkpoints holds them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.ss2d_fused import ss2d_dir_fused as jax_fused
from bem_tpu.ops.ss2d_fused_g import ss2d_dir_fused_g as jax_fused_g
from bem_tpu_torch import smoke
from bem_tpu_torch.ops import ss2d_fused as pf
from bem_tpu_torch.ops.scan import linear_scan_plain

from test_torch_ss2d_fused import _group, _ungroup

CK = pf.CKPT
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _drop_interpret_traces():
    """Drop the jitted interpret-mode traces when the module ends, so that a
    later test lowering the same shapes for the TPU does not reuse them."""
    yield
    jax.clear_caches()


def _operands(x, Wx, Wdt, bias, A, clamp):
    """One direction in its scan order: log-decays w, inputs b (B, C, L, N)
    and the readout rows (B, L, N)."""
    N = A.shape[-1]
    R = Wdt.shape[-1]
    xd = torch.einsum("pc,bcl->bpl", Wx, x)
    dt = pf._softplus(torch.einsum("cr,brl->bcl", Wdt, xd[:, :R]) + bias[None, :, None])
    w = dt[..., None] * A[None, :, None]
    if clamp:
        w = torch.clamp(w, min=pf.W_CLAMP)
    b = (dt * x)[..., None] * xd[:, R:R + N].transpose(1, 2)[:, None]
    return w, b, xd[:, R + N:].transpose(1, 2)


def chunked_fwd(xs2, Wx, Wdt, bias, A, D, S, clamp):
    """The mirror of the forward's passes at super-chunks of S positions:
    (y2 in xs2.dtype, checkpoints (B, 2, 2, ceil(L / 32), C, N) fp32)."""
    B, _, C, L = xs2.shape
    N = A.shape[-1]
    m, nck = -(-L // S), -(-L // CK)
    seqs = {}
    summ = torch.zeros(2, B, 2, 2, m, C, N)  # decay | end state
    for s in (0, 1):
        for d in (0, 1):  # direction k = s + 2 d
            k = s + 2 * d
            x = xs2[:, s].float()
            x = x.flip(-1) if d else x
            w, b, cr = _operands(x, Wx[k], Wdt[k], bias[k], A[k], clamp)
            seqs[s, d] = (x, w, b, cr, D[k])
            for j in range(m):  # pass 1: each super-chunk from h = 0
                h = torch.zeros(B, C, N)
                for t in range(j * S, min(L, (j + 1) * S)):
                    h = torch.exp(w[:, :, t]) * h + b[:, :, t]
                summ[0, :, s, d, j] = torch.exp(w[:, :, j * S:(j + 1) * S].sum(2))
                summ[1, :, s, d, j] = h
    # pass 2: the carry over the (B*2*2, m, C*N) rows, row (b, s, d)
    carry = linear_scan_plain(*(q.reshape(B * 4, m, C * N) for q in summ)).reshape(
        B, 2, 2, m, C, N)
    ck = torch.zeros(B, 2, 2, nck, C, N)
    ys = {}
    for (s, d), (x, w, b, cr, Dk) in seqs.items():  # pass 3
        y = torch.zeros(B, C, L)
        for j in range(m):
            h = carry[:, s, d, j - 1] if j else torch.zeros(B, C, N)
            for t in range(j * S, min(L, (j + 1) * S)):
                if t % CK == 0:
                    ck[:, s, d, t // CK] = h
                h = torch.exp(w[:, :, t]) * h + b[:, :, t]
                y[:, :, t] = (h * cr[:, None, t]).sum(-1) + Dk[None] * x[:, :, t]
        ys[s, d] = y.flip(-1) if d else y
    dt = xs2.dtype
    y2 = torch.stack([(ys[s, 0].to(dt).float() + ys[s, 1].to(dt).float()).to(dt)
                      for s in (0, 1)], 1)
    return y2, ck


def _ck_rows(t):
    """(B, 2, 2, nck, C, N) -> rows per (image, stream, direction, channel)."""
    return t.permute(0, 1, 2, 4, 3, 5).flatten(4)


FP32, BF16 = torch.float32, torch.bfloat16
CASES = [  # (B, C, L, R, N, dtype)
    (2, 24, 64, 2, 1, FP32),    # L a multiple of 32
    (2, 24, 64, 2, 1, BF16),
    (2, 16, 97, 2, 4, FP32),    # L not a multiple: partial last chunk and super-chunk
    (2, 16, 97, 2, 4, BF16),
    (2, 8, 20, 2, 16, FP32),    # L shorter than one chunk, d_state 16
    (1, 12, 70, 3, 1, FP32),    # one image (no batch group)
    (1, 12, 70, 3, 1, BF16),
]


@pytest.mark.parametrize("B,C,L,R,N,dtype", CASES)
def test_chunked_fwd_matches_plain_and_pallas(B, C, L, R, N, dtype):
    rng = np.random.default_rng(L + N)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = rng.standard_normal((B, 2, C, L)).astype(np.float32)
    xs2 = x / (1.0 + np.exp(-x))
    probe = torch.from_numpy(smoke._clamp_probe(xs2))
    w = smoke._fused_weights(rng, C, R, N, t)
    xs = t(xs2).to(dtype)
    wj = [jnp.asarray(a.numpy()) for a in w]
    xj = jnp.asarray(xs.float().numpy()).astype(JDT[dtype])
    G = pf.pick_group(B, C)
    pallas = {False: jax_fused(xj, *wj),
              True: _ungroup(jax_fused_g(jnp.asarray(_group(np.asarray(xj), G)), *wj, G), B)}
    tol = smoke.TOL[dtype]
    for clamp in (False, True):
        plain = pf.ss2d_dir_fused_plain(xs, *w, clamp=clamp)
        want = torch.from_numpy(np.array(jnp.asarray(pallas[clamp]).astype(jnp.float32)))
        ck_plain = pf.fused_checkpoints_plain(xs, *w, clamp=clamp)
        for S in sorted({CK, 2 * CK, -(-L // CK) * CK}):
            y, ck = chunked_fwd(xs, *w, S, clamp)
            assert y.dtype == dtype and ck.shape == ck_plain.shape
            for ref, what in ((plain, "plain"), (want, "Pallas")):
                err, bound = smoke.row_scaled(y, ref, tol, probe)
                assert err <= bound, f"y vs {what}, S={S} clamp={clamp}: {err:.3e} > {bound:.3e}"
            err, bound = smoke.row_scaled(_ck_rows(ck), _ck_rows(ck_plain), smoke.TOL[FP32])
            assert err <= bound, f"checkpoints, S={S} clamp={clamp}: {err:.3e} > {bound:.3e}"
            if clamp:  # the probe sees the clamp
                other = pf.ss2d_dir_fused_plain(xs, *w, clamp=False)
                err, bound = smoke.row_scaled(y, other, tol, probe)
                assert err > bound, f"S={S}: the clamped mirror matches the unclamped function"
