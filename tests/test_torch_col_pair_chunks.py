"""The column pair's chunked, parallel-in-H scan (csrc/ss2d_col.cu), pinned on the CPU.

No kernel runs here, so this file mirrors the kernels' passes in plain
PyTorch, walking rows one at a time as the kernels do, and holds the
mirror against the port's plain version (``ss2d_col_pair_plain``, one
chunk per column) and against bem_tpu's ``ss2d_col_pair_g`` in Pallas
interpret mode, on the same numpy-seeded inputs:

  1. col_sum: every column walked top-down, restarting at each chunk of T
     rows: per chunk and direction the decay exp(sum of clamped
     log-decays) and the end state from 0 (forward: the chunk's bottom
     row; reverse, bottom-up: its top row, as the prefix sum acc += P b,
     P *= a of the same top-down walk), in the (B, W*nch, C*N) layout;
  2. the carry: ``linear_scan_plain`` over the column-major sequence of
     chunks (index w*nch + k), forward for direction 1, reverse for 3;
  3. col_full: every chunk walked top-down from the inclusive state of
     chunk j - 1, storing round(y_f + (D_1 + D_3) x + y0), then bottom-up
     from that of chunk j + 1, storing round(y_r + the stored value).

The mirror's summaries and output are also held against the port's plain
passes (``ss2d_col_sum_plain`` / ``ss2d_col_dir_plain``) at the same T:
the composition the card runs.

Cases: H a multiple of T, not a multiple, shorter than T; W not a multiple
of 32; with and without y0; N = 1, 2 and 4; fp32 and bf16; the clamp
probe (bias +12 on every third channel, x zero at their odd rows), where
the mirror must miss the unclamped function. Tolerances: smoke.TOL, fp32
2e-4 and bf16 2e-2 of the output's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.ss2d_seq import ss2d_col_pair_g as jax_col_pair
from bem_tpu_torch.ops import ss2d_seq as seq
from bem_tpu_torch.ops.scan import linear_scan_plain
from bem_tpu_torch.smoke import TOL

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _drop_interpret_traces():
    """Drop the jitted interpret-mode traces when the module ends, so that a
    later test lowering the same shapes for the TPU does not reuse them."""
    yield
    jax.clear_caches()


def _weights(C, R, N, seed, clamp):
    rng = np.random.default_rng(seed)
    P = R + 2 * N
    bias = rng.standard_normal((4, C)) * 0.5
    A = -np.exp(rng.standard_normal((4, C, N)) * 0.3)
    if clamp:  # dt ~ softplus(12), A = -1: dt * A ~ -12 on these channels
        bias[:, ::3] = 12.0
        A[:, ::3] = -1.0
    w = (rng.standard_normal((4, P, C)) * 0.2, rng.standard_normal((4, C, R)) * 0.2, bias, A,
         rng.standard_normal((4, C)))
    return [a.astype(np.float32) for a in w]


def _layout(t):
    """(B, C, nch, W, N) -> (B, W*nch, C*N)."""
    B, C, nch, W, N = t.shape
    return t.permute(0, 3, 2, 1, 4).reshape(B, W * nch, C * N)


def _operands(x, dirw, clamp):
    """(xdbl, w, b) of one direction: w, b (B, C, H, W, N)."""
    Wx, Wdt, bias, A = dirw[:4]
    xdbl, w, b = seq._decay_input(x, Wx, Wdt, bias, A, clamp)
    return xdbl, torch.stack(w, -1), torch.stack(b, -1)


def chunked_col_pair(xrow, Wx, Wdt, bias, A, D, y0, H, W, T, clamp=True):
    """The mirror of the kernels' passes, fp32 inside. Returns (y, the four
    summaries)."""
    fwd, rev = seq._col_args(xrow, Wx, Wdt, bias, A, D, y0, H, W)
    B, C, _ = xrow.shape
    N = A.shape[-1]
    R = Wx.shape[1] - 2 * N
    nch = -(-H // T)
    x = xrow.float().reshape(B, C, H, W)
    (xd_f, w_f, b_f), (xd_r, w_r, b_r) = _operands(x, fwd, clamp), _operands(x, rev, clamp)
    # pass 1: one top-down walk, restarting at every chunk
    zeros = torch.zeros(B, C, W, N)
    sums = [torch.zeros(B, C, nch, W, N) for _ in range(4)]
    hf, swf, acc, pr, swr = zeros, zeros, zeros, zeros + 1, zeros
    for row in range(H):
        hf = torch.exp(w_f[:, :, row]) * hf + b_f[:, :, row]
        swf = swf + w_f[:, :, row]
        acc = acc + pr * b_r[:, :, row]
        pr = pr * torch.exp(w_r[:, :, row])
        swr = swr + w_r[:, :, row]
        if (row + 1) % T == 0 or row + 1 == H:
            k = row // T
            for s, v in zip(sums, (torch.exp(swf), hf, torch.exp(swr), acc)):
                s[:, :, k] = v
            hf, swf, acc, pr, swr = zeros, zeros, zeros, zeros + 1, zeros
    sums = [_layout(s) for s in sums]
    # pass 2: the carry over the column-major chunk sequence
    h_f = linear_scan_plain(sums[0], sums[1], False).reshape(B, W, nch, C, N)
    h_r = linear_scan_plain(sums[2], sums[3], True).reshape(B, W, nch, C, N)
    # pass 3: every chunk from its neighbour's inclusive state
    y1 = torch.zeros(B, C, H, W)
    y = torch.zeros(B, C, H, W)
    Dsum = fwd[4].reshape(1, C, 1)
    for k in range(nch):
        rows = range(k * T, min(k * T + T, H))
        h = torch.zeros(B, C, W, N)
        for w in range(W):  # the entering state: chunk j - 1, j = w * nch + k
            j = w * nch + k - 1
            if j >= 0:
                h[:, :, w] = h_f[:, j // nch, j % nch]
        for row in rows:
            h = torch.exp(w_f[:, :, row]) * h + b_f[:, :, row]
            v = (h * xd_f[:, R + N:, row].permute(0, 2, 1)[:, None]).sum(-1)
            v = v + Dsum * x[:, :, row]
            if y0 is not None:
                v = v + y0.float().reshape(B, C, H, W)[:, :, row]
            y1[:, :, row] = v.to(xrow.dtype).float()
        h = torch.zeros(B, C, W, N)
        for w in range(W):  # chunk j + 1
            j = w * nch + k + 1
            if j < W * nch:
                h[:, :, w] = h_r[:, j // nch, j % nch]
        for row in reversed(rows):
            h = torch.exp(w_r[:, :, row]) * h + b_r[:, :, row]
            v = (h * xd_r[:, R + N:, row].permute(0, 2, 1)[:, None]).sum(-1)
            y[:, :, row] = (v + y1[:, :, row]).to(xrow.dtype).float()
    return y.reshape(B, C, H * W).to(xrow.dtype), sums


def _close(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype] * ref.float().abs().max().item()
    assert err <= tol, (err, tol)


def _inputs(B, C, H, W, N, seed, clamp, with_y0):
    w = _weights(C, -(-C // 16), N, seed, clamp)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((B, C, H * W)).astype(np.float32)
    x = x / (1.0 + np.exp(-x))  # the stem's SiLU output
    y0 = rng.standard_normal((B, C, H * W)).astype(np.float32) * 2.0 if with_y0 else None
    return w, x, y0


CASES = [  # (B, C, H, W, N, T, with_y0)
    (2, 16, 16, 20, 1, 8, True),    # H a multiple of T, W not of 32
    (1, 40, 13, 37, 2, 4, False),   # H not a multiple of T
    (2, 24, 5, 33, 4, 8, True),     # H shorter than one chunk
    (1, 16, 28, 40, 1, 32, False),  # CG-L0's 28x40 at the kernel's T = 32
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,W,N,T,with_y0", CASES)
def test_chunked_col_pair_matches_plain_and_pallas(B, C, H, W, N, T, with_y0, dtype):
    w, x, y0 = _inputs(B, C, H, W, N, seed=H * W, clamp=True, with_y0=with_y0)
    tc = lambda a: None if a is None else torch.from_numpy(a).to(dtype)  # noqa: E731
    wt = [torch.from_numpy(a) for a in w]
    out, _ = chunked_col_pair(tc(x), *wt, tc(y0), H, W, T)
    assert out.dtype == dtype and out.shape == (B, C, H * W)
    _close(out, seq.ss2d_col_pair_plain(tc(x), *wt, tc(y0), H, W), dtype)
    jc = lambda a: None if a is None else jnp.asarray(a, JDT[dtype])  # noqa: E731
    ref = jax.jit(jax_col_pair, static_argnums=(7, 8, 9))(
        jc(x), *map(jnp.asarray, w), jc(y0), 1, H, W)
    _close(out, torch.from_numpy(np.array(ref.astype(jnp.float32))), dtype)


@pytest.mark.parametrize("B,C,H,W,N,T,with_y0", CASES[:3])
def test_plain_passes_match_the_mirror(B, C, H, W, N, T, with_y0):
    """The port's plain summary and full passes at the mirror's T (the
    wrappers' CPU forms, in the kernels' layouts) give the mirror's
    summaries and output (fp32)."""
    w, x, y0 = _inputs(B, C, H, W, N, seed=H * W, clamp=True, with_y0=with_y0)
    xt, y0t = torch.from_numpy(x), None if y0 is None else torch.from_numpy(y0)
    wt = [torch.from_numpy(a) for a in w]
    out, sums = chunked_col_pair(xt, *wt, y0t, H, W, T)
    fwd, rev = seq._col_args(xt, *wt, y0t, H, W)
    got = seq.ss2d_col_sum(xt, fwd[:4], rev[:4], H, W, T)
    for g, m in zip(got, sums, strict=True):
        assert g.shape == (B, W * -(-H // T), C * N)
        _close(g, m, torch.float32)
    h_f, h_r = linear_scan_plain(got[0], got[1], False), linear_scan_plain(got[2], got[3], True)
    _close(seq.ss2d_col_dir(xt, fwd, rev, h_f, h_r, y0t, H, W, T), out, torch.float32)


def test_chunked_col_pair_misses_the_unclamped_function():
    """The mirror keeps the -10 clamp. Probe: bias +12 and A = -1 on every
    third channel (dt * A ~ -12), x zero at their odd rows, where D x and
    the input term vanish and y is the row above's state times exp(-10)
    clamped, <= e^-11 unclamped, in both directions. There the unclamped
    mirror misses the clamped one by more than half its value; bem_tpu's
    clamped kernel matches it."""
    B, C, H, W, T = 1, 24, 12, 20, 4
    w, x, _ = _inputs(B, C, H, W, 1, seed=7, clamp=True, with_y0=False)
    probe = np.zeros((B, C, H, W), bool)
    probe[:, ::3, 1::2] = True
    probe = probe.reshape(B, C, H * W)
    x[probe] = 0.0
    wt = [torch.from_numpy(a) for a in w]
    out, _ = chunked_col_pair(torch.from_numpy(x), *wt, None, H, W, T)
    unclamped, _ = chunked_col_pair(torch.from_numpy(x), *wt, None, H, W, T, clamp=False)
    p = torch.from_numpy(probe)
    err = (out - unclamped)[p].abs().max().item()
    assert err > 0.5 * out[p].abs().max().item(), err
    ref = jax.jit(jax_col_pair, static_argnums=(7, 8, 9))(
        jnp.asarray(x), *map(jnp.asarray, w), None, 1, H, W)
    ref = torch.from_numpy(np.array(ref))
    assert (out - ref)[p].abs().max() <= TOL[torch.float32] * ref[p].abs().max()
