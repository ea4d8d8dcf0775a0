"""The row pair's chunked, parallel-in-L scan (csrc/ss2d_seq.cu), pinned on the CPU.

No kernel runs here, so this file mirrors the kernel's three passes in
plain PyTorch and holds the mirror against the port's plain version
(``ss2d_seq_pair_plain``) and against bem_tpu's ``ss2d_seq_pair_g`` in
Pallas interpret mode, on the same numpy-seeded inputs:

  1. per chunk of T positions, both directions' summaries from h = 0: the
     chunk's decay exp(sum of clamped log-decays), summed in log space,
     and its end state (reverse: the state at the chunk's first position,
     walked back to front);
  2. the carry: ``linear_scan_plain`` over the chunks, forward for the
     forward direction and reverse for the reverse one, on the kernel's
     (B, nchunks, C*N) layout;
  3. every chunk re-walked from its neighbour's inclusive state (forward:
     chunk k-1, reverse: k+1, 0 at the ends), y = round(y_f) + y_r +
     (D_f + D_r) x with y_f rounded to the stream dtype before the add.

Cases: fp32 and bf16; L a multiple of T, not a multiple, shorter than T;
N = 1, 2 and 4; T = 16 at C = 288, where the kernel halves its chunk;
the "row" and "col" pairs; bias +12 on every third channel so that the
-10 clamp bites (the mirror must then miss bem_tpu's unclamped
composition). Tolerances: fp32 2e-4 and bf16 2e-2 of the
output's largest entry (smoke.TOL: the chunked sums and the doubling scan
reassociate in fp32; bf16 outputs may differ by a bf16 ulp where the two
sides round y_f differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.ss2d_seq import _seq_pair_ref
from bem_tpu.ops.ss2d_seq import ss2d_seq_pair_g as jax_seq_pair
from bem_tpu_torch.ops import ss2d_seq as seq
from bem_tpu_torch.ops.scan import linear_scan_plain

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _weights(C, R, N, seed, clamp):
    rng = np.random.default_rng(seed)
    P = R + 2 * N
    bias = rng.standard_normal((4, C)) * 0.5
    if clamp:  # dt ~ softplus(12), so dt * A < -10 on these channels
        bias[:, ::3] = 12.0
    w = dict(Wx=rng.standard_normal((4, P, C)) * 0.2, Wdt=rng.standard_normal((4, C, R)) * 0.2,
             bias=bias, A=-np.exp(rng.standard_normal((4, C, N)) * 0.3),
             D=rng.standard_normal((4, C)))
    return [w[k].astype(np.float32) for k in ("Wx", "Wdt", "bias", "A", "D")]


def _chunks(t, T):
    """(B, C, L) -> (B, C, nch, T), zero past L."""
    B, C, L = t.shape
    nch = -(-L // T)
    return torch.nn.functional.pad(t, (0, nch * T - L)).reshape(B, C, nch, T)


def _walk(w, b, T, reverse, h0=None, cq=None):
    """Walk every chunk (dim -1) at once from h0 (zeros if None):
    h = exp(w) h + b, positions in order or back to front. Returns the
    end state and, with readout rows cq, y = cq * h at every position."""
    h = torch.zeros(w.shape[:-1]) if h0 is None else h0
    y = torch.zeros_like(w) if cq is not None else None
    for s in range(T):
        t = T - 1 - s if reverse else s
        h = torch.exp(w[..., t]) * h + b[..., t]
        if cq is not None:
            y[..., t] = cq[..., t] * h
    return h, y


def chunked_pair(xseq, Wx, Wdt, bias, A, D, pair, T):
    """The mirror of the kernel's three passes, fp32 inside."""
    xseq, fwd, rev = seq._pair_args(xseq, Wx, Wdt, bias, A, D, pair)
    x = xseq.float()
    B, C, L = x.shape
    N = A.shape[-1]
    R = Wx.shape[1] - 2 * N
    nch = -(-L // T)
    valid = _chunks(torch.ones(1, 1, L), T)  # padded positions: w = 0, b = 0
    ys = []
    for (Wx_d, Wdt_d, b_d, A_d, D_d), reverse in ((fwd, False), (rev, True)):
        xdbl, w, b = seq._decay_input(x, Wx_d, Wdt_d, b_d, A_d)
        w = [_chunks(wn, T) * valid for wn in w]
        b = [_chunks(bn, T) for bn in b]
        # pass 1: summaries in the kernel's (B, nch, C*N) layout
        summ = [_walk(wn, bn, T, reverse) for wn, bn in zip(w, b)]
        a_k = torch.stack([torch.exp(wn.sum(-1)) for wn in w], -1)   # (B, C, nch, N)
        b_k = torch.stack([end for end, _ in summ], -1)
        lay = lambda t: t.permute(0, 2, 1, 3).reshape(B, nch, C * N)  # noqa: E731
        # pass 2: the carry; each chunk enters with its neighbour's inclusive state
        hinc = linear_scan_plain(lay(a_k), lay(b_k), reverse).reshape(B, nch, C, N)
        zero = torch.zeros_like(hinc[:, :1])
        hin = (torch.cat([hinc[:, 1:], zero], 1) if reverse
               else torch.cat([zero, hinc[:, :-1]], 1)).permute(0, 2, 1, 3)
        # pass 3: the re-walk from the entry states
        y = torch.zeros(B, C, nch, T) if D_d is None else _chunks(D_d.reshape(1, -1, 1) * x, T)
        for n in range(N):
            cq = _chunks(xdbl[:, R + N + n:R + N + n + 1].expand(B, C, L), T)
            _, yn = _walk(w[n], b[n], T, reverse, hin[..., n], cq)
            y = y + yn
        ys.append(y.reshape(B, C, nch * T)[..., :L])
    y_f, y_r = ys
    return (y_f.to(xseq.dtype).float() + y_r).to(xseq.dtype)


def _close(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype] * ref.float().abs().max().item()
    assert err <= tol, (err, tol)


CASES = [  # (B, C, L, T, N, pair, clamp)
    (2, 16, 128, 32, 1, "row", False),   # L a multiple of T
    (1, 40, 240, 64, 1, "row", True),    # small 12x20: L not a multiple, clamp
    (2, 24, 4, 64, 1, "col", True),      # small 2x2: L shorter than one chunk
    (1, 16, 1120, 64, 2, "col", False),  # CG-L0's length, N = 2
    (2, 16, 96, 32, 4, "row", True),     # the kernel's T = 32, N = 4, clamp
    (1, 288, 100, 16, 1, "row", False),  # a C wide enough that the kernel halves T
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,L,T,N,pair,clamp", CASES)
def test_chunked_pair_matches_plain_and_pallas(B, C, L, T, N, pair, clamp, dtype):
    w = _weights(C, -(-C // 16), N, seed=L, clamp=clamp)
    x = np.random.default_rng(3).standard_normal((B, C, L)).astype(np.float32)
    x = x / (1.0 + np.exp(-x))  # the stem's SiLU output
    xt = torch.from_numpy(x).to(dtype)
    wt = [torch.from_numpy(a) for a in w]
    out = chunked_pair(xt, *wt, pair, T)
    assert out.dtype == dtype and out.shape == (B, C, L)
    _close(out, seq.ss2d_seq_pair_plain(xt, *wt, pair), dtype)
    ref = jax_seq_pair(jnp.asarray(x, JDT[dtype]), *map(jnp.asarray, w), 1, pair)
    _close(out, torch.from_numpy(np.asarray(ref, np.float32)), dtype)


def test_chunked_pair_misses_the_unclamped_function():
    """The mirror keeps the -10 clamp. Probe: A = -1 and bias +12 on every
    third channel (dt * A ~ -12), x zero at their odd positions, where
    D x and the input term vanish and y is the neighbours' states times
    exp(-10) clamped, exp(dt A) <= e^-11 unclamped. There bem_tpu's
    unclamped composition misses the mirror by more than half its value;
    the clamped plain version matches it."""
    B, C, L, T = 1, 24, 200, 64
    w = _weights(C, 2, 1, seed=5, clamp=True)
    w[3][:] = -1.0
    x = np.random.default_rng(4).standard_normal((B, C, L)).astype(np.float32)
    probe = np.zeros(x.shape, bool)
    probe[:, ::3, 1::2] = True
    x[probe] = 0.0
    wt = [torch.from_numpy(a) for a in w]
    out = chunked_pair(torch.from_numpy(x), *wt, "row", T)
    unclamped = jax.jit(_seq_pair_ref, static_argnums=(6, 7))(
        jnp.asarray(x), *map(jnp.asarray, w), 0, 2)
    p = torch.from_numpy(probe)
    err = (out - torch.from_numpy(np.asarray(unclamped)))[p].abs().max().item()
    assert err > 0.5 * out[p].abs().max().item(), err
    _close(out, seq.ss2d_seq_pair_plain(torch.from_numpy(x), *wt, "row"), torch.float32)

