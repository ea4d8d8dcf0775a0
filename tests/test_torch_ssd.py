"""ops/ssd.py (the mamba2 SSD scan behind SS2D m0): the port vs bem_tpu.

Every function of the module on seeded numpy inputs, fp32 within 1e-5 of
max(1, |ref|), bf16 within 2e-2:
- ``segsum`` (its -inf upper triangle included);
- ``ssd_chunked`` at chunk 4 over L = 12, with and without an initial state;
- ``ssd_chunk_scan`` at L = 49 and 196 with chunk 64 (halved to 1 and 4,
  as VMamba-T's 7x7 and 14x14 stages run), L = 64 at chunk 16, an initial
  state, grouped B / C, the silu(z) gate, D per head and per channel, the
  final state, bf16 inputs;
- ``selective_state_update`` in both shape families ((b, d, n) and (b, h,
  d, n) with groups), with D, z and the dt bias;
- ``layernorm_gated`` with and without a group size, both gate orders and
  RMS, with and without bias.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops import ssd as J
from bem_tpu_torch.ops import ssd as T

from test_torch_cascade import close
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(a, dtype="float32"):
    """(jax array, torch tensor) of a numpy array (None passes)."""
    if a is None:
        return None, None
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def test_segsum_matches():
    x = _f(np.random.default_rng(0), 2, 3, 7)
    want, got = np.asarray(J.segsum(jnp.asarray(x))), T.segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(want), np.isneginf(got))
    fin = np.isfinite(want)
    close(got[fin], want[fin], 1e-6)


@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked_matches(initial):
    rng = np.random.default_rng(1)
    B, L, H, P, N = 2, 12, 3, 4, 5
    u, Bm, Cm = _f(rng, B, L, H, P), _f(rng, B, L, H, N), _f(rng, B, L, H, N)
    w = -np.abs(_f(rng, B, L, H))
    s0 = _f(rng, B, H, P, N) if initial else None
    args = [u, w, Bm, Cm]
    yj, fj = J.ssd_chunked(*(jnp.asarray(a) for a in args), 4,
                           None if s0 is None else jnp.asarray(s0))
    yt, ft = T.ssd_chunked(*(torch.from_numpy(a) for a in args), 4,
                           None if s0 is None else torch.from_numpy(s0))
    close(yt.numpy(), np.asarray(yj), 1e-5)
    close(ft.numpy(), np.asarray(fj), 1e-5)


SCAN_CASES = {
    "L49 chunk1 groups": dict(L=49, G=2, init=False, z=False, D="head"),
    "L196 chunk4 init z": dict(L=196, G=4, init=True, z=True, D="channel"),
    "L64 chunk16": dict(L=64, G=1, init=True, z=False, D=None, chunk=16),
    "L49 bf16 z": dict(L=49, G=2, init=False, z=True, D="channel", dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_ssd_chunk_scan_matches(case):
    c = SCAN_CASES[case]
    rng = np.random.default_rng(2)
    B, L, H, P, N, G = 2, c["L"], 4, 3, 5, c["G"]
    D = {"head": _f(rng, H), "channel": _f(rng, H, P), None: None}[c["D"]]
    arrays = dict(x=_f(rng, B, L, H, P), dt=_f(rng, B, L, H), A=-np.exp(_f(rng, H)),
                  Bm=_f(rng, B, L, G, N), Cm=_f(rng, B, L, G, N), D=D,
                  z=_f(rng, B, L, H, P) if c["z"] else None, dt_bias=_f(rng, H),
                  initial_states=_f(rng, B, H, P, N) if c["init"] else None)
    dtype = c.get("dtype", "float32")
    pairs = {k: _both(v, dtype if k in ("x", "z") else "float32") for k, v in arrays.items()}
    kw = dict(chunk_size=c.get("chunk", 64), dt_softplus=True, return_final_states=True)
    yj, fj = J.ssd_chunk_scan(**{k: v[0] for k, v in pairs.items()}, **kw)
    yt, ft = T.ssd_chunk_scan(**{k: v[1] for k, v in pairs.items()}, **kw)
    assert yt.dtype == getattr(torch, dtype) and yt.shape == yj.shape
    tol = 1e-5 if dtype == "float32" else 2e-2
    close(yt.float().numpy(), np.asarray(yj.astype(jnp.float32)), tol)
    close(ft.numpy(), np.asarray(fj), tol)
    only_y = T.ssd_chunk_scan(**{k: v[1] for k, v in pairs.items()}, chunk_size=kw["chunk_size"],
                              dt_softplus=True)
    assert torch.equal(only_y, yt)


@pytest.mark.parametrize("heads", [False, True])
def test_selective_state_update_matches(heads):
    rng = np.random.default_rng(3)
    b, h, d, n, g = 2, 4, 3, 5, 2
    if heads:
        a = dict(state=_f(rng, b, h, d, n), x=_f(rng, b, h, d), dt=_f(rng, b, h, d),
                 A=-np.exp(_f(rng, h, d, n)), B=_f(rng, b, g, n), C=_f(rng, b, g, n),
                 D=_f(rng, h, d), z=_f(rng, b, h, d), dt_bias=_f(rng, h, d))
    else:
        a = dict(state=_f(rng, b, d, n), x=_f(rng, b, d), dt=_f(rng, b, d),
                 A=-np.exp(_f(rng, d, n)), B=_f(rng, b, n), C=_f(rng, b, n), D=_f(rng, d),
                 z=None, dt_bias=_f(rng, d))
    pairs = {k: _both(v) for k, v in a.items()}
    sj, oj = J.selective_state_update(**{k: v[0] for k, v in pairs.items()}, dt_softplus=True)
    st, ot = T.selective_state_update(**{k: v[1] for k, v in pairs.items()}, dt_softplus=True)
    assert st.shape == sj.shape and ot.shape == oj.shape
    close(st.numpy(), np.asarray(sj), 1e-5)
    close(ot.numpy(), np.asarray(oj), 1e-5)


@pytest.mark.parametrize("group_size", [None, 4])
@pytest.mark.parametrize("norm_before_gate", [True, False])
@pytest.mark.parametrize("rms", [False, True])
def test_layernorm_gated_matches(group_size, norm_before_gate, rms):
    rng = np.random.default_rng(4)
    x, z, w, bias = _f(rng, 2, 5, 8), _f(rng, 2, 5, 8), _f(rng, 8), _f(rng, 8)
    kw = dict(group_size=group_size, norm_before_gate=norm_before_gate, is_rms_norm=rms)
    for b in (bias, None):
        want = J.layernorm_gated(jnp.asarray(x), jnp.asarray(w),
                                 None if b is None else jnp.asarray(b), jnp.asarray(z), **kw)
        got = T.layernorm_gated(torch.from_numpy(x), torch.from_numpy(w),
                                None if b is None else torch.from_numpy(b), torch.from_numpy(z),
                                **kw)
        close(got.numpy(), np.asarray(want), 1e-5)
