"""The SS2D tail's Hopper design (row 3), mirrored in torch on the CPU.

The CUDA kernel (bem_tpu_torch/csrc/ss2d_tail.cu) takes the LN statistics
with LP = 2 * threads / TL lanes a pair of positions (8, 16 or 32 with its
tiles of 64 or 32 positions and blocks of 256 or 512; lane k sums channels k,
k + LP, ... in order, the lanes combined by xor shuffles; the mean, then
the centred variance, eps 1e-5), and on the bf16 stream runs the
projection on the tensor cores: the LN output rounded to bf16, Wout
rounded to bf16, fp32 accumulation over k-steps of 16 channels (C
zero-padded), then + bout + res rounded once. The fp32 stream accumulates
channel by channel with FMAs on the CUDA cores. This file mirrors both
(LP = 8, 16 and 32) and holds the mirror against ``ss2d_tail_cf_plain`` and
bem_tpu's ``ss2d_tail_cf`` in interpret mode (bf16 2e-2, fp32 2e-4 of
max(1, |ref|), as test_torch_ops.py) at C = 40, 80 and 160, C_out != C,
merged and unmerged, with and without bout and the residual, L off the
tile, on mean-dominated scan outputs (+3); shows that the bf16 products
are exact (the fp32 sums match an fp64 product of the rounded operands to
1e-6 of its largest entry); and that the bf16 output sees both rounding
points (a mirror without either misses the plain version's bits far more
often).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.ss2d_tail import ss2d_tail_cf as jax_tail
from bem_tpu_torch.ops.ss2d_tail import ss2d_tail_cf, ss2d_tail_cf_plain

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _fma(a, b, c):
    """fp32 fmaf(a, b, c): the exact a * b + c, rounded once (float64
    holds the fp32 product exactly)."""
    return (a.double() * b.double() + c.double()).float()


def _lanes(t, LP):
    """The xor-shuffle combination of LP lane partials (dim 1), lane 0's
    value: t_k + t_(k ^ off) for off = 1, 2, ... < LP."""
    idx = torch.arange(LP)
    off = 1
    while off < LP:
        t = t + t[:, idx ^ off]
        off *= 2
    return t[:, 0]


def ln_mirror(y_row, y_colT, scale, bias, LP=8):
    """The kernel's LN output (fp32, before any rounding) on (B, C, L), LP
    lanes a position."""
    y = y_row.float() + (y_colT.float() if y_colT is not None else 0.0)
    B, C, L = y.shape
    invc = torch.tensor(1.0, dtype=torch.float32) / C
    s = torch.zeros(B, LP, L)
    for c in range(C):
        s[:, c % LP] += y[:, c]
    m = _lanes(s, LP) * invc
    v = torch.zeros(B, LP, L)
    for c in range(C):
        d = y[:, c] - m
        v[:, c % LP] = _fma(d, d, v[:, c % LP])
    inv = torch.rsqrt(_lanes(v, LP) * invc + 1e-5)
    return (y - m[:, None]) * inv[:, None] * scale[None, :, None] + bias[None, :, None]


def mirror(y_row, y_colT, scale, bias, Wout, bout, res, LP=8, round_yn=True, round_w=True,
           acc_only=False):
    """The kernel's tail on (B, C, L) streams; ``acc_only``: the fp32
    projection before bout, res and the output rounding."""
    bf16 = y_row.dtype == torch.bfloat16
    yn = ln_mirror(y_row, y_colT, scale, bias, LP)
    B, C, L = yn.shape
    W = Wout.float()
    if bf16 and round_yn:
        yn = yn.to(torch.bfloat16).float()
    if bf16 and round_w:
        W = W.to(torch.bfloat16).float()
    Cout = W.shape[1]
    acc = torch.zeros(B, Cout, L)
    if bf16:  # mma k-steps of 16 channels: exact products, fp32 sums
        for k0 in range(0, C, 16):
            acc = acc + torch.einsum("cd,bcl->bdl", W[k0:k0 + 16].double(),
                                     yn[:, k0:k0 + 16].double()).float()
    else:  # one FMA a channel
        for c in range(C):
            acc = _fma(W[c][None, :, None], yn[:, c][:, None], acc)
    if acc_only:
        return acc
    out = acc + (bout.reshape(1, -1, 1) if bout is not None else 0.0)
    if res is not None:
        out = out + res.float()
    return out.to(y_row.dtype)


def _case(B, C, Cout, L, merged, with_bias, with_res, dtype, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    s = lambda a: t(a).to(dtype)  # noqa: E731
    return (s(3.0 + 2.0 * rng.standard_normal((B, C, L))),
            None if merged else s(rng.standard_normal((B, C, L))),
            t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
            t(rng.uniform(-1, 1, (C, Cout)) * C ** -0.5),
            t(rng.uniform(-0.3, 0.3, Cout)) if with_bias else None,
            s(rng.standard_normal((B, Cout, L))) if with_res else None)


def _jax(args):
    yr, yc, sc, bi, W, bo, res = args
    jd = jnp.bfloat16 if yr.dtype == torch.bfloat16 else jnp.float32
    j = lambda x: None if x is None else jnp.asarray(x.float().numpy(), jd)  # noqa: E731
    f = lambda x: None if x is None else jnp.asarray(x.numpy())  # noqa: E731
    out = jax_tail(j(yr), j(yc), f(sc), f(bi), f(W), f(bo), 1, j(res))
    return torch.from_numpy(np.array(out, np.float32))


def _close(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, ref.float().abs().max().item()), err


# (B, C, C_out, L, merged, bout, res): C = 40 / 80 / 160, C_out != C, L off
# the 64- and 32-position tiles
CASES = [(2, 40, 40, 200, False, True, True), (1, 40, 56, 97, True, False, True),
         (1, 80, 80, 130, True, True, False), (1, 160, 160, 70, False, False, True),
         (2, 48, 24, 33, True, False, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_mirror_matches_plain_and_pallas(case, dtype):
    args = _case(*case, dtype, seed=case[1] + case[3])
    ref = ss2d_tail_cf_plain(*args)
    pal = _jax(args)
    for LP in (8, 16, 32):
        out = mirror(*args, LP=LP)
        assert out.dtype == dtype and out.shape == ref.shape
        _close(out, ref, dtype)
        _close(out, pal, dtype)
    # the wrapper on the CPU is the plain version
    assert torch.equal(ss2d_tail_cf(*args), ref)


@pytest.mark.parametrize("C", [40, 160])
def test_bf16_products_are_exact(C):
    """bf16 x bf16 products are exact in fp32: the mirror's fp32 k-step
    sums match an fp64 product of its own rounded operands to 1e-6 of the
    largest entry."""
    args = _case(2, C, C, 150, True, False, False, torch.bfloat16, seed=C)
    acc = mirror(*args, acc_only=True)
    yn = ln_mirror(*args[:4]).to(torch.bfloat16).double()
    W16 = args[4].to(torch.bfloat16).double()
    prod = W16[None, :, :, None] * yn[:, :, None, :]  # (B, C, C_out, L)
    assert torch.equal(prod.float().double(), prod)   # every product exact in fp32
    exact = prod.sum(1)
    err = (acc.double() - exact).abs().max().item()
    assert err <= 1e-6 * exact.abs().max().item(), err


def test_bf16_rounding_points_are_seen():
    """On the bf16 stream the mirror's output has the plain version's bits
    almost everywhere; a mirror without the LN output's or Wout's bf16
    rounding misses them far more often, so a change of either rounding
    point fails the threshold."""
    args = _case(2, 80, 80, 300, False, True, True, torch.bfloat16, seed=9)
    ref = ss2d_tail_cf_plain(*args)
    same = lambda out: (out == ref).float().mean().item()  # noqa: E731
    assert same(mirror(*args)) >= 0.97
    assert same(mirror(*args, round_yn=False)) < 0.9
    assert same(mirror(*args, round_w=False)) < 0.9
