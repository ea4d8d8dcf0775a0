"""The stem's hi / lo activation split for the tensor-core kernel, on the CPU.

On the bf16 stream ``stem_fused_cf``'s kernel (csrc/stem_fused.cu,
``stem_tc_kernel``) runs the 1x1 projection on the tensor cores with bf16
operands. Its rounding points are the mirror image of the gdMlp's: W1 is
pre-rounded to bf16 (one exact operand), and the LN output stays fp32,
as bem_tpu's Pallas stem keeps it in interpret mode. The kernel cuts the
LN output, as it stages the tile, into hi = bf16(y) and lo = bf16(y - hi)
(mirrored here by :func:`split_bf16`), and runs each product twice into
one fp32 accumulator; without the LN the tile is x itself and one product
suffices. This file checks that split where no kernel can run:

- hi + lo reproduces y to 2^-16 relative, elementwise;
- on the fp32 hidden map (W1 . y + b1, before the depthwise conv), the
  two products reproduce the plain version's single fp32 product to 1e-5
  of its largest entry, and hi alone misses that by far (a single product
  on a bf16-rounded LN output is the TPU's function, not the one the port
  pins);
- the kernel's steps mirrored here in plain PyTorch (LN, split, two
  products, + b1 inside the image, depthwise 3x3, + bdw, SiLU, one bf16
  rounding) agree with ``stem_fused_cf_plain`` and with bem_tpu's Pallas
  stem in interpret mode to 2e-2 (bf16) of the largest entry;
- on smoke.edge_cases' lo-carried stem case, which the card check holds
  the kernel against, the output is carried by the lo halves alone: with
  them dropped it is exactly 0, which misses the card check's tolerance
  (2e-2 of max(1, the largest entry)); with both halves it is the plain
  version to 2e-2 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.gdmlp_fused import stem_fused_cf as jax_stem
from bem_tpu_torch import smoke
from bem_tpu_torch.ops import gdmlp_fused as gd
from bem_tpu_torch.ops._common import layer_norm_c, round_bf16

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _drop_interpret_traces():
    """Drop the jitted interpret-mode traces when the module ends, so that a
    later test lowering the same shapes for the TPU does not reuse them."""
    yield
    jax.clear_caches()


def split_bf16(y: torch.Tensor):
    """The kernel's split of fp32 ``y``: hi = bf16(y), lo = bf16(y - hi)."""
    hi = y.to(BF16)
    return hi, (y - hi.float()).to(BF16)


def _tile(x, H, W, lns, lnb):
    """The staged tile in fp32: the LN output, or x itself without the LN."""
    B, C, _ = x.shape
    xi = x.float().reshape(B, C, H, W)
    return xi if lns is None else layer_norm_c(xi, lns, lnb)


def _hidden(W1, y, mode):
    """W1 (pre-rounded to bf16, as the wrapper does) . y: one fp32 product
    ("fp32", the plain version), the kernel's two ("split"), or hi alone."""
    w = round_bf16(W1)
    if mode == "fp32":
        return torch.einsum("oc,bchw->bohw", w, y)
    hi, lo = split_bf16(y)
    out = torch.einsum("oc,bchw->bohw", w, hi.float())
    return out if mode == "hi" else out + torch.einsum("oc,bchw->bohw", w, lo.float())


def stem_mirror(x, W1, b1, dw, bdw, H, W, lns=None, lnb=None, mode="split"):
    """The tensor-core stem's steps on the bf16 stream: (B, Dh, H*W) bf16.
    Without the LN the tile is bf16 already and ``split`` is one product."""
    hid = _hidden(W1, _tile(x, H, W, lns, lnb), mode)
    if b1 is not None:
        hid = hid + b1.reshape(1, -1, 1, 1)
    conv = gd._dw3x3(hid, dw)
    if bdw is not None:
        conv = conv + bdw.reshape(1, -1, 1, 1)
    return (conv * torch.sigmoid(conv)).reshape(x.shape[0], -1, H * W).to(BF16)


def _weights(rng, C, Dh, bias):
    u = lambda shape, bound: torch.from_numpy(  # noqa: E731
        rng.uniform(-bound, bound, shape).astype(np.float32))
    return (u((Dh, C), C ** -0.5), u(Dh, 0.1) if bias else None, u((Dh, 9), 1 / 3),
            u(Dh, 0.3) if bias else None)


def _ln(rng, C):
    return (torch.from_numpy((1 + 0.1 * rng.standard_normal(C)).astype(np.float32)),
            torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32)))


@pytest.mark.parametrize("scale", [1e-3, 0.3, 1.0, 41.0])
def test_split_reproduces_the_ln_output(scale):
    y = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, 9, 33))
                         .astype(np.float32) * scale)
    hi, lo = split_bf16(y)
    assert hi.dtype == lo.dtype == BF16 and torch.equal(hi, y.to(BF16))
    err = (hi.float() + lo.float() - y).abs()
    assert (err <= 2.0 ** -16 * y.abs()).all(), (err / y.abs()).max()


# (B, C, Dh, H, W): the serving widths (C = Dh = 40, 80, 160), K padding
# (C = 24), Dh != C
HID_SHAPES = [(2, 40, 40, 8, 34), (1, 80, 80, 6, 20), (1, 160, 160, 4, 34), (2, 24, 24, 5, 13),
              (1, 40, 80, 7, 9)]


@pytest.mark.parametrize("B,C,Dh,H,W", HID_SHAPES)
def test_two_products_hold_the_fp32_hidden_map(B, C, Dh, H, W):
    """The kernel's two products on the LN output within 1e-5 of the fp32
    hidden map's largest entry; hi alone at least 10x beyond that."""
    rng = np.random.default_rng(C + Dh + H)
    x = torch.from_numpy(rng.standard_normal((B, C, H * W)).astype(np.float32)).to(BF16)
    W1 = _weights(rng, C, Dh, False)[0]
    y = _tile(x, H, W, *_ln(rng, C))
    want = _hidden(W1, y, "fp32")
    scale = want.abs().max().item()
    err = (_hidden(W1, y, "split") - want).abs().max().item()
    assert err <= 1e-5 * scale, (err, scale)
    err_hi = (_hidden(W1, y, "hi") - want).abs().max().item()
    assert err_hi > 10 * 1e-5 * scale, (err_hi, scale)


# (B, C, Dh, H, W, with the LN, with biases); C = 64 runs bem_tpu's
# tap-folded form (use_folded_conv), the same function
STEM_SHAPES = [(2, 24, 24, 13, 17, True, True), (1, 40, 80, 9, 20, True, False),
               (2, 40, 40, 7, 12, False, True), (1, 64, 64, 6, 20, True, True)]


@pytest.mark.parametrize("B,C,Dh,H,W,ln,bias", STEM_SHAPES)
def test_mirror_matches_plain_and_pallas(B, C, Dh, H, W, ln, bias):
    rng = np.random.default_rng(7 * C + H)
    xn = rng.standard_normal((B, C, H * W)).astype(np.float32)
    x = torch.from_numpy(xn).to(BF16)
    W1, b1, dw, bdw = _weights(rng, C, Dh, bias)
    lns, lnb = _ln(rng, C) if ln else (None, None)
    got = stem_mirror(x, W1, b1, dw, bdw, H, W, lns, lnb)
    plain = gd.stem_fused_cf_plain(x, W1, b1, dw, bdw, H, W, lns, lnb)
    j = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    pallas = jax_stem(jnp.asarray(xn, jnp.bfloat16), j(W1), j(b1), j(dw), j(bdw), H, W, j(lns),
                      j(lnb))
    pallas = torch.from_numpy(np.array(pallas.astype(jnp.float32)))
    assert got.shape == plain.shape == pallas.shape == (B, Dh, H * W)
    for ref, what in ((plain.float(), "plain"), (pallas, "Pallas")):
        err = (got.float() - ref).abs().max().item()
        assert err <= smoke.TOL[BF16] * ref.abs().max().item(), (what, err)


@pytest.mark.parametrize("mode", ["split", "hi"])
def test_lo_carried_case_needs_the_lo_halves(mode):
    case = next(c for c in smoke.edge_cases(device="cpu")
                if c.name == "stem_fused_cf" and c.label.startswith("lo-carried"))
    plain = gd.stem_fused_cf_plain(*case.args)
    assert case.dtype == plain.dtype == BF16 and torch.isfinite(plain).all()
    out = stem_mirror(*case.args, mode=mode)
    m = plain.float().abs().max().item()
    if mode == "split":
        err = (out.float() - plain.float()).abs().max().item()
        assert err <= smoke.TOL[BF16] * m, (err, m)
    else:  # 0, which misses the card check's tolerance (smoke.compare)
        assert not out.any() and m > smoke.TOL[BF16] * max(m, 1.0), m
