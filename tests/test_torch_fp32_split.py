"""The fp32 stream's three-product splits for the tensor-core stem and gdMlp, on the CPU.

On the fp32 stream ``stem_fused_cf`` and ``gdmlp_fused_cf`` run their 1x1
projections on the tensor cores at fp32 accuracy (csrc/stem_fused.cu
``stem_tc32_kernel``, csrc/gdmlp_fused.cu ``gdmlp_tc32_kernel``). Every
operand is fp32 there: the LN output (x itself without the LN), W1, the
gate, W2. The gdMlp cuts each into hi = bf16(v) and lo = bf16(v - hi)
(the activations as it stages them, its weights once a call) and runs
each product three times into one fp32 accumulator, hi.hi + lo.hi +
hi.lo (``mma3``), k-step by k-step of 16; it adds its W2 products chunk
by chunk of 16 gate channels, and where the pixel grid is smaller than
the card it splits the chunks over blocks and adds the partial outputs
in split order. The stem cuts each operand into tf32 big and small (10
fraction bits, to nearest, ties away from zero) and runs small.big +
big.small + big.big (``mma3_tf32``, 3xTF32) in k-steps of 8. This file
mirrors those steps in plain PyTorch where no kernel can run:

- the mirrored products match an fp64 product of the same split operands
  to 1e-6 of its largest entry;
- the mirrored kernels match ``*_fused_cf_plain`` and bem_tpu's Pallas
  kernels (interpret mode, as bem_tpu's tests run them) to the card
  check's 2e-4 of max(1, the largest entry): C = 40 / 80 / 160, Cout !=
  C, with and without the LN, biases and the residual, H and W off the
  kernels' tiles, and the eval CG's B = 1 levels with the hidden split;
- on smoke.edge_cases' fp32 lo-carried cases, which the card check holds
  the kernels to, dropping any one of the three products (of either
  projection, for the gdMlp) misses that tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.gdmlp_fused import gdmlp_fused_cf as jax_gdmlp
from bem_tpu.ops.gdmlp_fused import stem_fused_cf as jax_stem
from bem_tpu_torch import smoke
from bem_tpu_torch.ops import gdmlp_fused as gd
from bem_tpu_torch.ops._common import layer_norm_c

from test_torch_cpu_setup import quick_compile  # noqa: F401  (module fixtures)

TOL = smoke.TOL[torch.float32]
PRODUCTS = ("hh", "lh", "hl")  # hi.hi, lo(weight).hi(activation), hi(weight).lo(activation)
KSTEP = 16  # the gdMlp's k-step and hidden chunk
CARD_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_drop_traces():
    """One intra-op thread for the module (thousands of small ops beside
    the other workers of a parallel run), and the jitted interpret-mode
    traces dropped when it ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def split_bf16(v: torch.Tensor):
    """The gdMlp's split of fp32 ``v``: hi = bf16(v), lo = bf16(v - hi), as fp32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _tf32(v: torch.Tensor):
    """fp32 ``v`` rounded to tf32's 10 fraction bits, to nearest, ties away
    from zero (the stem's bit operation: + half an ulp, low 13 bits cleared)."""
    return ((v.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(v: torch.Tensor):
    """The stem's split of fp32 ``v``: big = tf32(v), small = tf32(v - big)."""
    big = _tf32(v)
    return big, _tf32(v - big)


# the gdMlp's split and k-step, the stem's
BF16 = (split_bf16, 16)
TF32 = (split_tf32, 8)


def mma3(w, a, drop=None, form=BF16):
    """w (M, K) . a (B, K, N) as the kernels take it: in k-steps of the
    form's length, each the three products hi.hi, lo.hi and hi.lo (the
    stem adds lo.hi and hi.lo first; ``drop``: one left out) into one fp32
    accumulator."""
    split, kstep = form
    (wh, wl), (ah, al) = split(w), split(a)
    acc = torch.zeros((a.shape[0], w.shape[0], a.shape[2]))
    terms = (("hh", wh, ah), ("lh", wl, ah), ("hl", wh, al))
    if form is TF32:
        terms = terms[1:] + terms[:1]
    for k0 in range(0, w.shape[1], kstep):
        k = slice(k0, k0 + kstep)
        for name, ww, aa in terms:
            if name != drop:
                acc = acc + torch.einsum("mk,bkn->bmn", ww[:, k], aa[:, k])
    return acc


def _tile(x, H, W, lns, lnb):
    B, C, L = x.shape
    y = x.float()
    if lns is not None:
        y = layer_norm_c(y.reshape(B, C, H, W), lns, lnb).reshape(B, C, L)
    return y


def hidden_splits(B, H, W, h, TH=4):
    """The gdMlp's hidden split (csrc/gdmlp_fused.cu gdmlp_tc32_plan at tile
    height 4): (splits, chunks per split)."""
    nch = -(-h // KSTEP)
    blocks = -(-W // 32) * -(-H // TH) * B
    if blocks >= CARD_SMS:
        return 1, nch
    per = -(-nch // -(-CARD_SMS // blocks))
    return -(-nch // per), per


def gdmlp_mirror(x, W1, b1, dw, bdw, W2, b2, H, W, lns=None, lnb=None, residual=False,
                 drop=(None, None)):
    """The fp32 tensor-core gdMlp's steps: the W1 product (three products,
    k-steps of 16), + b1, depthwise 3x3, + bdw, exact-erf GELU, the W2
    product chunk by chunk of 16 gate channels, per split of the hidden
    width, the partials added in split order, + b2, + x. ``drop``: the
    product left out of (the W1 projection, the W2 projection)."""
    B, C, L = x.shape
    h = W1.shape[0] // 2
    hid = mma3(W1, _tile(x, H, W, lns, lnb), drop[0])
    if b1 is not None:
        hid = hid + b1.reshape(1, -1, 1)
    conv = gd._dw3x3(hid.reshape(B, 2 * h, H, W), dw)
    if bdw is not None:
        conv = conv + bdw.reshape(1, -1, 1, 1)
    a = conv[:, :h]
    g = (0.5 * a * (1.0 + torch.erf(a * 0.7071067811865476)) * conv[:, h:]).reshape(B, h, L)
    nsplit, per = hidden_splits(B, H, W, h)
    out = None
    for s in range(nsplit):
        acc = torch.zeros((B, W2.shape[0], L))
        for c0 in range(s * per * KSTEP, min(h, (s + 1) * per * KSTEP), KSTEP):
            acc = acc + mma3(W2[:, c0:c0 + KSTEP], g[:, c0:c0 + KSTEP], drop[1])
        out = acc if out is None else out + acc
    if b2 is not None:
        out = out + b2.reshape(1, -1, 1)
    return out + x.float() if residual else out


def stem_mirror(x, W1, b1, dw, bdw, H, W, lns=None, lnb=None, drop=None):
    """The fp32 tensor-core stem's steps: the 3xTF32 W1 projection, + b1,
    depthwise 3x3, + bdw, SiLU."""
    B = x.shape[0]
    hid = mma3(W1, _tile(x, H, W, lns, lnb), drop, TF32)
    if b1 is not None:
        hid = hid + b1.reshape(1, -1, 1)
    conv = gd._dw3x3(hid.reshape(B, -1, H, W), dw)
    if bdw is not None:
        conv = conv + bdw.reshape(1, -1, 1, 1)
    return (conv * torch.sigmoid(conv)).reshape(B, -1, H * W)


def _err(got, ref):
    """(max abs error, the card check's tolerance: TOL x max(1, max |ref|))."""
    return ((got - ref).abs().max().item(),
            TOL * max(1.0, ref.abs().max().item()))


def _np(t):
    return None if t is None else jnp.asarray(t.numpy())


@pytest.mark.parametrize("form,bits", [(BF16, 16), (TF32, 22)], ids=["bf16", "tf32"])
@pytest.mark.parametrize("M,K,N", [(32, 40, 70), (48, 80, 33), (160, 160, 20)])
def test_three_products_hold_the_fp64_product_of_the_split(M, K, N, form, bits):
    rng = np.random.default_rng(K)
    w = torch.from_numpy(rng.uniform(-1, 1, (M, K)).astype(np.float32) * K ** -0.5)
    a = torch.from_numpy(rng.standard_normal((2, K, N)).astype(np.float32) * 3)
    (wh, wl), (ah, al) = (tuple(v.double() for v in form[0](u)) for u in (w, a))
    want = sum(torch.einsum("mk,bkn->bmn", p, q) for p, q in ((wh, ah), (wl, ah), (wh, al)))
    got = mma3(w, a, form=form).double()
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    # and the split product is the fp32 product to the 2^-16 / 2^-22 the kernels' headers state
    full = torch.einsum("mk,bkn->bmn", w.double(), a.double())
    bound = 2.0 ** -bits * torch.einsum("mk,bkn->bmn", w.double().abs(), a.double().abs())
    assert ((got - full).abs() <= bound).all()


def _weights(rng, C, h2, Cout, bias):
    u = lambda shape, bound: torch.from_numpy(  # noqa: E731
        rng.uniform(-bound, bound, shape).astype(np.float32))
    return (u((h2, C), C ** -0.5), u(h2, 0.1) if bias else None, u((h2, 9), 1 / 3),
            u(h2, 0.3) if bias else None, u((Cout, h2 // 2), 2 * (h2 // 2) ** -0.5),
            u(Cout, 0.3) if bias else None)


def _ln(rng, C, ln):
    if not ln:
        return None, None
    return (torch.from_numpy((1 + 0.1 * rng.standard_normal(C)).astype(np.float32)),
            torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32)))


# (B, C, Cout, H, W, with the LN, with biases, with the residual): H and W
# off the 4 x 32 tile, Cout != C, C = 160 without LN and biases; the eval
# CG's three B = 1 levels (28x40, 14x20, 7x10: 14, 4 and 2 pixel blocks,
# so the hidden width splits 10, 20 and 40 ways)
GDMLP_SHAPES = [(2, 40, 40, 9, 37, True, True, True), (1, 80, 56, 6, 33, True, True, False),
                (1, 160, 160, 5, 34, False, False, True), (1, 40, 40, 28, 40, True, True, True),
                (1, 80, 80, 14, 20, True, True, True), (1, 160, 160, 7, 10, True, True, True)]


@pytest.mark.parametrize("B,C,Cout,H,W,ln,bias,residual", GDMLP_SHAPES)
def test_gdmlp_mirror_matches_plain_and_pallas(B, C, Cout, H, W, ln, bias, residual):
    rng = np.random.default_rng(C + H + W)
    x = torch.from_numpy(rng.standard_normal((B, C, H * W)).astype(np.float32))
    W1, b1, dw, bdw, W2, b2 = _weights(rng, C, 8 * C, Cout, bias)
    lns, lnb = _ln(rng, C, ln)
    args = (x, W1, b1, dw, bdw, W2, b2, H, W, lns, lnb, residual)
    got = gdmlp_mirror(*args)
    plain = gd.gdmlp_fused_cf_plain(*args)
    pallas = jax_gdmlp(jnp.asarray(x.numpy()), *map(_np, (W1, b1, dw, bdw, W2, b2)), H, W,
                       _np(lns), _np(lnb), residual)
    pallas = torch.from_numpy(np.array(pallas, np.float32))
    assert got.shape == plain.shape == pallas.shape == (B, Cout, H * W)
    for ref, what in ((plain, "plain"), (pallas, "Pallas")):
        err, tol = _err(got, ref)
        assert err <= tol, (what, err, tol)


# (B, C, Dh, H, W, with the LN, with biases): tile remainders, Dh != C, the
# eval CG's 7x10 level at C = 160 (its hidden chunks dealt over blocks)
STEM_SHAPES = [(2, 40, 40, 9, 37, True, True), (1, 80, 80, 6, 33, True, False),
               (1, 160, 160, 7, 10, True, True), (1, 42, 90, 7, 10, False, True)]


@pytest.mark.parametrize("B,C,Dh,H,W,ln,bias", STEM_SHAPES)
def test_stem_mirror_matches_plain_and_pallas(B, C, Dh, H, W, ln, bias):
    rng = np.random.default_rng(C + Dh + H)
    x = torch.from_numpy(rng.standard_normal((B, C, H * W)).astype(np.float32))
    W1, b1, dw, bdw, _, _ = _weights(rng, C, Dh, 1, bias)
    lns, lnb = _ln(rng, C, ln)
    args = (x, W1, b1, dw, bdw, H, W, lns, lnb)
    got = stem_mirror(*args)
    plain = gd.stem_fused_cf_plain(*args)
    pallas = jax_stem(jnp.asarray(x.numpy()), *map(_np, (W1, b1, dw, bdw)), H, W, _np(lns),
                      _np(lnb))
    pallas = torch.from_numpy(np.array(pallas, np.float32))
    assert got.shape == plain.shape == pallas.shape == (B, Dh, H * W)
    for ref, what in ((plain, "plain"), (pallas, "Pallas")):
        err, tol = _err(got, ref)
        assert err <= tol, (what, err, tol)


@functools.lru_cache(maxsize=None)
def _edge(name):
    """smoke.edge_cases' fp32 lo-carried case of kernel ``name`` (built once)."""
    return next(c for c in smoke.edge_cases(device="cpu")
                if c.name == name and c.label.startswith("lo-carried fp32"))


@pytest.mark.parametrize("drop", [None, *PRODUCTS])
def test_stem_lo_carried_case_needs_every_product(drop):
    case = _edge("stem_fused_cf")
    plain = gd.stem_fused_cf_plain(*case.args)
    assert case.dtype == plain.dtype == torch.float32 and plain.abs().max() >= 1
    err, tol = _err(stem_mirror(*case.args, drop=drop), plain)
    if drop is None:  # lo.lo is 0 here: the products are exact
        assert err <= 1e-3 * tol, (err, tol)
    else:
        assert err > 10 * tol, (drop, err, tol)


@pytest.mark.parametrize("drop", [(None, None)] + [(p, None) for p in PRODUCTS]
                         + [(None, p) for p in PRODUCTS])
def test_gdmlp_lo_carried_case_needs_every_product(drop):
    case = _edge("gdmlp_fused_cf")
    plain = gd.gdmlp_fused_cf_plain(*case.args)
    assert case.dtype == plain.dtype == torch.float32 and plain.abs().max() >= 1
    err, tol = _err(gdmlp_mirror(*case.args, drop=drop), plain)
    if drop == (None, None):  # the dropped lo.lo and the splits' rests
        assert err <= 0.2 * tol, (err, tol)
    else:
        assert err > 10 * tol, (drop, err, tol)
