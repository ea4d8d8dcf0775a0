"""The gdMlp's hi / lo weight split for the tensor-core kernel, on the CPU.

On the bf16 stream ``gdmlp_fused_cf``'s kernel (csrc/gdmlp_fused.cu) runs
both 1x1 projections on the tensor cores with bf16 operands. Its
activations (the LN output, the gate) are bf16-exact already; the kernel
cuts the fp32 weights, as it stages them, into hi = bf16(W) and
lo = bf16(W - hi) (``split_store``, mirrored here by :func:`split_bf16`),
and each product runs twice into one fp32 accumulator. This file checks
that split where no kernel can run:

- hi + lo reproduces W to 2^-16 relative, elementwise (bf16 keeps 8
  significant bits, so the residual after two terms is about 2^-17);
- the gdMlp mirrored here in plain PyTorch with single fp32 products
  reproduces ``gdmlp_fused_cf_plain`` bit for bit; with the two-product
  form, each projection on the same bf16-exact activations reproduces it
  to 1e-5 of its largest entry (fp32 sums of products in another order);
- on smoke.edge_cases' lo-carried case, which the card check holds the
  kernel against, the output is carried by the lo halves alone: with
  either weight's lo dropped it is exactly 0, which misses the card
  check's tolerance (2e-2 of max(1, the largest entry)); with both halves
  it is the plain version to 2e-2 (bf16) of its largest entry.
"""

import numpy as np
import pytest
import torch

from bem_tpu_torch import smoke
from bem_tpu_torch.ops import gdmlp_fused as gd
from bem_tpu_torch.ops._common import layer_norm_c, round_bf16

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def split_bf16(w: torch.Tensor):
    """The kernel's split of fp32 ``w``: hi = bf16(w), lo = bf16(w - hi)."""
    hi = w.to(torch.bfloat16)
    return hi, (w - hi.float()).to(torch.bfloat16)


@pytest.mark.parametrize("scale", [1e-3, 0.158, 1.0, 37.0])
def test_split_reproduces_the_weight(scale):
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((320, 40))
                         .astype(np.float32) * scale)
    hi, lo = split_bf16(w)
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == lo.shape == w.shape
    assert torch.equal(hi, w.to(torch.bfloat16))
    err = (hi.float() + lo.float() - w).abs()
    assert (err <= 2.0 ** -16 * w.abs()).all(), (err / w.abs()).max()


def _proj(w, a, split):
    """The 1x1 projection w . a: one fp32 product, or (``split``) the
    kernel's two, hi . a + lo . a, summed in fp32."""
    if not split:
        return torch.einsum("oc,bchw->bohw", w, a)
    hi, lo = split_bf16(w)
    return (torch.einsum("oc,bchw->bohw", hi.float(), a)
            + torch.einsum("oc,bchw->bohw", lo.float(), a))


def _gdmlp_mirror(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual, split, gate=None):
    """_gdmlp_plain's steps on the bf16 stream: (the W1 product, the gate,
    the fp32 output before the final cast). ``gate`` replaces the gate
    computed here, so both forms can be fed the same bf16-exact gate."""
    B, C, L = x.shape
    h = W1.shape[0] // 2
    xi = round_bf16(layer_norm_c(x.float().reshape(B, C, H, Wd), lns, lnb))
    hid = _proj(W1, xi, split)
    conv = gd._dw3x3(hid + b1.reshape(1, -1, 1, 1), dw) + bdw.reshape(1, -1, 1, 1)
    a = conv[:, :h]
    g = round_bf16(0.5 * a * (1.0 + torch.erf(a * 0.7071067811865476)) * conv[:, h:])
    g = g if gate is None else gate
    out = (_proj(W2, g, split) + b2.reshape(1, -1, 1, 1)).reshape(B, -1, L)
    return hid, g, out + x.float() if residual else out


@pytest.mark.parametrize("B,C,H,W,residual", [(2, 40, 8, 12, True), (1, 24, 5, 9, False)])
def test_two_products_reproduce_the_plain_version(B, C, H, W, residual):
    """Each projection on the same bf16-exact activations (the LN output;
    the plain version's gate) within 1e-5 of its largest entry. End to end
    a gate may round to the neighbouring bf16 value, so the bf16 outputs
    agree to smoke.TOL's 2e-2, as the kernel's do."""
    rng = np.random.default_rng(1)
    h = 4 * C
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = t(rng.standard_normal((B, C, H * W))).to(torch.bfloat16)
    u = lambda shape, bound: t(rng.uniform(-bound, bound, shape))  # noqa: E731
    args = (x, u((2 * h, C), C ** -0.5), u(2 * h, C ** -0.5), u((2 * h, 9), 1 / 3),
            u(2 * h, 1 / 3), u((C, h), h ** -0.5), u(C, h ** -0.5), H, W,
            t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)), residual)
    plain = gd.gdmlp_fused_cf_plain(*args)
    hid1, g1, out1 = _gdmlp_mirror(*args, split=False)
    assert torch.equal(out1.to(torch.bfloat16), plain)
    hid2, _, out2 = _gdmlp_mirror(*args, split=True, gate=g1)
    for two, one in ((hid2, hid1), (out2, out1)):
        err = (two - one).abs().max().item()
        assert err <= 1e-5 * one.abs().max().item(), err
    _, _, out_e2e = _gdmlp_mirror(*args, split=True)
    err = (out_e2e.to(torch.bfloat16).float() - plain.float()).abs().max().item()
    assert err <= 2e-2 * plain.float().abs().max().item(), err


@pytest.mark.parametrize("drop", ["W1", "W2", "none"])
def test_lo_carried_case_needs_the_lo_halves(drop):
    case = next(c for c in smoke.edge_cases(device="cpu") if c.label.startswith("lo-carried"))
    plain = gd.gdmlp_fused_cf_plain(*case.args)
    assert case.dtype == plain.dtype == torch.bfloat16 and torch.isfinite(plain).all()
    x, W1, W2 = case.args[0], case.args[1], case.args[5]
    H, W = case.args[7:9]
    weights = {k: split_bf16(w) for k, w in (("W1", W1), ("W2", W2))}
    # the kernel's two products a weight, one of them left out by ``drop``
    proj = {k: (lambda a, hl=hl, k=k: torch.einsum("oc,bchw->bohw", hl[0].float(), a)
                + (0 if drop == k else torch.einsum("oc,bchw->bohw", hl[1].float(), a)))
            for k, hl in weights.items()}
    B, C, L = x.shape
    conv = gd._dw3x3(proj["W1"](x.float().reshape(B, C, H, W)), case.args[3])
    h = conv.shape[1] // 2
    a = conv[:, :h]
    g = round_bf16(0.5 * a * (1.0 + torch.erf(a * 0.7071067811865476)) * conv[:, h:])
    out = proj["W2"](g).reshape(B, -1, L).to(torch.bfloat16)
    if drop == "none":
        err = (out.float() - plain.float()).abs().max().item()
        assert err <= smoke.TOL[torch.bfloat16] * plain.float().abs().max().item(), err
    else:  # 0, which misses the card check's tolerance (smoke.compare)
        m = plain.float().abs().max().item()
        assert not out.any() and m > smoke.TOL[torch.bfloat16] * max(m, 1.0), m
