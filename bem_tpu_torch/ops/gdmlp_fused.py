"""Fused channel-first stem and gdMlp: kernels 1 and 4 of the serving path.

``stem_fused_cf``: [LN ->] 1x1 in_proj (+b1) -> depthwise 3x3 (+bdw) -> SiLU.
``gdmlp_fused_cf``: [x +] W2 . (GELU(h1) * h2) + b2 with
[h1; h2] = dw3x3(W1 . LN(x) + b1) + bdw.

Both take the channel-first stream (B, C, H*W) and the weight shapes of
bem_tpu/ops/gdmlp_fused.py. The CUDA kernels are ``csrc/stem_fused.cu`` and
``csrc/gdmlp_fused.cu`` (their headers say what bounds them and how they
are tiled); the ``*_plain`` versions compute the same function with plain
PyTorch ops on any device: the wrappers use them for CPU tensors, and the
card checks hold the kernels against them. The 3x3 conv is zero-padded at
the image border only.

bf16 rounding points follow the Pallas kernels as they run in interpret
mode: the stem pre-rounds W1 to bf16 and does not round its LN output; the
gdMlp rounds its LN output and the gate to bf16 and keeps W1/W2 in fp32.
On the bf16 stream (C, Cout <= 256) the gdMlp's kernel runs both
projections on the tensor cores with bf16 operands: it cuts each fp32
weight into hi = bf16(W) and lo = bf16(W - hi) as it stages it, and
multiplies by each into one fp32 accumulator, which keeps the weights to
about 2^-17 relative. On the bf16 stream (C, Dh <= 256) the stem's kernel
runs its projection on the tensor cores the other way round: W1 is one
exact bf16 operand (pre-rounded here) and the fp32 LN output is cut into
hi = bf16(y) and lo = bf16(y - hi) as the tile is staged, each product run
twice into one fp32 accumulator (once, on x itself, without the LN).
On the fp32 stream (C and Cout / Dh <= 256) both kernels run their
projections on the tensor cores at fp32 accuracy. The gdMlp cuts every
fp32 operand (the LN output, the gate, W1, W2) into bf16 hi and lo (the
weights once a call, by a first launch, into a workspace allocated
here) and runs each product three times into one fp32 accumulator,
hi.hi + lo.hi + hi.lo (about 2^-16 of sum |w| |v|); the stem cuts the LN
output (or x) and W1 into tf32 big and small and runs small.big +
big.small + big.big (3xTF32, about 2^-22). Where the pixel grid is
smaller than the card, the gdMlp splits its hidden width over blocks
(partial outputs in the workspace, added in split order by a last
launch) and the stem deals its hidden chunks over blocks;
:func:`gdmlp_form` and :func:`stem_form` say which form a call runs.
Wider nets run CUDA-core forms on either stream.

Each is a ``torch.library`` operator, ``bem::stem_fused`` and
``bem::gdmlp_fused`` (ops/_common.py). Both are differentiable: the
backward recomputes through the jnp oracles'
counterparts :func:`_stem_ref` and :func:`_gdmlp_ref`
(gdmlp_fused.py:618-673), for every argument that is not None.
"""

from __future__ import annotations

import torch

from .. import _build
from ._common import (check_stream, counted_as, layer_norm_c, need_cuda, operator, ptr,
                      ref_grads, round_bf16, weight)


def _dw3x3(hid: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3, zero padding. hid (B, K, H, W); dw (K, 9) taps [dy][dx]."""
    H, W = hid.shape[-2:]
    hp = torch.nn.functional.pad(hid, (1, 1, 1, 1))
    out = torch.zeros_like(hid)
    for dy in range(3):
        for dx in range(3):
            tap = dw[:, 3 * dy + dx].reshape(1, -1, 1, 1)
            out = out + tap * hp[:, :, dy:dy + H, dx:dx + W]
    return out


def _stem_plain(x, W1, b1, dw, bdw, H, Wd, lns, lnb):
    B, C, L = x.shape
    xi = x.float().reshape(B, C, H, Wd)
    if lns is not None:
        xi = layer_norm_c(xi, lns, lnb)
    hid = torch.einsum("oc,bchw->bohw", W1, xi)
    if b1 is not None:
        hid = hid + b1.reshape(1, -1, 1, 1)
    conv = _dw3x3(hid, dw)
    if bdw is not None:
        conv = conv + bdw.reshape(1, -1, 1, 1)
    return (conv * torch.sigmoid(conv)).reshape(B, -1, L).to(x.dtype).contiguous()


def _stem_args(x, W1, b1, dw, bdw, H, Wd, lns, lnb):
    B, C, L = x.shape
    if L != H * Wd:
        raise ValueError(f"stem_fused_cf: L={L} != {H}*{Wd}")
    check_stream("stem_fused_cf", x)
    dev = x.device
    Dh = W1.shape[0]
    W1 = weight(W1, dev, (Dh, C), "W1")
    if x.dtype == torch.bfloat16:
        W1 = round_bf16(W1)
    return (x, W1, weight(b1, dev, (Dh,), "b1"), weight(dw, dev, (Dh, 9), "dw"),
            weight(bdw, dev, (Dh,), "bdw"), H, Wd, weight(lns, dev, (C,), "lns"),
            weight(lnb, dev, (C,), "lnb"))


def stem_fused_cf_plain(x, W1, b1, dw, bdw, H: int, Wd: int, lns=None, lnb=None):
    """The plain PyTorch version of :func:`stem_fused_cf`, on any device."""
    return _stem_plain(*_stem_args(x, W1, b1, dw, bdw, H, Wd, lns, lnb))


def _stem_cpu(x, W1, b1, dw, bdw, H, Wd, lns, lnb):
    """bem::stem_fused on the CPU: the plain version."""
    return _stem_plain(*_stem_args(x, W1, b1, dw, bdw, H, Wd, lns, lnb))


def _stem_cuda(x, W1, b1, dw, bdw, H, Wd, lns, lnb):
    """bem::stem_fused on the card: one launch."""
    need_cuda(x, "stem_fused_cf")
    x, W1, b1, dw, bdw, H, Wd, lns, lnb = _stem_args(x, W1, b1, dw, bdw, H, Wd, lns, lnb)
    B, C, L = x.shape
    Dh = W1.shape[0]
    out = torch.empty((B, Dh, L), dtype=x.dtype, device=x.device)
    _build.call("bem_stem_fused", ptr(x), ptr(lns), ptr(lnb), ptr(W1), ptr(b1),
                ptr(dw), ptr(bdw), ptr(out), B, C, Dh, H, Wd,
                int(x.dtype == torch.bfloat16))
    stem_fused_cf.launches += 1
    return out


def _stem_fake(x, W1, b1, dw, bdw, H, Wd, lns, lnb):
    _stem_args(x, W1, b1, dw, bdw, H, Wd, lns, lnb)
    return x.new_empty((x.shape[0], W1.shape[0], x.shape[2]))


_stem_op = operator(
    "stem_fused", "(Tensor x, Tensor W1, Tensor? b1, Tensor dw, Tensor? bdw, SymInt H, "
    "SymInt Wd, Tensor? lns, Tensor? lnb) -> Tensor", _stem_cpu, _stem_cuda, _stem_fake)


def _gdmlp_plain(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual):
    B, C, L = x.shape
    h = W1.shape[0] // 2
    bf = x.dtype == torch.bfloat16
    xi = x.float().reshape(B, C, H, Wd)
    if lns is not None:
        xi = layer_norm_c(xi, lns, lnb)
        if bf:
            xi = round_bf16(xi)
    hid = torch.einsum("oc,bchw->bohw", W1, xi)
    if b1 is not None:
        hid = hid + b1.reshape(1, -1, 1, 1)
    conv = _dw3x3(hid, dw)
    if bdw is not None:
        conv = conv + bdw.reshape(1, -1, 1, 1)
    a = conv[:, :h]
    g = 0.5 * a * (1.0 + torch.erf(a * 0.7071067811865476)) * conv[:, h:]
    if bf:
        g = round_bf16(g)
    out = torch.einsum("oc,bchw->bohw", W2, g)
    if b2 is not None:
        out = out + b2.reshape(1, -1, 1, 1)
    out = out.reshape(B, -1, L)
    if residual:
        out = out + x.float()
    return out.to(x.dtype).contiguous()


def _gdmlp_args(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual):
    B, C, L = x.shape
    if L != H * Wd:
        raise ValueError(f"gdmlp_fused_cf: L={L} != {H}*{Wd}")
    check_stream("gdmlp_fused_cf", x)
    dev = x.device
    h2 = W1.shape[0]
    Cout = W2.shape[0]
    if residual and Cout != C:
        raise ValueError(f"gdmlp_fused_cf: residual needs Cout == C ({Cout}, {C})")
    return (x, weight(W1, dev, (h2, C), "W1"), weight(b1, dev, (h2,), "b1"),
            weight(dw, dev, (h2, 9), "dw"), weight(bdw, dev, (h2,), "bdw"),
            weight(W2, dev, (Cout, h2 // 2), "W2"), weight(b2, dev, (Cout,), "b2"),
            H, Wd, weight(lns, dev, (C,), "lns"), weight(lnb, dev, (C,), "lnb"),
            bool(residual))


def gdmlp_fused_cf_plain(x, W1, b1, dw, bdw, W2, b2, H: int, Wd: int, lns=None,
                         lnb=None, residual: bool = False):
    """The plain PyTorch version of :func:`gdmlp_fused_cf`, on any device."""
    return _gdmlp_plain(*_gdmlp_args(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns,
                                     lnb, residual))


def _gdmlp_cpu(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual):
    """bem::gdmlp_fused on the CPU: the plain version."""
    return _gdmlp_plain(*_gdmlp_args(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual))


def _gdmlp_cuda(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual):
    """bem::gdmlp_fused on the card: 1 launch, or 2-3 for the fp32
    tensor-core form (its workspace sized by the library)."""
    need_cuda(x, "gdmlp_fused_cf")
    args = _gdmlp_args(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual)
    x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual = args
    B, C, L = x.shape
    Cout, h = W2.shape
    bf = int(x.dtype == torch.bfloat16)
    nbytes = _build.load().bem_gdmlp_ws(B, C, h, Cout, H, Wd, bf)
    out = torch.empty((B, Cout, L), dtype=x.dtype, device=x.device)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None
    _build.call("bem_gdmlp_fused", ptr(x), ptr(lns), ptr(lnb), ptr(W1),
                ptr(b1), ptr(dw), ptr(bdw), ptr(W2), ptr(b2), ptr(out), ptr(ws),
                B, C, h, Cout, H, Wd, int(residual), bf)
    launches = 1
    if nbytes:  # the fp32 tensor-core form: the weights' chunk images, the
        # kernel and, where the hidden width splits, the partials' sum
        launches = 2 + (gdmlp_form(B, C, h, Cout, H, Wd, x.dtype) > 1)
    gdmlp_fused_cf.launches += launches
    return out


def _gdmlp_fake(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual):
    _gdmlp_args(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual)
    return x.new_empty((x.shape[0], W2.shape[0], x.shape[2]))


_gdmlp_op = operator(
    "gdmlp_fused", "(Tensor x, Tensor W1, Tensor? b1, Tensor dw, Tensor? bdw, Tensor W2, "
    "Tensor? b2, SymInt H, SymInt Wd, Tensor? lns, Tensor? lnb, bool residual) -> Tensor",
    _gdmlp_cpu, _gdmlp_cuda, _gdmlp_fake)


def gdmlp_form(B, C, h, Cout, H, Wd, dtype) -> int:
    """The form the card runs for a gdMlp call: 0 the CUDA-core form, n >= 1
    a tensor-core form, n > 1 the fp32 one with its hidden width split over
    n blocks a tile, -1 where no shared-memory plan fits."""
    return _build.load().bem_gdmlp_form(B, C, h, Cout, H, Wd, int(dtype == torch.bfloat16))


def stem_form(B, C, Dh, H, Wd, dtype) -> int:
    """The form the card runs for a stem call: 0 the CUDA-core form, n >= 1
    a tensor-core form with its hidden chunks dealt over n blocks a tile,
    -1 where no shared-memory plan fits."""
    return _build.load().bem_stem_form(B, C, Dh, H, Wd, int(dtype == torch.bfloat16))


# ---------------------------------------------------------------------------
# backward: recompute through the oracles


def _f32(t):
    return None if t is None else t.float()


def _stem_ref(x, W1, b1, dw, bdw, H, Wd, lns=None, lnb=None):
    """Oracle of the stem (gdmlp_fused.py:486-515), differentiable in every
    argument: the backward path. On the bf16 stream it rounds the LN output
    and W1 (the kernel rounds only W1)."""
    if x.dtype != torch.bfloat16 or lns is None:
        W1 = round_bf16(W1.float()) if x.dtype == torch.bfloat16 else W1.float()
        return _stem_plain(x, W1, _f32(b1), _f32(dw), _f32(bdw), H, Wd, _f32(lns), _f32(lnb))
    B, C, L = x.shape
    xi = round_bf16(layer_norm_c(x.float().reshape(B, C, H, Wd), lns.float(), lnb.float()))
    return _stem_plain(xi.reshape(B, C, L), round_bf16(W1.float()), _f32(b1), _f32(dw),
                       _f32(bdw), H, Wd, None, None).to(x.dtype)


def _gdmlp_ref(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns=None, lnb=None, residual=False):
    """Oracle of the gdMlp (gdmlp_fused.py:289-330), differentiable in every
    argument: the backward path. It is the plain version with W1 and W2
    rounded to bf16 on the bf16 stream."""
    r = round_bf16 if x.dtype == torch.bfloat16 else (lambda t: t)
    return _gdmlp_plain(x, r(W1.float()), _f32(b1), _f32(dw), _f32(bdw), r(W2.float()),
                        _f32(b2), H, Wd, _f32(lns), _f32(lnb), residual)


class _Stem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, W1, b1, dw, bdw, H, Wd, lns, lnb):
        ctx.hw = (H, Wd)
        ctx.save_for_backward(x, W1, b1, dw, bdw, lns, lnb)
        return _stem_op(x, W1, b1, dw, bdw, H, Wd, lns, lnb)

    @staticmethod
    def backward(ctx, g):
        H, Wd = ctx.hw
        x, W1, b1, dw, bdw, lns, lnb = ctx.saved_tensors
        need = ctx.needs_input_grad
        gx, gW1, gb1, gdw, gbdw, glns, glnb = ref_grads(
            need[:5] + need[7:], lambda x, W1, b1, dw, bdw, lns, lnb: _stem_ref(
                x, W1, b1, dw, bdw, H, Wd, lns, lnb),
            g.contiguous(), [x, W1, b1, dw, bdw, lns, lnb])
        return gx, gW1, gb1, gdw, gbdw, None, None, glns, glnb


class _GdMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual):
        ctx.cfg = (H, Wd, residual)
        ctx.save_for_backward(x, W1, b1, dw, bdw, W2, b2, lns, lnb)
        return _gdmlp_op(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual)

    @staticmethod
    def backward(ctx, g):
        H, Wd, residual = ctx.cfg
        need = ctx.needs_input_grad
        gx, gW1, gb1, gdw, gbdw, gW2, gb2, glns, glnb = ref_grads(
            need[:7] + need[9:11], lambda x, W1, b1, dw, bdw, W2, b2, lns, lnb: _gdmlp_ref(
                x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, residual),
            g.contiguous(), ctx.saved_tensors)
        return gx, gW1, gb1, gdw, gbdw, gW2, gb2, None, None, glns, glnb, None


def stem_fused_cf(x, W1, b1, dw, bdw, H: int, Wd: int, lns=None, lnb=None):
    """SS2D stem. x (B, C, H*Wd); W1 (Dh, C); dw (Dh, 9); b1/bdw (Dh,) or None;
    lns/lnb (C,) fold the block's pre-LN in. Returns (B, Dh, H*Wd) in x.dtype.
    Differentiable. ``count_flops`` counts its W1 product, as its plain
    version's einsum (the depthwise taps are elementwise work)."""
    B, C, L = x.shape
    with counted_as(2 * B * L * W1.shape[0] * C):
        return _Stem.apply(x, W1, b1, dw, bdw, H, Wd, lns, lnb)


def gdmlp_fused_cf(x, W1, b1, dw, bdw, W2, b2, H: int, Wd: int, lns=None,
                   lnb=None, residual: bool = False):
    """Fused gdMlp. x (B, C, H*Wd); W1 (2h, C); dw (2h, 9); W2 (Cout, h);
    biases (2h,)/(2h,)/(Cout,) or None; lns/lnb (C,) the folded pre-LN;
    residual adds x (Cout == C). Returns (B, Cout, H*Wd) in x.dtype.
    Differentiable. ``count_flops`` counts its W1 and W2 products."""
    B, C, L = x.shape
    with counted_as(2 * B * L * (W1.shape[0] * C + W2.shape[0] * W2.shape[1])):
        return _GdMlp.apply(x, W1, b1, dw, bdw, W2, b2, H, Wd, lns, lnb, bool(residual))


stem_fused_cf.launches = 0
gdmlp_fused_cf.launches = 0
