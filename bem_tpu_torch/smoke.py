"""Kernel-vs-plain and gradient comparison cases at the main paths' shapes.

Shared by ``chip_smoke.py`` and the ``cuda``-marked test: every kernel case
runs one kernel wrapper and its plain PyTorch version on the same CUDA
tensors (inputs from a numpy seed, realistic weight scales) and reports
the max abs error against a tolerance scaled by the output's magnitude;
every gradient case runs ``torch.autograd.grad`` through one autograd
wrapper (kernel forward, its backward on the card) and through its plain
composition, on the same seeded cotangent. :func:`work` counts the bytes
and operations a case must move and do, for its bound on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .ops import gdmlp_fused as _gd
from .ops import scan as _scan
from .ops import ss2d_fused as _fused
from .ops import ss2d_seq as _seq
from .ops import ss2d_tail as _tail

# kernel name -> (wrapper, plain version, CUDA source, the TPU kernel it replaces)
KERNELS = {
    "stem_fused_cf": (_gd.stem_fused_cf, _gd.stem_fused_cf_plain,
                      "bem_tpu_torch/csrc/stem_fused.cu",
                      "bem_tpu/ops/gdmlp_fused.py:519"),
    "ss2d_seq_pair": (_seq.ss2d_seq_pair, _seq.ss2d_seq_pair_plain,
                      "bem_tpu_torch/csrc/ss2d_seq.cu",
                      "bem_tpu/ops/ss2d_seq.py:490"),
    "ss2d_tail_cf": (_tail.ss2d_tail_cf, _tail.ss2d_tail_cf_plain,
                     "bem_tpu_torch/csrc/ss2d_tail.cu",
                     "bem_tpu/ops/ss2d_tail.py:157"),
    "gdmlp_fused_cf": (_gd.gdmlp_fused_cf, _gd.gdmlp_fused_cf_plain,
                       "bem_tpu_torch/csrc/gdmlp_fused.cu",
                       "bem_tpu/ops/gdmlp_fused.py:334"),
    "ss2d_col_sum": (_seq.ss2d_col_sum, _seq.ss2d_col_sum_plain,
                     "bem_tpu_torch/csrc/ss2d_col.cu",
                     "bem_tpu/ops/ss2d_seq.py:313"),
    "ss2d_col_dir": (_seq.ss2d_col_dir, _seq.ss2d_col_dir_plain,
                     "bem_tpu_torch/csrc/ss2d_col.cu",
                     "bem_tpu/ops/ss2d_seq.py:366"),
    "linear_scan": (_scan.linear_scan, _scan.linear_scan_plain,
                    "bem_tpu_torch/csrc/scan.cu",
                    "bem_tpu/ops/scan.py:157"),
    "ss2d_dir_fused": (_fused.ss2d_dir_fused, _fused.ss2d_dir_fused_plain,
                       "bem_tpu_torch/csrc/ss2d_fused.cu",
                       "bem_tpu/ops/ss2d_fused.py:339"),
    "ss2d_dir_fused_bwd": (_fused.ss2d_dir_fused_bwd, _fused.ss2d_dir_fused_bwd_plain,
                           "bem_tpu_torch/csrc/ss2d_fused.cu",
                           "bem_tpu/ops/ss2d_fused_bwd.py:158"),
    "ss2d_dir_fused_g": (_fused.ss2d_dir_fused_g, _fused.ss2d_dir_fused_g_plain,
                         "bem_tpu_torch/csrc/ss2d_fused.cu",
                         "bem_tpu/ops/ss2d_fused_g.py:309"),
}
# the kernels of the BEM nets' serving and training paths, and of the VSSM
# classifier's (the clamped core runs at narrow widths only, where
# pick_group(B, d_inner) > 1: the reference checks)
BEM_KERNELS = ("stem_fused_cf", "ss2d_seq_pair", "ss2d_tail_cf", "gdmlp_fused_cf",
               "ss2d_col_sum", "ss2d_col_dir", "linear_scan")
CLS_KERNELS = ("ss2d_dir_fused", "ss2d_dir_fused_bwd", "ss2d_dir_fused_g")

# (label, B, C, H, W): the serving path's levels at the 448x640 IE input
# (C = 40 / 80 / 160) and the CG's top level at 28x40, two images each
PATH_SHAPES = [
    ("IE-L0 448x640 C40", 2, 40, 448, 640),
    ("IE-L1 224x320 C80", 2, 80, 224, 320),
    ("IE-L2 112x160 C160", 2, 160, 112, 160),
    ("CG-L0 28x40 C40", 2, 40, 28, 40),
]
# the training path's levels at batch 8: IE 128x128 crops, CG at 8x8
TRAIN_SHAPES = [
    ("train IE-L0 128x128 C40", 8, 40, 128, 128),
    ("train IE-L1 64x64 C80", 8, 80, 64, 64),
    ("train IE-L2 32x32 C160", 8, 160, 32, 32),
    ("train CG-L0 8x8 C40", 8, 40, 8, 8),
    ("train CG-L1 4x4 C80", 8, 80, 4, 4),
    ("train CG-L2 2x2 C160", 8, 160, 2, 2),
]
SMALL_SHAPES = [("small 16x48 C16", 2, 16, 16, 48), ("small 12x20 C40", 1, 40, 12, 20),
                ("small 2x2 C24", 2, 24, 2, 2)]
# (label, B, d_inner, H, W, dt rank, d_state): the SS2D cores of the VMamba-T
# classifier's four stages (dims 96 / 192 / 384 / 768, ssm_ratio 2) at
# 224x224, two images each
CLS_SHAPES = [
    ("VMamba-T S0 56x56 C192", 2, 192, 56, 56, 6, 16),
    ("VMamba-T S1 28x28 C384", 2, 384, 28, 28, 12, 16),
    ("VMamba-T S2 14x14 C768", 2, 768, 14, 14, 24, 16),
    ("VMamba-T S3 7x7 C1536", 2, 1536, 7, 7, 48, 16),
]
SMALL_CLS_SHAPES = [("small 6x10 C24", 2, 24, 6, 10, 2, 16), ("small 5x7 C70", 1, 70, 5, 7, 3, 4)]
# the case whose numbers the summary reports: (label, dtype) per kernel
HEADLINE = {name: ("IE-L0 448x640 C40", "bfloat16") for name in KERNELS}
HEADLINE["linear_scan"] = ("train IE-L0 128x128 C40 bwd", "float32")
HEADLINE["ss2d_dir_fused"] = ("VMamba-T S0 56x56 C192", "bfloat16")
HEADLINE["ss2d_dir_fused_g"] = ("VMamba-T S0 56x56 C192", "bfloat16")
HEADLINE["ss2d_dir_fused_bwd"] = ("VMamba-T S0 56x56 C192", "float32")


def reset_launch_counts() -> None:
    for fn, *_ in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, (fn, *_) in KERNELS.items()}


# relative tolerance on max|plain|: fp32 sums in another order (and the scan
# by doubling instead of a sequential loop); bf16 outputs may differ by a
# few bf16 ulps where the two sides round an intermediate differently
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# kernels with several outputs of unrelated scales: each output against its own
PER_OUTPUT = ("ss2d_dir_fused_bwd",)
# kernels whose (B, 2, C, L) output (the backward: its dxs2) is held per row:
# each (image, stream, channel) against its own largest entry, the clamp
# probe's positions (see _clamp_probe) as rows of their own
PER_ROW = ("ss2d_dir_fused", "ss2d_dir_fused_g", "ss2d_dir_fused_bwd")
GRAD_TOL = 1e-4  # of each gradient's largest entry: two fp32 orders of summation


@dataclass
class Case:
    name: str
    label: str
    dtype: torch.dtype
    args: tuple
    probe: torch.Tensor | None = None  # PER_ROW: the clamp probe's elements
    # the fused forward: err / tol of the kernel against the plain version
    # with the other clamp setting (set by compare; must exceed 1)
    other_clamp: float | None = None

    @property
    def fn(self) -> Callable:
        return KERNELS[self.name][0]

    @property
    def plain(self) -> Callable:
        return KERNELS[self.name][1]


def _uniform(rng, shape, bound):
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _dt_bias(rng, shape, dt_min=1e-3, dt_max=0.1):
    dt = np.exp(rng.uniform(size=shape) * (math.log(dt_max) - math.log(dt_min))
                + math.log(dt_min))
    return (dt + np.log(-np.expm1(-dt))).astype(np.float32)


def _scan_weights(rng, C, t, clamp=False):
    """Per-direction SS2D weights (4, ...) at the init's scales; ``clamp``
    gives every third channel bias +12, so dt*A ~ -12 and the -10 clamp
    bites."""
    R, N = math.ceil(C / 16), 1
    P = R + 2 * N
    bias = _dt_bias(rng, (4, C))
    if clamp:
        bias[:, ::3] = 12.0
    return [t(_uniform(rng, (4, P, C), (4 * P) ** -0.5)),
            t(_uniform(rng, (4, C, R), R ** -0.5)), t(bias),
            t(-np.ones((4, C, N))), t(np.ones((4, C)))]


def _dir(w, d, with_d=True):
    """Direction d's (Wx, Wdt, bias, A[, D]) from the stacked weights."""
    out = tuple(x[d].contiguous() for x in w[:4])
    return out + ((w[4][d].contiguous() if with_d else None),)


def _cases_for(label, B, C, H, W, dtype, device, seed):
    rng = np.random.default_rng(seed)
    L = H * W
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    s = lambda a: t(a).to(dtype)  # noqa: E731
    x = rng.standard_normal((B, C, L)).astype(np.float32)
    lns = 1.0 + 0.1 * rng.standard_normal(C)
    lnb = 0.1 * rng.standard_normal(C)
    cases = []
    cases.append(Case("stem_fused_cf", label, dtype, (
        s(x), t(_uniform(rng, (C, C), C ** -0.5)), None,
        t(_uniform(rng, (C, 9), 1 / 3)), None, H, W, t(lns), t(lnb))))
    xs = x / (1.0 + np.exp(-x))  # SiLU output, as the stem hands it on
    scan_w = _scan_weights(rng, C, t)
    clamp_w = _scan_weights(rng, C, t, clamp=True)
    cases.append(Case("ss2d_seq_pair", label, dtype, (s(xs), *scan_w, "row")))
    cases.append(Case("ss2d_seq_pair", label + " clamp", dtype, (s(xs), *clamp_w, "col")))
    for w, tag in ((scan_w, ""), (clamp_w, " clamp")):
        cases.append(Case("ss2d_col_sum", label + tag, dtype,
                          (s(xs), _dir(w, 1)[:4], _dir(w, 3)[:4], H, W)))
    N = scan_w[3].shape[-1]
    sinit = t(rng.standard_normal((B, C, N * W)))
    yin = s(rng.standard_normal((B, C, L)))
    cases.append(Case("ss2d_col_dir", label, dtype,
                      (s(xs), _dir(scan_w, 1), sinit, yin, H, W, False)))
    cases.append(Case("ss2d_col_dir", label + " clamp", dtype,
                      (s(xs), _dir(clamp_w, 3, with_d=False), sinit, yin, H, W, True)))
    if dtype == torch.float32:  # the cross-column carry: (B, W, C*N) fp32
        a = t(np.exp(-rng.uniform(0.0, 3.0, (B, W, C * N))))
        b = t(rng.standard_normal((B, W, C * N)))
        for rev in (False, True):
            cases.append(Case("linear_scan", label + (" rev" if rev else ""), dtype,
                              (a, b, rev)))
    y0 = 3.0 + rng.standard_normal((B, C, L)) * 2.0
    cases.append(Case("ss2d_tail_cf", label, dtype, (
        s(y0), s(rng.standard_normal((B, C, L))), t(lns), t(lnb),
        t(_uniform(rng, (C, C), C ** -0.5)), None, s(rng.standard_normal((B, C, L))))))
    h = 4 * C
    cases.append(Case("gdmlp_fused_cf", label, dtype, (
        s(x), t(_uniform(rng, (2 * h, C), C ** -0.5)), t(_uniform(rng, 2 * h, C ** -0.5)),
        t(_uniform(rng, (2 * h, 9), 1 / 3)), t(_uniform(rng, 2 * h, 1 / 3)),
        t(_uniform(rng, (C, h), h ** -0.5)), t(_uniform(rng, C, h ** -0.5)), H, W,
        t(lns), t(lnb), True)))
    return cases


def _scan_bwd_cases(label, B, C, H, W, device, seed):
    """linear_scan at the scan pairs' backward recompute shape (B, L, C*N),
    forward and reverse, with decays of the dt init's range."""
    rng = np.random.default_rng(seed)
    shape = (B, H * W, C)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    a = t(np.exp(-rng.uniform(0.0, 0.1, shape)))
    b = t(rng.standard_normal(shape))
    return [Case("linear_scan", label + " bwd" + (" rev" if rev else ""), torch.float32,
                 (a, b, rev)) for rev in (False, True)]


def _fused_weights(rng, C, R, N, t):
    """The fused core's (Wx, Wdt, bias, A, D) at the v0 init's scales
    (x_proj +-(4P)^-0.5, dt_proj +-R^-0.5, the dt bias, A = -(1..N), D = 1),
    with bias +12 on every third channel so dt*A < -10 there."""
    P = R + 2 * N
    bias = _dt_bias(rng, (4, C))
    bias[:, ::3] = 12.0
    A = -np.broadcast_to(np.arange(1, N + 1, dtype=np.float32), (4, C, N))
    return [t(_uniform(rng, (4, P, C), (4 * P) ** -0.5)), t(_uniform(rng, (4, C, R), R ** -0.5)),
            t(bias), t(A), t(np.ones((4, C)))]


def _clamp_probe(xs2):
    """Zero x at the odd positions of the clamped channels (every third, as
    _fused_weights sets them) in both streams; returns the mask of those
    elements. There D*x and the input term vanish and y is the decay of the
    neighbours' states alone, sum_n C_n exp(dt A_n) h_n: exp(-10) where
    clamped, exp(dt A_n) <= exp(-11) unclamped (dt ~ softplus(12)), so the
    clamp changes y there by a factor of e or more."""
    mask = np.zeros(xs2.shape, bool)
    mask[:, :, ::3, 1::2] = True
    xs2[mask] = 0.0
    return mask


def _cls_cases(label, B, C, H, W, R, N, device, seed):
    """The fused core, its clamped form (fp32, bf16) and its backward (fp32)
    at one stage: xs2 = the (row, column) sequences of a SiLU output, with
    the clamp probe."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    x = rng.standard_normal((B, C, H, W)).astype(np.float32)
    x = x / (1.0 + np.exp(-x))
    xs2 = np.stack([x.reshape(B, C, H * W), x.transpose(0, 1, 3, 2).reshape(B, C, H * W)], 1)
    probe = torch.from_numpy(_clamp_probe(xs2)).to(device)
    w = _fused_weights(rng, C, R, N, t)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        xs = t(xs2).to(dtype)
        out += [Case("ss2d_dir_fused", label, dtype, (xs, *w), probe),
                Case("ss2d_dir_fused_g", label, dtype, (xs, *w), probe)]
    g = t(rng.standard_normal(xs2.shape))
    out.append(Case("ss2d_dir_fused_bwd", label, torch.float32, (t(xs2), *w, g), probe))
    return out


def kernel_cases(small: bool = False, device="cuda"):
    """Every kernel at every serving, training and classifier shape, fp32 and
    bf16, or at tiny shapes (``small``)."""
    shapes = SMALL_SHAPES if small else PATH_SHAPES + TRAIN_SHAPES
    out = []
    for i, (label, B, C, H, W) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            out += _cases_for(label, B, C, H, W, dtype, device, seed=i)
        if label.startswith("train IE") or small:
            out += _scan_bwd_cases(label, B, C, H, W, device, seed=100 + i)
    for i, shape in enumerate(SMALL_CLS_SHAPES if small else CLS_SHAPES):
        out += _cls_cases(*shape, device, seed=300 + i)
    return out


def _outputs(o):
    return o if isinstance(o, tuple) else (o,)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize()


def row_scaled(out, ref, rel, probe=None):
    """(error, tolerance) at the element of ``out`` worst against ``ref``,
    each element's tolerance ``rel`` times the largest |ref| of its row
    (the last axis) -- with ``probe`` (a bool mask), the largest over the
    probe's or the other elements of that row, whichever it belongs to."""
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    worst = (-1.0, 0.0, 0.0)
    for m in ([None] if probe is None else [probe, ~probe]):
        dm = d if m is None else torch.where(m, d, 0.0)
        tol = rel * (r if m is None else torch.where(m, r, 0.0)).amax(-1, keepdim=True)
        ratio = dm / tol.clamp_min(1e-30)
        i = int(ratio.argmax())
        q = ratio.flatten()[i].item()
        if q > worst[0]:
            worst = (q, dm.flatten()[i].item(), tol.expand_as(dm).flatten()[i].item())
    return worst[1], worst[2]


@torch.inference_mode()
def compare(case: Case):
    """(max abs error of the kernel vs its plain version, the tolerance).
    The fused forward must also fail the same check against the plain
    version with the other clamp setting (its err / tol lands in
    ``case.other_clamp``), or the check could not see the clamp flag."""
    outs = _outputs(case.fn(*case.args))
    refs = _outputs(case.plain(*case.args))
    _sync(outs[0])
    err, scale = 0.0, 1.0
    worst = None  # PER_OUTPUT: (err / tol, err, tol) of the worst output
    for j, (out, ref) in enumerate(zip(outs, refs, strict=True)):
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"{case.name}: {out.shape}/{out.dtype} vs "
                                 f"{ref.shape}/{ref.dtype}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{case.name} {case.label}: non-finite kernel output")
        if case.name in PER_ROW and j == 0:
            e, tol = row_scaled(out, ref, TOL[case.dtype], case.probe)
        else:
            e = (out.float() - ref.float()).abs().max().item()
            m = ref.float().abs().max().item()
            err, scale = max(err, e), max(scale, m)
            tol = TOL[case.dtype] * max(m, 1e-12)
        if worst is None or e / tol > worst[0]:
            worst = (e / tol, e, tol)
    if case.name in ("ss2d_dir_fused", "ss2d_dir_fused_g"):
        other = _fused.ss2d_dir_fused_plain(*case.args, clamp=case.name == "ss2d_dir_fused")
        e, tol = row_scaled(outs[0], other, TOL[case.dtype], case.probe)
        case.other_clamp = e / tol
        if e <= tol:
            raise AssertionError(f"{case.name} {case.label}: the check cannot tell the "
                                 f"clamped function from the unclamped ({e} <= {tol})")
    if case.name in PER_OUTPUT or case.name in PER_ROW:
        return worst[1], worst[2]
    return err, TOL[case.dtype] * scale


@torch.inference_mode()
def time_ms(fn, args, budget_ms: float = 300.0) -> float:
    """Mean device time of ``fn(*args)`` over repeated launches (CUDA events)."""
    fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    reps = int(min(20, max(2, budget_ms // once)))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# the least time the card could take: published H100 SXM peaks

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12       # CUDA cores, fp32 (also the rate of exp / softplus work)
BF16_TC_FLOPS = 989e12   # tensor cores, dense bf16


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def _scan_dir_ops(B, C, L, R, N, with_y):
    """Per-direction elementwise operations of the SS2D scan on top of the
    projection: dt (R FMAs + softplus), per state the decay (mul, max,
    exp), the input (2 muls), the step (FMA) and, with y, the readout (FMA)."""
    return B * L * C * (2 * R + 4 + N * (2 + 1 + 1 + 2 + 2 + (2 if with_y else 0)))


def work(case: Case):
    """(bytes, matmul operations, other operations) the case's function
    needs: each input read once, each output written once."""
    a = case.args
    outs = _outputs(case.plain(*a))
    io = _nbytes(*[x for x in a if isinstance(x, torch.Tensor)]) + _nbytes(*outs)
    for x in a:  # weight tuples of the column kernels
        if isinstance(x, tuple):
            io += _nbytes(*x)
    if case.name == "linear_scan":
        return io, 0, 2 * a[0].numel()
    if case.name in CLS_KERNELS:
        B, _, C, L = a[0].shape
        P, N = a[1].shape[1], a[4].shape[-1]
        R = P - 2 * N
        fwd = 4 * _scan_dir_ops(B, C, L, R, N, True)
        if case.name != "ss2d_dir_fused_bwd":  # the 4 directions' projections
            return io, 4 * 2 * B * L * P * C, fwd
        # the projection again, dxdbl[:R], dx, dWx, dWdt; the forward once more
        # and per (position, channel, state) the lambda step, da, ddt, dx,
        # dA, dB and dC terms (2 + 1 + 4 + 2 + 2 + 2 + 2)
        return (io, 4 * 2 * B * L * C * (3 * P + 2 * R),
                fwd + 4 * B * C * L * (15 * N + 6))
    B, C, L = a[0].shape
    if case.name == "stem_fused_cf":
        Dh = a[1].shape[0]
        return io, 2 * B * L * C * Dh, B * L * (8 * C + Dh * (18 + 4))
    if case.name == "gdmlp_fused_cf":
        h2, Cout = a[1].shape[0], a[5].shape[0]
        return io, 2 * B * L * (C * h2 + h2 // 2 * Cout), B * L * (8 * C + 20 * h2 + 12 * h2 // 2)
    if case.name == "ss2d_tail_cf":
        Cout = a[4].shape[1]
        return io, 2 * B * L * C * Cout, B * L * 10 * C
    if case.name == "ss2d_seq_pair":
        P, N = a[1].shape[1], a[4].shape[-1]
        R = P - 2 * N
        return io, 2 * 2 * B * L * P * C, 2 * _scan_dir_ops(B, C, L, R, N, True)
    P, N = a[1][0].shape[0], a[1][3].shape[-1]
    R = P - 2 * N
    if case.name == "ss2d_col_sum":  # both directions, no readout rows
        return io, 2 * 2 * B * L * (R + N) * C, 2 * _scan_dir_ops(B, C, L, R, N, False)
    return io, 2 * B * L * P * C, _scan_dir_ops(B, C, L, R, N, True)  # ss2d_col_dir


def bound_ms(case: Case):
    """(least ms on an H100 SXM, "bytes" or "operations"): the larger of
    bytes over the HBM rate and operations over the peak rate of their
    type (matmul work on bf16 tensor cores for the bf16 stream, fp32 CUDA
    cores otherwise; elementwise work at the fp32 rate)."""
    nbytes, mm, ew = work(case)
    mm_rate = BF16_TC_FLOPS if case.dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = mm / mm_rate + ew / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# gradients: autograd wrapper (kernel forward, backward on the card) vs the
# plain composition, on one seeded cotangent


@dataclass
class GradCase:
    name: str
    label: str
    fn: Callable        # the autograd wrapper
    plain: Callable     # the plain differentiable composition
    args: list          # tensors (differentiated) or None
    cot_shape: tuple


def _col_pair_plain(x, Wx, Wdt, bias, A, D, y0, H, W):
    d_f, d_r = _seq.PAIRS["col"]
    xT = _seq._transpose_hw(x, H, W)
    y = _seq._seq_pair_ref(xT, Wx, Wdt, bias, A, D, d_f, d_r, scan=_scan.linear_scan_plain)
    return _seq._transpose_hw(y, W, H) + y0


def _cls_grad_cases(small, device):
    """The fused core's autograd wrappers (kernel forward, kernel 9
    backward) vs autograd through the unclamped plain core, both forms."""
    out = []
    for i, (label, B, C, H, W, R, N) in enumerate(SMALL_CLS_SHAPES if small else CLS_SHAPES):
        rng = np.random.default_rng(400 + i)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
        xs2 = t(rng.standard_normal((B, 2, C, H * W)))
        args = [xs2 * torch.sigmoid(xs2), *_fused_weights(rng, C, R, N, t)]
        for name, fn in (("ss2d_dir_fused", _fused.ss2d_dir_fused),
                         ("ss2d_dir_fused_g", _fused.ss2d_dir_fused_g)):
            out.append(GradCase(name, label, fn, _fused.ss2d_dir_fused_plain, args,
                                (B, 2, C, H * W)))
    return out


def grad_cases(small: bool = False, device="cuda"):
    """The five autograd wrappers of the VSSBlock and linear_scan at the
    training shapes (``small``: tiny shapes), fp32, clamp-hitting scan
    biases; then the classifier's fused core at its stage shapes."""
    out = _cls_grad_cases(small, device)
    for i, (label, B, C, H, W) in enumerate(SMALL_SHAPES if small else TRAIN_SHAPES):
        rng = np.random.default_rng(200 + i)
        L = H * W
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
        x = t(rng.standard_normal((B, C, L)))
        ln = [t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C))]
        dw = t(_uniform(rng, (C, 9), 1 / 3))
        W1 = t(_uniform(rng, (C, C), C ** -0.5))
        out.append(GradCase(
            "stem_fused_cf", label, lambda *a, H=H, W=W: _gd.stem_fused_cf(
                a[0], a[1], None, a[2], None, H, W, a[3], a[4]),
            lambda *a, H=H, W=W: _gd._stem_ref(a[0], a[1], None, a[2], None, H, W, a[3], a[4]),
            [x, W1, dw, *ln], (B, C, L)))
        h = 4 * C
        g_args = [x, t(_uniform(rng, (2 * h, C), C ** -0.5)), t(_uniform(rng, 2 * h, 0.1)),
                  t(_uniform(rng, (2 * h, 9), 1 / 3)), t(_uniform(rng, 2 * h, 0.1)),
                  t(_uniform(rng, (C, h), h ** -0.5)), t(_uniform(rng, C, 0.1)), *ln]
        out.append(GradCase(
            "gdmlp_fused_cf", label, lambda *a, H=H, W=W: _gd.gdmlp_fused_cf(
                *a[:7], H, W, a[7], a[8], True),
            lambda *a, H=H, W=W: _gd._gdmlp_ref(*a[:7], H, W, a[7], a[8], True),
            g_args, (B, C, L)))
        out.append(GradCase(
            "ss2d_tail_cf", label, _tail.ss2d_tail_cf, _tail._tail_ref,
            [x, None, *ln, t(_uniform(rng, (C, C), C ** -0.5)), None, x], (B, C, L)))
        xs = x * torch.sigmoid(x)
        w = _scan_weights(rng, C, t, clamp=True)
        out.append(GradCase(
            "ss2d_seq_pair", label, lambda *a: _seq.ss2d_seq_pair(*a, "row"),
            lambda *a: _seq._seq_pair_ref(*a, 0, 2, scan=_scan.linear_scan_plain),
            [xs, *w], (B, C, L)))
        y0 = t(rng.standard_normal((B, C, L)))
        out.append(GradCase(
            "ss2d_col_pair", label, lambda *a, H=H, W=W: _seq.ss2d_col_pair(*a, H, W),
            lambda *a, H=H, W=W: _col_pair_plain(*a, H, W), [xs, *w, y0], (B, C, L)))
        a = t(np.exp(-rng.uniform(0.0, 0.1, (B, L, C))))
        for rev in (False, True):
            out.append(GradCase(
                "linear_scan", label + (" rev" if rev else ""),
                lambda a, b, rev=rev: _scan.linear_scan(a, b, rev),
                lambda a, b, rev=rev: _scan.linear_scan_plain(a, b, rev),
                [a, t(rng.standard_normal((B, L, C)))], (B, L, C)))
    return out


def compare_grads(case: GradCase):
    """(max abs error over every gradient, the tolerance) of the wrapper's
    gradients against the plain composition's."""
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(case.cot_shape)
                         .astype(np.float32)).to(case.args[0].device)
    res = []
    for fn in (case.fn, case.plain):
        ins = [None if a is None else a.detach().clone().requires_grad_() for a in case.args]
        wrt = [a for a in ins if a is not None]
        res.append(torch.autograd.grad(fn(*ins), wrt, g))
    _sync(g)
    err, tol = 0.0, 0.0
    for out, ref in zip(*res, strict=True):
        if not torch.isfinite(out).all():
            raise AssertionError(f"{case.name} {case.label}: non-finite gradient")
        scale = ref.abs().max().item()
        e = (out - ref).abs().max().item()
        if e > GRAD_TOL * scale + 1e-12:
            return e, GRAD_TOL * scale
        err, tol = max(err, e), max(tol, GRAD_TOL * scale)
    return err, tol
