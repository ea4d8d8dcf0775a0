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

import functools
import math
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import _build
from .enhancement.clip import flatten_params
from .ops import gdmlp_fused as _gd
from .ops import scan as _scan
from .ops import scan_fused as _sf
from .ops import ss2d_fused as _fused
from .ops import ss2d_seq as _seq
from .ops import ss2d_tail as _tail
from .ops.cross_scan import cross_scan_cf_input
from .tools import microbench_vpu as _mb
from .utils.img_util import imwrite

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
    "selective_scan_fused": (_sf.selective_scan_fused, _sf.selective_scan_fused_plain,
                             "bem_tpu_torch/csrc/scan_fused.cu",
                             "bem_tpu/ops/scan_fused.py:179"),
    "vpu_scan_step": (_mb.vpu_scan_step, _mb.vpu_scan_step_plain,
                      "bem_tpu_torch/csrc/microbench_vpu.cu", "tools/microbench_vpu.py:51"),
    "vpu_op_rounds": (_mb.vpu_op_rounds, _mb.vpu_op_rounds_plain,
                      "bem_tpu_torch/csrc/microbench_vpu.cu", "tools/microbench_vpu.py:103"),
}
# the kernels of the BEM nets' serving and training paths, and of the VSSM
# classifier's (the clamped core runs at narrow widths only, where
# pick_group(B, d_inner) > 1: the reference checks)
BEM_KERNELS = ("stem_fused_cf", "ss2d_seq_pair", "ss2d_tail_cf", "gdmlp_fused_cf",
               "ss2d_col_sum", "ss2d_col_dir", "linear_scan")
CLS_KERNELS = ("ss2d_dir_fused", "ss2d_dir_fused_bwd", "ss2d_dir_fused_g")
# the scan-pattern forward types' core (v051d / v052d) and the microbenchmarks
SCAN_KERNELS = ("selective_scan_fused",)
MICROBENCH_KERNELS = ("vpu_scan_step", "vpu_op_rounds")
COL_KERNELS = ("ss2d_col_sum", "ss2d_col_dir")

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
# the IE stage of a serving request runs K * NIMG = 32 images at once: rows
# 1, 2, 4, 5 and 6 at that batch (bf16), their plain versions on slices of
# PLAIN_SLICE images (the gdMlp's fp32 hidden map alone is 11.7 GB at B=32);
# the stem also at the bottleneck level
SERVE_SHAPES = [("IE-L0 448x640 C40 B=32", 32, 40, 448, 640),
                ("IE-L1 224x320 C80 B=32", 32, 80, 224, 320)]
SERVE_STEM_SHAPES = [("IE-L2 112x160 C160 B=32", 32, 160, 112, 160)]
PLAIN_SLICE = 4
# linear_scan's carries on the serving path, (label, M, L, D): the row and
# column pairs' carry over (B, chunks, C*N) at IE-L0 B=32 (32-position row
# chunks of 448x640, 14 column chunks of 640 columns) and the CG's at
# 28x40 B=2 (35 row chunks); the eval CLI's (B=8, B=1) and the flagship's
# top level (224x320 B=8: 2240 row chunks, 7 column chunks of 320 columns)
SERVE_SCAN_SHAPES = [("IE-L0 carry B=32", 32, 8960, 40), ("CG-L0 carry 28x40", 2, 35, 40),
                     ("eval IE-L0 carry B=8", 8, 8960, 40), ("eval CG-L0 carry B=1", 1, 35, 40),
                     ("flagship L0 carry B=8", 8, 2240, 40)]
# the eval CLI's network on the fp32 stream: the IE on parallel_num = 8
# candidates at a time, the CG on one weight sample at a time (K forwards)
EVAL_SHAPES = [("eval IE-L0 448x640 C40 B=8", 8, 40, 448, 640),
               ("eval IE-L1 224x320 C80 B=8", 8, 80, 224, 320),
               ("eval IE-L2 112x160 C160 B=8", 8, 160, 112, 160),
               ("eval CG-L0 28x40 C40 B=1", 1, 40, 28, 40),
               ("eval CG-L1 14x20 C80 B=1", 1, 80, 14, 20),
               ("eval CG-L2 7x10 C160 B=1", 1, 160, 7, 10)]
# the flagship (DecompDualBranchDDWavelet) as the eval CLI's IE, fp32: its
# two branches and shared bottleneck run at half the 448x640 padded input,
# on parallel_num = 8 candidates at a time
FLAGSHIP_SHAPES = [("flagship L0 224x320 C40 B=8", 8, 40, 224, 320),
                   ("flagship L1 112x160 C80 B=8", 8, 80, 112, 160),
                   ("flagship L2 56x80 C160 B=8", 8, 160, 56, 80)]
# the flagship's training from its option file, fp32: each branch at batch 8
# on the 64x64 wavelet half of the 128x128 crops, forward and backward
FLAGSHIP_TRAIN_SHAPES = [("flagship train L0 64x64 C40 B=8", 8, 40, 64, 64),
                         ("flagship train L1 32x32 C80 B=8", 8, 80, 32, 32),
                         ("flagship train L2 16x16 C160 B=8", 8, 160, 16, 16)]
# the speed test (enhancement/speed_test.py) at its 2048x2048 input, B=1:
# the IE's levels and the CG's at the /16 reduction, bf16 and fp32
SPEED_SHAPES = [("speed IE-L0 2048x2048 C40 B=1", 1, 40, 2048, 2048),
                ("speed IE-L1 1024x1024 C80 B=1", 1, 80, 1024, 1024),
                ("speed IE-L2 512x512 C160 B=1", 1, 160, 512, 512),
                ("speed CG-L0 128x128 C40 B=1", 1, 40, 128, 128),
                ("speed CG-L1 64x64 C80 B=1", 1, 80, 64, 64),
                ("speed CG-L2 32x32 C160 B=1", 1, 160, 32, 32)]
# (label, B, d_inner, H, W, dt rank, d_state): the SS2D cores of the VMamba-T
# classifier's four stages (dims 96 / 192 / 384 / 768, ssm_ratio 2) at
# 224x224, two images each
CLS_SHAPES = [
    ("VMamba-T S0 56x56 C192", 2, 192, 56, 56, 6, 16),
    ("VMamba-T S1 28x28 C384", 2, 384, 28, 28, 12, 16),
    ("VMamba-T S2 14x14 C768", 2, 768, 14, 14, 24, 16),
    ("VMamba-T S3 7x7 C1536", 2, 1536, 7, 7, 48, 16),
]
# linear_scan in the cascade SS2D (v052dc) of VMamba-T (d_state 1, ssm_ratio
# 2) at 224x224, (label, B, H, d_inner): each stage's bidirectional row scan
# runs over (B*H, W, 2*d_inner*N) and its column scan over (B*W, H, ...) --
# square maps, so one shape a stage -- at batch 2 and at the training and
# throughput batch 128; forward and reverse (the backward's direction)
CASCADE_SHAPES = [("VMamba-T v052dc S0 56x56", 56, 192), ("VMamba-T v052dc S1 28x28", 28, 384),
                  ("VMamba-T v052dc S2 14x14", 14, 768), ("VMamba-T v052dc S3 7x7", 7, 1536)]
CASCADE_BATCHES = (2, 128)
# the classifier's training batch (the harness's default): row 9 at stage 0,
# rows 8, 10 and 11 (bf16, the throughput batch too) at stages 0 and 2
CLS_TRAIN_BATCH = 128
CLS_BATCH_STAGES = (0, 2)
SMALL_CLS_SHAPES = [("small 6x10 C24", 2, 24, 6, 10, 2, 16), ("small 5x7 C70", 1, 70, 5, 7, 3, 4)]
# the case whose numbers the summary reports: (label, dtype) per kernel
HEADLINE = {name: ("IE-L0 448x640 C40", "bfloat16") for name in KERNELS}
HEADLINE["linear_scan"] = ("train IE-L0 128x128 C40 bwd", "float32")
HEADLINE["ss2d_dir_fused"] = ("VMamba-T S0 56x56 C192", "bfloat16")
HEADLINE["ss2d_dir_fused_g"] = ("VMamba-T S0 56x56 C192", "bfloat16")
HEADLINE["ss2d_dir_fused_bwd"] = ("VMamba-T S0 56x56 C192", "float32")
HEADLINE["selective_scan_fused"] = ("VMamba-T S0 56x56 C192 scans2", "bfloat16")
HEADLINE["vpu_scan_step"] = ("lanes 4096 npass 10", "float32")
HEADLINE["vpu_op_rounds"] = ("mode exp", "float32")


def kernel_form(case: Case) -> str:
    """Which form of the stem or the gdMlp the card runs for ``case``
    (tensor-core or CUDA-core, and the fp32 form's hidden split), else ""."""
    if case.name not in ("stem_fused_cf", "gdmlp_fused_cf"):
        return ""
    B, C, _ = case.args[0].shape
    if case.name == "stem_fused_cf":
        H, W = case.args[5:7]
        n = _gd.stem_form(B, C, case.args[1].shape[0], H, W, case.dtype)
    else:
        H, W = case.args[7:9]
        Cout, h = case.args[5].shape
        n = _gd.gdmlp_form(B, C, h, Cout, H, W, case.dtype)
    if n <= 0:
        return "CUDA-core form" if n == 0 else "no plan"
    return "tensor-core form" + (f", hidden split {n}" if n > 1 else "")


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
PER_ROW = ("ss2d_dir_fused", "ss2d_dir_fused_g", "ss2d_dir_fused_bwd", "selective_scan_fused")
GRAD_TOL = 1e-4  # of each gradient's largest entry: two fp32 orders of summation
# kernels whose every output must be bit-identical over two launches (each
# cross-block sum is an ordered pass, or, linear_scan's look-back, folds
# its predecessors in a fixed order; the gdMlp's hidden-split partials are
# added in split order; vpu_scan_step has no cross-thread sum at all)
BIT_EXACT = ("ss2d_dir_fused_bwd", "linear_scan", "gdmlp_fused_cf", "stem_fused_cf",
             "vpu_scan_step")


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
    # > 0: the plain version runs on slices of this many images of the
    # args at ``batch_args`` (the stream first)
    plain_slice: int = 0
    batch_args: tuple = (0,)
    # the plain version's outputs after the first are sums over images
    # (the backward's weight gradients): added over the slices
    sum_rest: bool = False
    probe_out: int = 0  # the output the probe's elements belong to
    row_axis: int = -1  # PER_ROW / probe checks: the axis a row runs along
    # BIT_EXACT kernels: whether a second launch gave the same bits (compare)
    repeatable: bool | None = None
    # a path shape whose bound chip_smoke prints beside its times
    report: bool = False

    @property
    def fn(self) -> Callable:
        return KERNELS[self.name][0]

    @property
    def plain(self) -> Callable:
        return self.plain_with()

    def plain_with(self, fn=None, **kw) -> Callable:
        """The plain version (or ``fn``, with keyword arguments ``kw``), on
        slices of ``plain_slice`` images where that is set."""
        fn, n = fn or KERNELS[self.name][1], self.plain_slice
        if kw:
            fn = functools.partial(fn, **kw)
        if not n:
            return fn

        def sliced(*args):
            B = args[0].shape[0]
            parts = [_outputs(fn(*(a[i:i + n] if j in self.batch_args and a is not None else a
                                   for j, a in enumerate(args))))
                     for i in range(0, B, n)]
            outs = tuple(torch.cat(o) if j == 0 or not self.sum_rest else sum(o)
                         for j, o in enumerate(zip(*parts)))
            return outs if len(outs) > 1 else outs[0]
        return sliced


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


def _cases_for(label, B, C, H, W, dtype, device, seed, col_probe=True, clamp=True, rng=None):
    """Rows 1-7 at one shape and dtype; ``clamp`` adds the row pair's
    clamp-hitting case, ``col_probe`` the column pair's clamp probes;
    ``rng`` (default: seeded by ``seed``) draws the inputs."""
    rng = np.random.default_rng(seed) if rng is None else rng
    L = H * W
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    s = lambda a: t(a).to(dtype)  # noqa: E731
    x = rng.standard_normal((B, C, L)).astype(np.float32)
    lns = 1.0 + 0.1 * rng.standard_normal(C)
    lnb = 0.1 * rng.standard_normal(C)
    cases = [_stem_case(label, dtype, rng, t, s(x), H, W, lns, lnb)]
    xs = x / (1.0 + np.exp(-x))  # SiLU output, as the stem hands it on
    scan_w = _scan_weights(rng, C, t)
    clamp_w = _scan_weights(rng, C, t, clamp=True)
    cases.append(Case("ss2d_seq_pair", label, dtype, (s(xs), *scan_w, "row")))
    if clamp:
        cases.append(Case("ss2d_seq_pair", label + " clamp", dtype, (s(xs), *clamp_w, "col")))
    cases += _col_cases(label, dtype, rng, t, xs, H, W, scan_w, False, device)
    if col_probe:
        cases += _col_cases(label, dtype, rng, t, xs, H, W, clamp_w, True, device)
    N = scan_w[3].shape[-1]
    if dtype == torch.float32:  # a carry over (B, W, C*N) fp32
        a = t(np.exp(-rng.uniform(0.0, 3.0, (B, W, C * N))))
        b = t(rng.standard_normal((B, W, C * N)))
        for rev in (False, True):
            cases.append(Case("linear_scan", label + (" rev" if rev else ""), dtype,
                              (a, b, rev)))
    y0 = 3.0 + rng.standard_normal((B, C, L)) * 2.0
    cases.append(Case("ss2d_tail_cf", label, dtype, (
        s(y0), s(rng.standard_normal((B, C, L))), t(lns), t(lnb),
        t(_uniform(rng, (C, C), C ** -0.5)), None, s(rng.standard_normal((B, C, L))))))
    cases.append(_gdmlp_case(label, dtype, rng, t, s(x), H, W, lns, lnb))
    return cases


def _stem_case(label, dtype, rng, t, x, H, W, lns, lnb):
    """The stem (Dh = C, the serving nets' ssm_ratio 1, no biases) on
    stream x (B, C, H*W) with the block's pre-LN folded in."""
    C = x.shape[1]
    return Case("stem_fused_cf", label, dtype, (
        x, t(_uniform(rng, (C, C), C ** -0.5)), None,
        t(_uniform(rng, (C, 9), 1 / 3)), None, H, W, t(lns), t(lnb)))


def _col_dirs(w):
    """The column pair's (forward, reverse) weights as the pair hands them
    to its passes: directions 1 and 3, D_1 + D_3 on the forward."""
    fwd = _dir(w, 1, with_d=False)[:4] + ((w[4][1] + w[4][3]).contiguous(),)
    return fwd, _dir(w, 3, with_d=False)


def col_chunk_for(C, w, dtype, device, H):
    """The column pair's chunk length on the card (csrc/ss2d_col.cu);
    one chunk per column for CPU cases."""
    N = w[3].shape[-1]
    if torch.device(device).type != "cuda":
        return H
    return _seq.col_chunk(C, w[0].shape[1] - 2 * N, N, dtype)


def _col_cases(label, dtype, rng, t, xs, H, W, w, probe, device, y0=True):
    """Rows 5 and 6 (the column pair's summary and full pass) on the stream
    xs (numpy (B, C, H*W)) with weights w, at the card's chunk length; the
    full pass from random chunk states, with y0 unless ``probe``. ``probe``
    (w the clamp-hitting weights): x zero at the odd rows of the clamped
    channels, where b = 0 and the state is the decay of the row above's
    alone (exp(-10) clamped, <= exp(-11) unclamped): the full pass's
    output there (rows along H*W), and the forward summaries of chunks
    ending on such a row (rows along the chunk sequence: a chunk's sum
    over its rows may cancel to far below its channel's scale), are held
    apart as rows of their own, and must fail the check against the
    unclamped function."""
    B, C, L = xs.shape
    N = w[3].shape[-1]
    fwd, rev = _col_dirs(w)
    T = col_chunk_for(C, w, dtype, device, H)
    nch = -(-H // T)
    x = xs.copy()
    if probe:
        mask = np.zeros((B, C, H, W), bool)
        mask[:, ::3, 1::2] = True
        x[mask.reshape(B, C, L)] = 0.0
    xt = t(x).to(dtype)
    h_f, h_r = (t(rng.standard_normal((B, W * nch, C * N))) for _ in range(2))
    yin = t(rng.standard_normal((B, C, L))).to(dtype) if y0 and not probe else None
    tag = " clamp" if probe else ""
    cases = [Case("ss2d_col_sum", label + tag, dtype, (xt, fwd[:4], rev[:4], H, W, T)),
             Case("ss2d_col_dir", label + tag, dtype, (xt, fwd, rev, h_f, h_r, yin, H, W, T),
                  batch_args=(0, 3, 4, 5))]
    if probe:
        ends = np.minimum(np.arange(1, nch + 1) * T, H) - 1
        if not (ends % 2 == 1).any():
            raise ValueError(f"column probe at H={H}, T={T}: no chunk ends on a zeroed row")
        m = np.zeros((B, W, nch, C, N), bool)
        m[:, :, ends % 2 == 1, ::3] = True
        cases[0].probe = torch.from_numpy(m.reshape(B, W * nch, C * N)).to(device)
        cases[0].probe_out = 1  # b_f, a row per (image, channel, state) over its chunks
        cases[0].row_axis = 1
        cases[1].probe = torch.from_numpy(mask.reshape(B, C, L)).to(device)
    return cases


def _gdmlp_case(label, dtype, rng, t, x, H, W, lns, lnb):
    """The gdMlp block branch (mlp_ratio 4, residual) on stream x (B, C, H*W)."""
    C = x.shape[1]
    h = 4 * C
    return Case("gdmlp_fused_cf", label, dtype, (
        x, t(_uniform(rng, (2 * h, C), C ** -0.5)), t(_uniform(rng, 2 * h, C ** -0.5)),
        t(_uniform(rng, (2 * h, 9), 1 / 3)), t(_uniform(rng, 2 * h, 1 / 3)),
        t(_uniform(rng, (C, h), h ** -0.5)), t(_uniform(rng, C, h ** -0.5)), H, W,
        t(lns), t(lnb), True))


def _serve_batch_cases(label, B, C, H, W, device, seed):
    """Rows 2 (the row pair, and the clamp-hitting column pair on the same
    stream), 4, 5 and 6 (plain and with the clamp probe) and 1 at the
    serving batch, bf16, each plain version on slices of PLAIN_SLICE
    images."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    s = lambda a: t(a).to(torch.bfloat16)  # noqa: E731
    x = rng.standard_normal((B, C, H * W), dtype=np.float32)
    xs_np = (x / (1.0 + np.exp(-x))).astype(np.float32)
    xs = s(xs_np)
    lns = 1.0 + 0.1 * rng.standard_normal(C)
    lnb = 0.1 * rng.standard_normal(C)
    cases = [Case("ss2d_seq_pair", label, torch.bfloat16, (xs, *_scan_weights(rng, C, t), "row")),
             Case("ss2d_seq_pair", label + " clamp", torch.bfloat16,
                  (xs, *_scan_weights(rng, C, t, clamp=True), "col")),
             _gdmlp_case(label, torch.bfloat16, rng, t, s(x), H, W, lns, lnb)]
    cases += _col_cases(label, torch.bfloat16, rng, t, xs_np, H, W, _scan_weights(rng, C, t),
                        False, device)
    cases += _col_cases(label, torch.bfloat16, rng, t, xs_np, H, W,
                        _scan_weights(rng, C, t, clamp=True), True, device)
    cases.append(_stem_case(label, torch.bfloat16, rng, t, s(x), H, W, lns, lnb))
    for c in cases:
        c.plain_slice = PLAIN_SLICE
    return cases


def _eval_cases(label, B, C, H, W, device, seed):
    """Rows 1-7 as _cases_for builds them, fp32, at an eval shape, each a
    path shape (its bound beside its time); above PLAIN_SLICE images the
    plain versions run on slices of PLAIN_SLICE. At an odd H (CG-L2, 7
    rows, one column chunk) no chunk ends on a row the column probe zeroes,
    so that shape has no probe (_col_cases)."""
    cases = _cases_for(label, B, C, H, W, torch.float32, device, seed, col_probe=H % 2 == 0)
    batched = {"linear_scan": (0, 1), "ss2d_tail_cf": (0, 1, 6)}  # beside the stream
    for c in cases:
        c.report = True
        if B > PLAIN_SLICE:
            c.plain_slice = PLAIN_SLICE
            c.batch_args = batched.get(c.name, c.batch_args)
    return cases


class _SharedNormals:
    """A seeded generator whose normal draws are float32 and kept: the k-th
    draw of a shape returns the same array each time the cases of another
    dtype ask for it again (``restart``), so a speed-test shape's
    2^22-position inputs are drawn once for both dtypes."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.kept, self.seen = {}, {}

    def restart(self):
        self.seen = {}
        return self

    def standard_normal(self, size=None):
        key = tuple(np.atleast_1d(size).tolist()) if size is not None else ()
        k = self.seen.get(key, 0)
        self.seen[key] = k + 1
        if (key, k) not in self.kept:
            self.kept[(key, k)] = self.rng.standard_normal(size, dtype=np.float32)
        return self.kept[(key, k)]

    def __getattr__(self, name):
        return getattr(self.rng, name)


def _speed_cases(label, B, C, H, W, dtype, device, draws):
    """Rows 1-7 as _cases_for builds them at a speed-test shape, each a path
    shape (its bound beside its time); the clamp cases in fp32 only; the
    inputs from ``draws`` (a _SharedNormals of the shape)."""
    f32 = dtype == torch.float32
    cases = _cases_for(label, B, C, H, W, dtype, device, None, col_probe=f32, clamp=f32,
                       rng=draws.restart())
    for c in cases:
        c.report = True
    return cases


def _serve_tail_case(label, B, C, H, W, device, seed):
    """The tail in its path form at the serving batch, bf16: merged (the
    column pair has added y_row, y_colT None), with the block's residual,
    no bout, on a mean-dominated scan output (+3); the plain version on
    slices of PLAIN_SLICE images."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    s = lambda a: t(a).to(torch.bfloat16)  # noqa: E731
    y = s(3.0 + 2.0 * rng.standard_normal((B, C, H * W), dtype=np.float32))
    res = s(rng.standard_normal((B, C, H * W), dtype=np.float32))
    return Case("ss2d_tail_cf", label + " merged res", torch.bfloat16,
                (y, None, t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
                 t(_uniform(rng, (C, C), C ** -0.5)), None, res),
                plain_slice=PLAIN_SLICE, batch_args=(0, 6))


def _scan_decays(rng, shape, lo=0.0, hi=3.0, zeros=0.0):
    """exp(-U(lo, hi)) decays (a chunk's product of clamped step decays),
    a ``zeros`` share of them exactly 0 (a state that restarts)."""
    a = np.exp(-rng.uniform(lo, hi, shape)).astype(np.float32)
    if zeros:
        a[rng.random(shape) < zeros] = 0.0
    return a


def _carry_cases(device, seed=760):
    """linear_scan at SERVE_SCAN_SHAPES, forward and reverse."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    out = []
    for label, M, L, D in SERVE_SCAN_SHAPES:
        a, b = t(_scan_decays(rng, (M, L, D))), t(rng.standard_normal((M, L, D), dtype=np.float32))
        out += [Case("linear_scan", label + (" rev" if rev else ""), torch.float32, (a, b, rev),
                     report=True) for rev in (False, True)]
    return out


def _cascade_cases(device, seed=810):
    """linear_scan at CASCADE_SHAPES and CASCADE_BATCHES, forward and
    reverse: decays exp(-dt) of the classifier's dt range, inputs of order 1."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    for label, H, C in CASCADE_SHAPES:
        for B in CASCADE_BATCHES:
            shape = (B * H, H, 2 * C)
            a = t(_scan_decays(rng, shape, 0.0, 0.2))
            b = t(rng.standard_normal(shape, dtype=np.float32))
            for rev in (False, True):
                yield Case("linear_scan", f"{label} B={B}" + (" rev" if rev else ""),
                           torch.float32, (a, b, rev), report=True)
            del a, b


def _train_carry_cases(device, seed=770, shapes=FLAGSHIP_TRAIN_SHAPES):
    """linear_scan at the row and column pairs' carries at ``shapes`` (the
    flagship training's, the speed test's), forward and reverse: the row
    pair's over (B, L / its chunk, C*N) and the column pair's over
    (B, W * H / its chunk, C*N), the chunks as the built kernels give them."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    out = []
    for label, B, C, H, W in shapes:
        R, N = math.ceil(C / 16), 1
        row = -(-H * W // _build.load().bem_ss2d_seq_chunk(C, R, N))
        col = W * -(-H // _seq.col_chunk(C, R, N, torch.float32))
        for L in sorted({row, col}):
            a = t(_scan_decays(rng, (B, L, C * N)))
            b = t(rng.standard_normal((B, L, C * N), dtype=np.float32))
            out += [Case("linear_scan", f"{label} carry L={L}" + (" rev" if rev else ""),
                         torch.float32, (a, b, rev), report=True) for rev in (False, True)]
    return out


def _serve_stem_case(label, B, C, H, W, device, seed):
    """The stem alone at the serving batch, bf16, the plain version on
    slices of PLAIN_SLICE images."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    x = t(rng.standard_normal((B, C, H * W), dtype=np.float32)).to(torch.bfloat16)
    case = _stem_case(label, torch.bfloat16, rng, t, x, H, W, 1.0 + 0.1 * rng.standard_normal(C),
                      0.1 * rng.standard_normal(C))
    case.plain_slice = PLAIN_SLICE
    return case


def edge_cases(device="cuda", seed=800):
    """Rows 1-7, 9 and 11 where their tiling has edges (rows 5 and 6 as
    _col_cases, row 9 as _fused_bwd_case, row 11 as _scan_fused_edge, row 7
    as _scan_edge_cases, row 3 as _tail_edge_cases, all below), fp32 and
    bf16: the stem at C = 24 (K padded to 32), Dh !=
    C, H and W no multiples of its tile, without the LN (one product) and at
    C = 288 (bf16 then runs the CUDA-core form), and the case only the LN
    output's bf16 lo halves carry (_lo_carried_stem); row 11 at N = 1 / 4 /
    16, L = 49, and several super-chunks with a ragged last one; the row
    pair (and the clamp-hitting column pair) at L a multiple of the chunk,
    not a multiple, shorter than one chunk, N = 1 / 2 / 4, C up to 160,
    and C = 288, where the kernel halves its chunk;
    the gdMlp at widths and image sizes that are no multiple of its tiles
    (C, Cout not multiples of 16, H, W not of the tile), Cout != C, C above
    the tensor-core form's 256 (bf16 then runs the CUDA-core form), and
    the case only the weights' bf16 lo halves carry (_lo_carried_gdmlp)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    out = []
    for B, C, L, N in ((2, 40, 1120, 1), (1, 40, 4, 1), (2, 24, 64, 2), (2, 24, 257, 4),
                       (1, 16, 763, 2), (2, 160, 700, 1), (1, 288, 300, 1)):
        for pair, clamp in (("row", False), ("col", True)):
            w = _scan_weights(rng, C, t, clamp=clamp)
            if N > 1:
                w[0] = t(_uniform(rng, (4, w[0].shape[1] + 2 * (N - 1), C), 0.3))
                w[3] = t(-np.exp(rng.standard_normal((4, C, N)) * 0.3))
            x = rng.standard_normal((B, C, L)).astype(np.float32)
            for dtype in (torch.float32, torch.bfloat16):
                out.append(Case("ss2d_seq_pair", f"B{B} C{C} L{L} N{N} {pair}", dtype,
                                (t(x / (1 + np.exp(-x))).to(dtype), *w, pair)))
    for B, C, H, W, Cout in ((2, 40, 13, 37, 40), (1, 24, 5, 70, 24), (2, 80, 9, 33, 80),
                             (1, 160, 6, 40, 160), (1, 48, 7, 20, 56), (1, 288, 5, 21, 288)):
        h = 4 * C
        x = rng.standard_normal((B, C, H * W))
        wts = (t(_uniform(rng, (2 * h, C), C ** -0.5)), t(_uniform(rng, 2 * h, 0.1)),
               t(_uniform(rng, (2 * h, 9), 1 / 3)), t(_uniform(rng, 2 * h, 0.3)),
               t(_uniform(rng, (Cout, h), h ** -0.5)), t(_uniform(rng, Cout, 0.1)), H, W,
               t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)), Cout == C)
        for dtype in (torch.float32, torch.bfloat16):
            out.append(Case("gdmlp_fused_cf", f"B{B} C{C} {H}x{W} Cout{Cout}", dtype,
                            (t(x).to(dtype), *wts)))
    out.append(Case("gdmlp_fused_cf", "lo-carried C32 9x20", torch.bfloat16,
                    _lo_carried_gdmlp(rng, t)))
    out.append(Case("gdmlp_fused_cf", "lo-carried fp32 C32 9x20", torch.float32,
                    lo_carried_gdmlp_f32(rng, t)))
    # the fp32 form's hidden split at the eval CG's B = 1 levels, h no
    # multiple of the 16-channel chunk (168, 312), Cout != C without the
    # residual (W2 scaled so that the output is of order 1)
    for C, H, W, Cout in ((42, 7, 10, 42), (78, 14, 20, 56)):
        h = 4 * C
        out.append(Case("gdmlp_fused_cf", f"split B1 C{C} {H}x{W} Cout{Cout}", torch.float32, (
            t(rng.standard_normal((1, C, H * W))), t(_uniform(rng, (2 * h, C), C ** -0.5)),
            t(_uniform(rng, 2 * h, 0.1)), t(_uniform(rng, (2 * h, 9), 1 / 3)),
            t(_uniform(rng, 2 * h, 0.3)), t(_uniform(rng, (Cout, h), 8 * h ** -0.5)),
            t(_uniform(rng, Cout, 0.1)), H, W, t(1 + 0.1 * rng.standard_normal(C)),
            t(0.1 * rng.standard_normal(C)), Cout == C)))
    # the column pair (rows 5 and 6): H a multiple of the chunk, not a
    # multiple, shorter than it; W no multiple of 16 or 32; N = 1 / 2 / 4;
    # C = 160 and 288, where the chunk halves (to 8 / 4 and 2 / 1 rows)
    for B, C, H, W, N in ((2, 40, 64, 50, 1), (1, 40, 37, 21, 2), (2, 24, 7, 33, 4),
                          (1, 160, 21, 40, 1), (1, 288, 10, 19, 1)):
        w = _scan_weights(rng, C, t, clamp=True)
        if N > 1:
            w[0] = t(_uniform(rng, (4, w[0].shape[1] + 2 * (N - 1), C), 0.3))
            w[3] = t(-np.exp(rng.standard_normal((4, C, N)) * 0.3))
        x = rng.standard_normal((B, C, H * W)).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            out += _col_cases(f"B{B} C{C} {H}x{W} N{N}", dtype, rng, t, x / (1 + np.exp(-x)),
                              H, W, w, False, device)
    # row 9: L a multiple of its 32-position chunk, not a multiple, shorter
    # than it; N = 1 / 4 / 16; C = 288 (nine channel blocks of 32 at N = 16)
    for i, (B, C, L, R, N) in enumerate(((2, 40, 64, 3, 16), (1, 70, 70, 3, 1), (2, 24, 20, 2, 4),
                                         (1, 288, 33, 18, 16))):
        out.append(_fused_bwd_case(f"B{B} C{C} L{L} N{N}", B, C, L, R, N, device, seed + i))
    # the stem (row 1): (B, C, Dh, H, W, with the LN, with biases)
    for B, C, Dh, H, W, ln, bias in ((2, 24, 24, 13, 37, True, True), (1, 40, 80, 9, 33, True, False),
                                     (2, 40, 40, 7, 45, False, True), (1, 160, 160, 7, 40, True, True),
                                     (1, 288, 288, 5, 21, True, True)):
        x = rng.standard_normal((B, C, H * W))
        wts = (t(_uniform(rng, (Dh, C), C ** -0.5)), t(_uniform(rng, Dh, 0.1)) if bias else None,
               t(_uniform(rng, (Dh, 9), 1 / 3)), t(_uniform(rng, Dh, 0.3)) if bias else None, H, W,
               t(1 + 0.1 * rng.standard_normal(C)) if ln else None,
               t(0.1 * rng.standard_normal(C)) if ln else None)
        for dtype in (torch.float32, torch.bfloat16):
            out.append(Case("stem_fused_cf", f"B{B} C{C} Dh{Dh} {H}x{W} ln{int(ln)}", dtype,
                            (t(x).to(dtype), *wts)))
    out.append(Case("stem_fused_cf", "lo-carried C32 9x20", torch.bfloat16,
                    _lo_carried_stem(rng, t)))
    out.append(Case("stem_fused_cf", "lo-carried fp32 C32 9x20", torch.float32,
                    lo_carried_stem_f32(rng, t)))
    # the fp32 form's hidden chunks dealt over blocks at the eval CG's B = 1
    # levels, Dh no multiple of 16
    for C, Dh, H, W in ((42, 90, 7, 10), (78, 78, 14, 20)):
        out.append(Case("stem_fused_cf", f"split B1 C{C} Dh{Dh} {H}x{W}", torch.float32, (
            t(rng.standard_normal((1, C, H * W))), t(_uniform(rng, (Dh, C), C ** -0.5)),
            t(_uniform(rng, Dh, 0.1)), t(_uniform(rng, (Dh, 9), 1 / 3)), t(_uniform(rng, Dh, 0.3)),
            H, W, t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)))))
    # row 11: one super-chunk of two chunks at L = 49; several super-chunks,
    # the last ragged (B=2: M = 8 sequences), at N = 1 / 4 / 16
    for i, (B, C, L, N) in enumerate(((2, 40, 49, 4), (1, 24, 49, 16), (2, 70, 300, 1),
                                      (2, 24, 1000, 16), (2, 40, 777, 4))):
        out += _scan_fused_edge(f"B{B} C{C} L{L} N{N}", B, C, L, N, device, seed + 10 + i)
    out += _scan_edge_cases(rng, t)
    out += _tail_edge_cases(rng, t)
    return out


def _scan_edge_cases(rng, t):
    """linear_scan (row 7) where its plan changes form: L = 1; the walk's
    limit (WALK_L, WALK_L + 1); one look-back chunk at D = 40 (96
    positions) and one position either side; 40 chunks at D = 40 (anchors:
    a second group); a long L (2^20) at D = 1 (256 chunks of 4096, 8
    groups); D = 3072 over 12 channel tiles of one-thread segments (the
    fused core's width, M below the walk's fill), D = 100 (P = 2), and M * D
    at the walk's fill; the cascade SS2D's walks of few short sequences
    (VMamba-T's 7x7 stage for one image, L = 7 at D = 3072; stage 0's row
    for one image, L = 56 at D = 384; D = 770, off the warp width); decays
    in (0.9, 1) with 1 % exact zeros, forward and reverse."""
    out = []
    W = _scan.WALK_L
    for M, L, D in ((3, 1, 40), (2, W, 40), (2, W + 1, 40), (2, 95, 40), (2, 96, 40),
                    (2, 97, 40), (3, 3841, 40), (2, 1 << 20, 1), (2, 300, 3072), (1, 777, 100),
                    (_scan.WALK_FILL // 64, 100, 64), (7, 7, 3072), (1, 56, 384), (3, 28, 770)):
        a = t(_scan_decays(rng, (M, L, D), 0.0, -np.log(0.9), zeros=0.01))
        b = t(rng.standard_normal((M, L, D), dtype=np.float32))
        out += [Case("linear_scan", f"M{M} L{L} D{D}" + (" rev" if rev else ""), torch.float32,
                     (a, b, rev)) for rev in (False, True)]
    return out


def _tail_edge_cases(rng, t):
    """The tail (row 3) at its tiles' edges, fp32 and bf16 (the tensor-core
    form): C = 40 (K padded to 48), C_out != C either way, L = 1, a tile
    + 1 (L = 33 and 65; 2 x 4225 positions take 64-position tiles, the
    smaller shapes 32), L off the 16-byte vector width (the scalar path),
    C = 160 (512-thread blocks), merged and unmerged, with and without
    bout and the residual, on mean-dominated inputs (+3); and, bf16 alone
    (the CUDA-core form's fp32 Wout does not fit at C = 256), C = 256
    unmerged, where one stage is all that fits."""
    out = []
    both = (torch.float32, torch.bfloat16)
    for B, C, Cout, L, merged, bias, resid, dtypes in (
            (2, 40, 40, 1, False, True, True, both), (1, 40, 56, 33, True, False, True, both),
            (2, 80, 40, 65, False, True, False, both), (2, 40, 40, 4225, True, True, True, both),
            (2, 40, 24, 64 * 70, False, False, True, both),
            (1, 160, 160, 1000, True, False, True, both), (2, 24, 24, 203, True, True, True, both),
            (1, 48, 24, 296, False, False, False, both),
            (1, 256, 256, 100, False, True, True, (torch.bfloat16,))):
        y = 3.0 + 2.0 * rng.standard_normal((B, C, L))
        yc = None if merged else rng.standard_normal((B, C, L))
        r = rng.standard_normal((B, Cout, L)) if resid else None
        w = (t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
             t(_uniform(rng, (C, Cout), C ** -0.5)), t(_uniform(rng, Cout, 0.3)) if bias else None)
        for dtype in dtypes:
            s = lambda a: None if a is None else t(a).to(dtype)  # noqa: E731
            out.append(Case("ss2d_tail_cf", f"B{B} C{C} Cout{Cout} L{L} m{int(merged)} "
                            f"b{int(bias)} r{int(resid)}", dtype,
                            (s(y), s(yc), w[0], w[1], w[2], w[3], s(r))))
    return out


def _lo_carried_gdmlp(rng, t, B=1, C=32, H=9, W=20):
    """gdMlp arguments (bf16, no LN, biases or residual) whose output only
    the bf16 lo halves of W1 and W2 carry: x's channels c and c + C/2 are
    equal, every W1 row is 1 + 2^-10 on the first C/2 channels and -1 on
    the rest, so W1 . x = 2^-10 (sum of the first half); every hidden
    channel is then equal, and every W2 row is 1 + 2^-10 on the first h/2
    and -1 on the rest, so the output is 2^-10 (h/2) gate. bf16(1 + 2^-10)
    is 1: with the hi halves alone both products, and the output, are 0.
    x is scaled by 2^11 so that the output is of order 1 and more: compare
    holds it to TOL times max(1, its largest entry), which a 0 then misses."""
    h = 4 * C
    half = 2.0 ** 11 * rng.standard_normal((B, C // 2, H * W)).astype(np.float32)
    x = t(np.concatenate([half, half], 1)).to(torch.bfloat16)
    row = lambda n: np.repeat(np.float32([1 + 2.0 ** -10, -1]), n // 2)  # noqa: E731
    return (x, t(np.tile(row(C), (2 * h, 1))), None, t(np.tile(_uniform(rng, 9, 1 / 3), (2 * h, 1))),
            None, t(np.tile(row(h), (C, 1))), None, H, W, None, None, False)


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


def _cls_stream(rng, B, C, H, W, device):
    """xs2 (numpy (B, 2, C, H*W)): the (row, column) sequences of a SiLU
    output, with the clamp probe; and the probe's mask on ``device``."""
    x = rng.standard_normal((B, C, H, W)).astype(np.float32)
    x = x / (1.0 + np.exp(-x))
    xs2 = np.stack([x.reshape(B, C, H * W), x.transpose(0, 1, 3, 2).reshape(B, C, H * W)], 1)
    return xs2, torch.from_numpy(_clamp_probe(xs2)).to(device)


def _cls_cases(label, B, C, H, W, R, N, device, seed):
    """The fused core, its clamped form (fp32, bf16) and its backward (fp32)
    at one stage, on _cls_stream's inputs."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    xs2, probe = _cls_stream(rng, B, C, H, W, device)
    w = _fused_weights(rng, C, R, N, t)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        xs = t(xs2).to(dtype)
        out += [Case("ss2d_dir_fused", label, dtype, (xs, *w), probe),
                Case("ss2d_dir_fused_g", label, dtype, (xs, *w), probe)]
    g = t(rng.standard_normal(xs2.shape))
    out.append(Case("ss2d_dir_fused_bwd", label, torch.float32, (t(xs2), *w, g), probe))
    return out


def _cls_batch_cases(label, B, C, H, W, R, N, device, seed):
    """The fused core and its clamped form at the classifier's batch
    (CLS_TRAIN_BATCH), bf16, on _cls_stream's inputs, the plain versions on
    slices of PLAIN_SLICE images."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    B = CLS_TRAIN_BATCH
    xs2, probe = _cls_stream(rng, B, C, H, W, device)
    xs = t(xs2).to(torch.bfloat16)
    w = _fused_weights(rng, C, R, N, t)
    return [Case(name, f"{label} B={B}", torch.bfloat16, (xs, *w), probe,
                 plain_slice=PLAIN_SLICE) for name in ("ss2d_dir_fused", "ss2d_dir_fused_g")]


def _fused_bwd_case(label, B, C, L, R, N, device, seed, plain_slice=0):
    """Row 9 alone on (B, 2, C, L) sequences of a SiLU output with the clamp
    probe, fp32, the plain version on slices of ``plain_slice`` images
    (its weight gradients added over the slices)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    x = rng.standard_normal((B, 2, C, L)).astype(np.float32)
    xs2 = x / (1.0 + np.exp(-x))
    probe = torch.from_numpy(_clamp_probe(xs2)).to(device)
    w = _fused_weights(rng, C, R, N, t)
    g = t(rng.standard_normal(xs2.shape))
    return Case("ss2d_dir_fused_bwd", label, torch.float32, (t(xs2), *w, g), probe,
                plain_slice=plain_slice, batch_args=(0, 6), sum_rest=True)


def _scan_fused_inputs(B, C, H, W, R, N, scans, device, seed):
    """selective_scan_fused's fp32 inputs as the v051d / v052d SS2D makes
    them: the cross-scan (``scans`` 1 or 2) of a SiLU output, x zero at
    every other position of every third channel (the clamp probe: there
    y is the decay of the neighbours' states alone), delta and B / C
    projected from it at the v0 init's scales, the dt bias +12 on those
    channels so dt*A < -10; returns (args, probe)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    x = rng.standard_normal((B, C, H, W)).astype(np.float32)
    u = cross_scan_cf_input(t(x / (1.0 + np.exp(-x))), scans).contiguous()
    probe = torch.zeros(u.shape, dtype=torch.bool, device=device)
    probe[:, :, ::3, 1::2] = True
    u[probe] = 0.0
    Wx, Wdt, bias, A, D = _fused_weights(rng, C, R, N, t)
    xdbl = torch.einsum("bkcl,krc->bkrl", u, Wx)
    delta = torch.einsum("bkrl,kdr->bkdl", xdbl[:, :, :R], Wdt).contiguous()
    args = (u, delta, A.reshape(4 * C, N), xdbl[:, :, R:R + N].contiguous(),
            xdbl[:, :, R + N:].contiguous(), D.reshape(-1), bias.reshape(-1))
    return args, probe


def _scan_fused_cases(label, B, C, H, W, R, N, device, seed):
    """selective_scan_fused at one stage, for scans 1 and 2, fp32 and bf16
    (u, delta, B, C rounded to bf16), with the clamp probe."""
    out = []
    for scans in (1, 2):
        args, probe = _scan_fused_inputs(B, C, H, W, R, N, scans, device, seed + scans)
        for dtype in (torch.float32, torch.bfloat16):
            a = tuple(x.to(dtype) if i in (0, 1, 3, 4) else x for i, x in enumerate(args))
            out.append(Case("selective_scan_fused", f"{label} scans{scans}", dtype, a, probe))
    return out


def _scan_fused_batch_case(label, B, C, H, W, R, N, device, seed):
    """selective_scan_fused at the classifier's batch (CLS_TRAIN_BATCH,
    v052d's throughput batch), scans 2, bf16, with the clamp probe, the
    plain version on slices of PLAIN_SLICE images."""
    B = CLS_TRAIN_BATCH
    args, probe = _scan_fused_inputs(B, C, H, W, R, N, 2, device, seed)
    a = tuple(x.to(torch.bfloat16) if i in (0, 1, 3, 4) else x for i, x in enumerate(args))
    return Case("selective_scan_fused", f"{label} scans2 B={B}", torch.bfloat16, a, probe,
                plain_slice=PLAIN_SLICE, batch_args=(0, 1, 3, 4))


def _scan_fused_edge(label, B, C, L, N, device, seed):
    """selective_scan_fused on (B, 4, C, L) inputs of its own, fp32 and bf16:
    u a SiLU output with the clamp probe (zero at every other position of
    every third channel), delta around 0, the dt bias +12 on the probed
    channels (dt*A < -10 there), A = -exp(U(0, log(N + 1))), B, C, D
    standard normal."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    K = 4
    x = rng.standard_normal((B, K, C, L)).astype(np.float32)
    u = x / (1.0 + np.exp(-x))
    probe = np.zeros(u.shape, bool)
    probe[:, :, ::3, 1::2] = True
    u[probe] = 0.0
    bias = _dt_bias(rng, (K, C))
    bias[:, ::3] = 12.0
    args = (u, 0.5 * rng.standard_normal((B, K, C, L)),
            -np.exp(rng.uniform(0.0, np.log(N + 1), (K * C, N))),
            rng.standard_normal((B, K, N, L)), rng.standard_normal((B, K, N, L)),
            rng.standard_normal(K * C), bias.reshape(-1))
    pm = torch.from_numpy(probe).to(device)
    return [Case("selective_scan_fused", label, dtype,
                 tuple(t(a).to(dtype) if i in (0, 1, 3, 4) else t(a) for i, a in enumerate(args)),
                 pm) for dtype in (torch.float32, torch.bfloat16)]


def _lo_carried_stem(rng, t, B=1, C=32, H=9, W=20):
    """Stem arguments (bf16, the LN folded in, no biases) whose output only
    the bf16 lo halves of the LN output carry: the LN's scale is 2^-11 and
    its shift 1, so every LN output is 1 + 2^-11 x_hat, whose bf16 hi is 1
    (|x_hat| < sqrt(C) < 8); every W1 row is +1 on the first C/2 channels and
    -1 on the rest, so W1 . hi = 0 and W1 . y = 2^-10 (sum of x_hat over
    the first half), every hidden channel the same. The taps are scaled by
    2^10 so that the output is of order 1 and more: compare holds it to TOL
    times max(1, its largest entry), which the hi halves alone (an output
    of SiLU(0) = 0) then miss."""
    x = t(rng.standard_normal((B, C, H * W))).to(torch.bfloat16)
    row = np.repeat(np.float32([1, -1]), C // 2)
    return (x, t(np.tile(row, (C, 1))), None, t(np.tile(2.0 ** 10 * _uniform(rng, 9, 1 / 3), (C, 1))),
            None, H, W, t(np.full(C, 2.0 ** -11)), t(np.ones(C)))


def _lo_carried_x(rng, t, B, C, H, W, d):
    """An fp32 stream whose split into hi + lo is exact and known: x = X + d
    on the first C/2 channels and X on the rest, X = +-1 (channels c and
    c + C/2 equal), d under half an ulp of 1 in the split's format (hi = X,
    lo = d or 0)."""
    X = rng.choice(np.float32([-1, 1]), (B, C // 2, H * W))
    return t(np.concatenate([X + np.float32(d), X], 1))


def _lo_carried_w1_row(C, lo):
    """A W1 row whose split is exact and known, against _lo_carried_x: hi =
    +1 on the first C/2 channels, -1 on the rest but -0.9375 on channel
    C/2; lo = 0 on the first half, ``lo`` on the rest. With x's halves
    equal the hi.hi sum is 0.0625 X_{C/2}, lo.hi ``lo`` (sum of X's second
    half), hi.lo (C/2) d, lo.lo exactly 0: fp32 sums all of it exactly."""
    row = np.concatenate([np.ones(C // 2), np.full(C // 2, -1 + lo)])
    row[C // 2] = -0.9375 + lo
    return row.astype(np.float32)


def lo_carried_stem_f32(rng, t, B=1, C=32, H=9, W=20):
    """Stem arguments (fp32, no LN, no biases) where each of the kernel's
    three tf32 products (3xTF32) carries a share of the projection (the
    weight's small halves some 0.4 %, the activation's 3 %, varying by
    pixel): x from _lo_carried_x with d = 2^-13 and every W1 row
    _lo_carried_w1_row with lo = 2^-14 (tf32 keeps 10 fraction bits), so
    the kernel's products and the plain version's fp32 sums are exact; the
    taps scaled by 2^7 so that the output is of order 1 and more. Dropping
    any one product moves the output past TOL times max(1, its largest
    entry); the dropped small.small is 0 here."""
    x = _lo_carried_x(rng, t, B, C, H, W, 2.0 ** -13)
    return (x, t(np.tile(_lo_carried_w1_row(C, 2.0 ** -14), (C, 1))), None,
            t(np.tile(2.0 ** 7 * _uniform(rng, 9, 1 / 3), (C, 1))), None, H, W, None, None)


def lo_carried_gdmlp_f32(rng, t, B=1, C=32, H=9, W=20):
    """gdMlp arguments (fp32, no LN, no b1 / b2, no residual) where each of
    the three bf16 products of both projections carries a share of the
    output above TOL: x from _lo_carried_x with d = 2^-9 and the gate rows
    of W1 _lo_carried_w1_row with lo = 2^-10 (bf16 keeps 7 fraction bits;
    the W1 product exact, each of its products some % of it, every
    gate channel's hidden value u the same), the value rows 0 and bdw 1
    on them (v = 1), taps scaled by 2^4 and bdw 8 on the gate channels
    (a = 8 + dw3x3(u), the gate ~ a), and every W2 entry 2^-7 (1 + 3 *
    2^-10): hi 2^-7, lo 3 * 2^-17, so the output is ~ the gate (order 1
    and more), lo.hi carries 2.9e-3 of it and hi.lo the gate's lo (up to
    2^-8 of it), 10x and more TOL's 2e-4, while the dropped lo.lo is under
    2^-8 * 2.9e-3 of it."""
    h = 4 * C
    x = _lo_carried_x(rng, t, B, C, H, W, 2.0 ** -9)
    W1 = np.zeros((2 * h, C), np.float32)
    W1[:h] = _lo_carried_w1_row(C, 2.0 ** -10)
    dw = np.tile(2.0 ** 4 * _uniform(rng, 9, 1 / 3), (2 * h, 1))
    bdw = np.concatenate([np.full(h, 8.0), np.ones(h)])
    W2 = np.full((C, h), 2.0 ** -7 * (1 + 3 * 2.0 ** -10), np.float32)
    return (x, t(W1), None, t(dw), t(bdw), t(W2), None, H, W, None, None, False)


def _microbench_cases(small, device):
    """The microbenchmarks on the tool's data at every lanes / npass / mode
    of its sweeps, or on 2 blocks of (40, 512) (``small``)."""
    if small:
        x = torch.from_numpy(np.random.default_rng(0).random((2, 40, 512), np.float32))
        data = lambda lanes: x.to(device)  # noqa: E731
        runs, modes_lanes = [(512, 10), (512, 40)], 512
    else:  # a draw of its own, freed with the cases (the tool's data() keeps one)
        flat = _mb.draw(device)
        data = lambda lanes: flat.view(_mb.TOTAL // lanes, _mb.C, lanes)  # noqa: E731
        runs = [(lanes, _mb.NPASS) for lanes in _mb.LANES_SWEEP]
        runs += [(4096, npass) for npass in _mb.NPASS_SWEEP]
        modes_lanes = 4096
    out = [Case("vpu_scan_step", f"lanes {lanes} npass {npass}", torch.float32,
                (data(lanes), npass)) for lanes, npass in runs]
    return out + [Case("vpu_op_rounds", f"mode {mode}", torch.float32,
                       (data(modes_lanes), mode)) for mode in _mb.MODES]


def kernel_cases(small: bool = False, device="cuda"):
    """Every kernel at every serving, training and classifier shape, fp32 and
    bf16, rows 1-6 at the serving batch (bf16; row 3 in its path form),
    rows 1-7 at the eval CLI's and the flagship's eval and training
    shapes (fp32) and at the speed test's 2048x2048 levels (fp32 and bf16),
    linear_scan at the serving, eval, flagship and speed-test carries, at
    the flagship training's backward recompute shape and at the cascade
    SS2D's shapes (CASCADE_SHAPES), and the microbenchmarks
    at the tool's shapes; or at tiny shapes (``small``). Yields them a shape
    at a time, so the card holds one shape's inputs at once."""
    shapes = SMALL_SHAPES if small else PATH_SHAPES + TRAIN_SHAPES
    for i, (label, B, C, H, W) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            yield from _cases_for(label, B, C, H, W, dtype, device, seed=i)
        if label.startswith("train IE") or small:
            yield from _scan_bwd_cases(label, B, C, H, W, device, seed=100 + i)
    if not small:
        for i, shape in enumerate(SERVE_SHAPES):
            yield from _serve_batch_cases(*shape, device, seed=700 + i)
        for i, shape in enumerate(SERVE_STEM_SHAPES):
            yield _serve_stem_case(*shape, device, seed=720 + i)
        for i, shape in enumerate(SERVE_SHAPES + SERVE_STEM_SHAPES):
            yield _serve_tail_case(*shape, device, seed=740 + i)
        for i, shape in enumerate(EVAL_SHAPES + FLAGSHIP_SHAPES + FLAGSHIP_TRAIN_SHAPES):
            yield from _eval_cases(*shape, device, seed=780 + i)
        for i, shape in enumerate(FLAGSHIP_TRAIN_SHAPES):
            yield from _scan_bwd_cases(*shape, device, seed=120 + i)
        for i, shape in enumerate(SPEED_SHAPES):
            draws = _SharedNormals(880 + i)
            for dtype in (torch.float32, torch.bfloat16):
                yield from _speed_cases(*shape, dtype, device, draws)
            del draws
        yield from _carry_cases(device)
        yield from _train_carry_cases(device)
        yield from _train_carry_cases(device, 790, SPEED_SHAPES[:1])
        yield from _cascade_cases(device)
    for i, shape in enumerate(SMALL_CLS_SHAPES if small else CLS_SHAPES):
        yield from _cls_cases(*shape, device, seed=300 + i)
        yield from _scan_fused_cases(*shape, device, seed=500 + 4 * i)
        if i == 0 and not small:  # row 9 at the training batch
            label, _, C, H, W, R, N = shape
            yield _fused_bwd_case(f"{label} B={CLS_TRAIN_BATCH}", CLS_TRAIN_BATCH, C,
                                  H * W, R, N, device, 350, PLAIN_SLICE)
        if i in CLS_BATCH_STAGES and not small:
            yield from _cls_batch_cases(*shape, device, seed=360 + i)
            yield _scan_fused_batch_case(*shape, device, seed=560 + i)
    yield from _microbench_cases(small, device)


def _outputs(o):
    return o if isinstance(o, tuple) else (o,)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize()


def row_scaled(out, ref, rel, probe=None, axis=-1):
    """(error, tolerance) at the element of ``out`` worst against ``ref``,
    each element's tolerance ``rel`` times the largest |ref| of its row
    (along ``axis``) -- with ``probe`` (a bool mask), the largest over the
    probe's or the other elements of that row, whichever it belongs to."""
    if axis != -1:
        out, ref = out.movedim(axis, -1), ref.movedim(axis, -1)
        probe = None if probe is None else probe.movedim(axis, -1)
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
    """(max abs error of the kernel vs its plain version, the tolerance). The
    fused forward, and the column pair on its clamp probe, must also fail
    the same check against the plain version with the other clamp setting
    (its err / tol lands in ``case.other_clamp``), or the check could not
    see the clamp."""
    outs = _outputs(case.fn(*case.args))
    refs = _outputs(case.plain(*case.args))
    _sync(outs[0])
    if case.name in BIT_EXACT:
        again = _outputs(case.fn(*case.args))
        case.repeatable = all(torch.equal(a, b) for a, b in zip(outs, again, strict=True))
        if not case.repeatable:
            raise AssertionError(f"{case.name} {case.label}: two launches differ")
    err, scale = 0.0, 1.0
    worst = None  # PER_OUTPUT: (err / tol, err, tol) of the worst output
    for j, (out, ref) in enumerate(zip(outs, refs, strict=True)):
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"{case.name}: {out.shape}/{out.dtype} vs "
                                 f"{ref.shape}/{ref.dtype}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{case.name} {case.label}: non-finite kernel output")
        if (case.name in PER_ROW and j == 0) or (case.probe is not None and j == case.probe_out):
            e, tol = row_scaled(out, ref, TOL[case.dtype],
                                case.probe if j == case.probe_out else None, case.row_axis)
        else:
            e = (out.float() - ref.float()).abs().max().item()
            m = ref.float().abs().max().item()
            err, scale = max(err, e), max(scale, m)
            tol = TOL[case.dtype] * max(m, 1e-12)
        if worst is None or e / tol > worst[0]:
            worst = (e / tol, e, tol)
    other = None
    if case.name == "selective_scan_fused":  # a function without the clamp
        other = case.plain_with(clamp=True)(*case.args)
    elif case.name in ("ss2d_dir_fused", "ss2d_dir_fused_g"):
        other = case.plain_with(_fused.ss2d_dir_fused_plain,
                                clamp=case.name == "ss2d_dir_fused")(*case.args)
    elif case.probe is not None and case.name in COL_KERNELS:  # against the unclamped plain
        other = _outputs(case.plain_with(clamp=False)(*case.args))[case.probe_out]
    if other is not None:
        e, tol = row_scaled(outs[case.probe_out], other, TOL[case.dtype], case.probe,
                            case.row_axis)
        case.other_clamp = e / tol
        if e <= tol:
            raise AssertionError(f"{case.name} {case.label}: the check cannot tell the "
                                 f"clamped function from the unclamped ({e} <= {tol})")
    if case.name in PER_OUTPUT or case.name in PER_ROW or case.probe is not None:
        return worst[1], worst[2]
    return err, TOL[case.dtype] * scale


@dataclass
class CkptCase:
    """The fused forward's checkpoints (the state entering every CKPT-long
    chunk of each direction) on clamp-probe inputs, forward ``clamp``ed or
    not."""
    label: str
    dtype: torch.dtype
    args: tuple
    clamp: bool


def checkpoint_cases(small: bool = False, device="cuda"):
    """The checkpoints at the VMamba-T stage shapes (batch 2; ``small``:
    tiny ones), fp32 and bf16 streams, unclamped (what the backward reads)
    and clamped, on _cls_cases's clamp-probe inputs."""
    out = []
    for i, (label, B, C, H, W, R, N) in enumerate(SMALL_CLS_SHAPES if small else CLS_SHAPES):
        rng = np.random.default_rng(320 + i)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
        x = rng.standard_normal((B, 2, C, H * W)).astype(np.float32)
        xs2 = x / (1.0 + np.exp(-x))
        _clamp_probe(xs2)
        w = _fused_weights(rng, C, R, N, t)
        out += [CkptCase(label, dtype, (t(xs2).to(dtype), *w), clamp)
                for dtype in (torch.float32, torch.bfloat16) for clamp in (False, True)]
    return out


@torch.inference_mode()
def compare_checkpoints(case: CkptCase):
    """(max abs error, tolerance, err / tol against the other clamp
    setting) of the forward kernel's checkpoints against
    ``fused_checkpoints_plain``: each (image, stream, direction, channel)
    row over its chunks and states against its own largest entry (a row
    of one state can hold a single sum that cancelled to far below its
    channel's scale), at the fp32 tolerance (the states are fp32). Raises
    unless the check also fails against the other clamp setting."""
    _, ck = _fused._fwd_run(*case.args, clamp=case.clamp, with_ckpt=True)
    if ck is None:
        raise ValueError("compare_checkpoints: the kernel writes checkpoints on the card only")
    if not torch.isfinite(ck).all():
        raise AssertionError(f"checkpoints {case.label}: non-finite states")
    rows = lambda t: t.permute(0, 1, 2, 4, 3, 5).flatten(4)  # noqa: E731  (B, 2, 2, C, nck*N)
    ref = _fused.fused_checkpoints_plain(*case.args, clamp=case.clamp)
    err, tol = row_scaled(rows(ck), rows(ref), TOL[torch.float32])
    other = _fused.fused_checkpoints_plain(*case.args, clamp=not case.clamp)
    e, t = row_scaled(rows(ck), rows(other), TOL[torch.float32])
    if e <= t:
        raise AssertionError(f"checkpoints {case.label}: the check cannot tell the clamped "
                             f"function from the unclamped ({e} <= {t})")
    return err, tol, e / t


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
BF16_TC_FLOPS = 989e12   # tensor cores, dense bf16 (fp32-accurate products: a third)


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
    if case.name == "selective_scan_fused":
        # per element: bias add and softplus (6), dt*u (1), D*u + y (2); per
        # state: dt*A, exp, du*B (3), the step's FMA and the readout's (4)
        N = a[2].shape[-1]
        return io, 0, a[0].numel() * (9 + 7 * N)
    if case.name == "vpu_scan_step":
        # per round and segment: an FMA (2) and a multiply on each of the
        # 32 - sh lanes the roll reaches (the masked lanes keep a and b);
        # b = x / 2 and the final a + b on every element
        lanes = sum(32 - (1 << (r % 5)) for r in range(a[1]))
        return io, 0, a[0].numel() // 32 * 3 * lanes + 2 * a[0].numel()
    if case.name == "vpu_op_rounds":  # per round: arith FMA + mul; exp mul, exp,
        # FMA; softplus mul, max / abs / exp / log1p / add, FMA; roll FMA
        per = {"arith": 3, "exp": 4, "softplus": 8, "roll": 2}[a[1]]
        return io, 0, a[0].numel() * (10 * per + 2)
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
    # ss2d_col_dir: both directions' full walks
    return io, 2 * 2 * B * L * P * C, 2 * _scan_dir_ops(B, C, L, R, N, True)


def bound_ms(case: Case):
    """(least ms on an H100 SXM, "bytes" or "operations"): the larger of
    bytes over the HBM rate and operations over the peak rate of their
    type (elementwise work at the fp32 rate). Matmul work runs on the bf16
    tensor cores: at their peak on the bf16 stream, at a third of it on the
    fp32 stream, where near-fp32 accuracy takes at least three bf16
    products (hi.hi, lo.hi and hi.lo of operands split into bf16 hi + lo,
    the gdMlp's fp32 form; the stem's 3xTF32 takes twice that time, and
    the fp32 CUDA cores, 67 TFLOP/s, longer still)."""
    nbytes, mm, ew = work(case)
    mm_rate = BF16_TC_FLOPS if case.dtype == torch.bfloat16 else BF16_TC_FLOPS / 3
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


def _scan_fused_grad_cases(device):
    """selective_scan_fused's autograd wrapper (kernel forward, the backward
    through the unfolded composition on linear_scan) vs autograd through
    the plain composition, all seven inputs, at the tiny classifier shapes
    for scans 1 and 2 (the full stages' composition is too large to hold
    twice for a check)."""
    out = []
    for i, (label, B, C, H, W, R, N) in enumerate(SMALL_CLS_SHAPES):
        for scans in (1, 2):
            args, _ = _scan_fused_inputs(B, C, H, W, R, N, scans, device, 600 + 4 * i + scans)
            out.append(GradCase("selective_scan_fused", f"{label} scans{scans}",
                                _sf.selective_scan_fused, _sf.selective_scan_fused_plain,
                                list(args), tuple(args[0].shape)))
    return out


def _cascade_grad_cases(small, device):
    """linear_scan's autograd (the backward's reverse-direction kernel) at the
    cascade's stage-0 row scan for two images, (112, 56, 384), forward and
    reverse."""
    rng = np.random.default_rng(420)
    label, H, C = CASCADE_SHAPES[-1] if small else CASCADE_SHAPES[0]
    shape = (H if small else 2 * H, H, 2 * C)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    a, b = t(_scan_decays(rng, shape, 0.0, 0.2)), t(rng.standard_normal(shape))
    return [GradCase("linear_scan", f"{label} B={shape[0] // H}" + (" rev" if rev else ""),
                     lambda a, b, rev=rev: _scan.linear_scan(a, b, rev),
                     lambda a, b, rev=rev: _scan.linear_scan_plain(a, b, rev), [a, b], shape)
            for rev in (False, True)]


def grad_cases(small: bool = False, device="cuda"):
    """The five autograd wrappers of the VSSBlock and linear_scan at the
    LOLv1 and flagship training shapes (``small``: tiny shapes), fp32,
    clamp-hitting scan biases; then the classifier's fused core at its
    stage shapes, selective_scan_fused at tiny ones and linear_scan at the
    cascade SS2D's stage-0 shape for two images (tiny: one image of 7x7)."""
    out = (_cls_grad_cases(small, device) + _scan_fused_grad_cases(device)
           + _cascade_grad_cases(small, device))
    shapes = SMALL_SHAPES if small else TRAIN_SHAPES + FLAGSHIP_TRAIN_SHAPES
    for i, (label, B, C, H, W) in enumerate(shapes):
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


def write_clip_bundle(path, seed: int = 0, width: int = 768, layers: int = 12, patch: int = 32,
                      image_size: int = 224, proj_dim: int = 512, mlp_dim: int = 0):
    """Write a CLIP-IQA bundle in bem_tpu's ``BEM_CLIP_NPZ`` layout with
    seeded weights of a tower's shapes (ViT-B/32's by default: 87.8 M
    parameters, 351 MB): kernels and biases N(0, 0.02), LayerNorms at
    scale 1 / bias 0, unit-norm prompt embeddings. Real scores need the
    converted openai weights; these prove the scoring path."""
    prompts = ("brightness", "noisiness", "quality")
    rng = np.random.default_rng(seed)
    mlp_dim = mlp_dim or 4 * width

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def dense(i, o, bias=True):
        return {"kernel": normal(i, o), "bias": normal(o)} if bias else {"kernel": normal(i, o)}

    def ln():
        return {"scale": np.ones(width, np.float32), "bias": np.zeros(width, np.float32)}

    params = {"patch_embedding": {"kernel": normal(patch, patch, 3, width)},
              "class_embedding": normal(width),
              "position_embedding": normal((image_size // patch) ** 2 + 1, width),
              "pre_layrnorm": ln()}
    for i in range(layers):
        params[f"layer_{i}"] = {
            "self_attn": {n: dense(width, width) for n in ("q_proj", "k_proj", "v_proj",
                                                          "out_proj")},
            "layer_norm1": ln(), "layer_norm2": ln(),
            "fc1": dense(width, mlp_dim), "fc2": dense(mlp_dim, width)}
    params["post_layernorm"] = ln()
    params["visual_projection"] = dense(width, proj_dim, bias=False)
    te = rng.standard_normal((2 * len(prompts), proj_dim)).astype(np.float32)
    bundle = flatten_params(params)
    bundle["text_embeds"] = te / np.linalg.norm(te, axis=-1, keepdims=True)
    bundle["prompts"] = np.str_(",".join(prompts))
    bundle["logit_scale"] = np.float32(100.0)
    np.savez(path, **bundle)
    return path


def write_eval_images(root, n: int, h: int, w: int, seed: int):
    """n seeded low-light inputs ``root/input/{i}.png`` and their targets
    ``root/target/{i}.png`` (a smooth pattern plus noise; the input is the
    target x 0.3), written by the port's PNG writer."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / 23.0
    for i in range(n):
        base = 0.5 + 0.35 * np.sin(yy + (0.5 + i) * xx)[..., None] * rng.random((1, 1, 3))
        gt = np.clip(base + 0.05 * rng.standard_normal((h, w, 3)), 0, 1)
        imwrite((gt * 255).round().astype(np.uint8), os.path.join(root, "target", f"{i}.png"))
        imwrite((gt * 0.3 * 255).round().astype(np.uint8),
                os.path.join(root, "input", f"{i}.png"))


def write_flagship_checkpoint(path: str, opt_path: str) -> str:
    """A ``net_g`` file of the net of ``opt_path`` (the flagship's options):
    the seeded init from its ``manual_seed``, then ``load_frozen`` of its QD
    decomposition, written by the port's ``save_params``. Returns ``path``."""
    from .archs import build_network
    from .convert import state_dict_to_flax
    from .utils.checkpoint import save_params
    from .utils.options import parse

    opt = parse(opt_path, is_train=False)
    net = build_network(opt["network_g"],
                        torch.Generator().manual_seed(int(opt.get("manual_seed") or 0)))
    net.load_frozen()
    save_params(path, state_dict_to_flax(net))
    return path


# flax module path -> the reference PyTorch module path (the inverse of
# archs/convert_network.py's mapping), applied in order
_REFERENCE_RENAMES = [
    (r"^subnets_(\d+)/enc_(\d+)/blocks_(\d+)", r"subnets.\1.encoder_layers.\2.0.blocks.\3"),
    (r"^subnets_(\d+)/down_(\d+)/conv$", r"subnets.\1.encoder_layers.\2.1"),
    (r"^subnets_(\d+)/down_(\d+)", r"subnets.\1.encoder_layers.\2.1"),
    (r"^subnets_(\d+)/bottleneck/blocks_(\d+)", r"subnets.\1.bottleneck.blocks.\2"),
    (r"^subnets_(\d+)/up_(\d+)/deconv$", r"subnets.\1.decoder_layers.\2.0"),
    (r"^subnets_(\d+)/up_(\d+)", r"subnets.\1.decoder_layers.\2.0"),
    (r"^subnets_(\d+)/fusion_(\d+)", r"subnets.\1.decoder_layers.\2.1"),
    (r"^subnets_(\d+)/dec_(\d+)/blocks_(\d+)", r"subnets.\1.decoder_layers.\2.2.blocks.\3"),
    (r"^subnets_(\d+)/enc_(\d+)/sam_blocks_(\d+)",
     r"subnets.\1.encoder_layers.\2.0.sam_blocks.\3"),
    (r"^subnets_(\d+)/bottleneck/sam_blocks_(\d+)", r"subnets.\1.bottleneck.sam_blocks.\2"),
    (r"^subnets_(\d+)/dec_(\d+)/sam_blocks_(\d+)",
     r"subnets.\1.decoder_layers.\2.2.sam_blocks.\3"),
    (r"/conv_post$", "/conv_post.conv.0"), (r"/mlp/net_(\d)$", r"/mlp/net.\1"),
    (r"up_(p|b)_conv1$", r"up_\1.0"), (r"up_(p|b)_prelu$", r"up_\1.1"),
    (r"up_(p|b)_conv2$", r"up_\1.3"),
    (r"^branches/enc_(Q\d)_(\d+)/block_(\d+)", r"encoders_\1.\2.\3"),
    (r"^branches/down_(Q\d)_(\d+)", r"down_layers_\1.\2"),
    (r"^branches/bottleneck/block_(\d+)", r"bottleneck_block.\1"),
    (r"^branches/up_(Q\d)_(\d+)", r"decoders_\1.\2.up"),
    (r"^branches/fuse_(Q\d)_(\d+)", r"decoders_\1.\2.fuse"),
    (r"^branches/dec_(Q\d)_(\d+)/block_(\d+)", r"decoders_\1.\2.block.\3"),
    (r"^branches/", ""),
]


def reference_state(tree) -> dict:
    """A flax-layout ``Network`` tree (or a ``{"branches": ...}`` dual-branch
    subtree) -> the reference PyTorch checkpoint's state dict (numpy): module
    paths renamed to the reference's (a SAM's and an FFNv02's as the port's
    converter reads them), conv kernels HWIO -> OIHW, transposed
    conv kernels unflipped to (I, O, kh, kw), dense kernels (in, out) ->
    (out, in), ``scale`` / ``slope`` -> ``weight``, the mask token NCHW."""
    import re

    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(tree, "")
    sd = {}
    for path, a in flat.items():
        mod, _, leaf = path.rpartition("/")
        raw = re.fullmatch(r"conv(\d+)_(kernel|bias)", leaf)
        if raw and re.search(r"/basic_block(_2|_4)?$", mod):  # SAM's dilated dense block
            mod, leaf = f"{mod}/conv_layers/{raw[1]}/conv/0", raw[2]
        transposed = mod.endswith("/deconv") or re.search(r"^branches/up_Q\d_\d+$", mod)
        for pat, rep in _REFERENCE_RENAMES:
            mod = re.sub(pat, rep, mod)
        mod = mod.replace("/", ".")
        if leaf in ("kernel", "mu_kernel", "rho_kernel"):
            leaf = leaf.replace("kernel", "weight")
            if transposed:
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            else:
                a = a.T
        elif leaf in ("scale", "slope"):
            leaf = "weight"
        elif leaf == "mask_token":
            a = a.transpose(0, 3, 1, 2)
        sd[f"{mod}.{leaf}" if mod else leaf] = np.ascontiguousarray(a)
    return sd


def write_reference_checkpoint(path: str, net) -> str:
    """The port's ``Network`` as a reference-layout ``ckpt.pth`` (its state
    dict under ``params``, as the released checkpoints hold it). Returns
    ``path``."""
    from .convert import state_dict_to_flax

    sd = reference_state(state_dict_to_flax(net))
    torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return path
