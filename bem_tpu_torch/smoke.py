"""Kernel-vs-plain comparison cases at the serving path's shapes.

Shared by ``chip_smoke.py`` and the ``cuda``-marked test: every case runs
one kernel wrapper and its plain PyTorch version on the same CUDA tensors
(inputs from a numpy seed, realistic weight scales) and reports the max
abs error against a tolerance scaled by the output's magnitude.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .ops import gdmlp_fused as _gd
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
}

# (label, B, C, H, W): the flagship path's levels at the 448x640 IE input
# (C = 40 / 80 / 160) and the CG's top level at 28x40, two images each
PATH_SHAPES = [
    ("IE-L0 448x640 C40", 2, 40, 448, 640),
    ("IE-L1 224x320 C80", 2, 80, 224, 320),
    ("IE-L2 112x160 C160", 2, 160, 112, 160),
    ("CG-L0 28x40 C40", 2, 40, 28, 40),
]
SMALL_SHAPES = [("small 16x48 C16", 2, 16, 16, 48), ("small 12x20 C40", 1, 40, 12, 20)]
HEADLINE = ("IE-L0 448x640 C40", "bfloat16")  # the case whose numbers the summary reports


def reset_launch_counts() -> None:
    for fn, *_ in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, (fn, *_) in KERNELS.items()}


# relative tolerance on max|plain|: fp32 sums in another order (and the scan
# by doubling instead of a sequential loop); bf16 outputs may differ by a
# few bf16 ulps where the two sides round an intermediate differently
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@dataclass
class Case:
    name: str
    label: str
    dtype: torch.dtype
    args: tuple

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
    R, N = math.ceil(C / 16), 1
    P = R + 2 * N
    xs = x / (1.0 + np.exp(-x))  # SiLU output, as the stem hands it on
    bias = _dt_bias(rng, (4, C))
    scan_w = [t(_uniform(rng, (4, P, C), (4 * P) ** -0.5)),
              t(_uniform(rng, (4, C, R), R ** -0.5)), t(bias),
              t(-np.ones((4, C, N))), t(np.ones((4, C)))]
    cases.append(Case("ss2d_seq_pair", label, dtype, (s(xs), *scan_w, "row")))
    clamp_bias = bias.copy()
    clamp_bias[:, ::3] = 12.0  # dt ~ 12, dt*A ~ -12: the -10 clamp bites
    scan_w[2] = t(clamp_bias)
    cases.append(Case("ss2d_seq_pair", label + " clamp", dtype, (s(xs), *scan_w, "col")))
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


def kernel_cases(small: bool = False, device="cuda"):
    """Every kernel at every shape (``small``: two tiny shapes), fp32 and bf16."""
    shapes = SMALL_SHAPES if small else PATH_SHAPES
    out = []
    for i, (label, B, C, H, W) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            out += _cases_for(label, B, C, H, W, dtype, device, seed=i)
    return out


@torch.inference_mode()
def compare(case: Case):
    """(max abs error of the kernel vs its plain version, the tolerance)."""
    out = case.fn(*case.args)
    ref = case.plain(*case.args)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{case.name}: {out.shape}/{out.dtype} vs "
                             f"{ref.shape}/{ref.dtype}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{case.name} {case.label}: non-finite kernel output")
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
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
