"""Time linear_scan (row 7) and the SS2D tail (row 3) at their path shapes on the card.

linear_scan runs as one launch a call (csrc/scan.cu: a walk, or the
single-pass look-back form, as ``ops.scan.scan_plan`` picks). This times
its wrapper at the shapes the paths give it (``SCAN_SHAPES``: the training
backward's headline, the row / column carries of the serving batch at
IE-L0 / L1 / L2, the CG's, the fused core's super-chunk carry, row 9's
chunk carry), forward and reverse, by CUDA events (``smoke.time_ms``) and
by the profiler's device time, with the kernels a call launched. The tail
(csrc/ss2d_tail.cu) is timed the same way at ``TAIL_SHAPES`` (its path
form, merged with the residual, bf16 at the serving batch and the CG's,
unmerged at the headline, fp32 at the training shapes), and on the bf16
stream at every (tile, stages, threads) of its tensor-core form that fits
(``bem_ss2d_tail_tc_with``), beside the one the source picks. Each line
carries the card's name and power limit. With ``--parent DIR`` (a
checkout of another commit, e.g. unpacked by ``git archive``) it also
times both public wrappers of the two checkouts at the same shapes in
fresh processes, parent, change, change, parent:

    python -m bem_tpu_torch.tools.sweep_scan_tail [--parent DIR]
"""

from __future__ import annotations

import argparse
import inspect
import subprocess
import sys
from pathlib import Path

import torch

# (label, M, L, D)
SCAN_SHAPES = [("train IE-L0 bwd (headline)", 8, 16384, 40),
               ("IE-L0 carry B=32", 32, 8960, 40), ("IE-L1 carry B=32", 32, 2240, 80),
               ("IE-L2 carry B=32", 32, 1120, 160), ("CG-L0 carry", 2, 35, 40),
               ("fused fwd carry S0 B=2", 8, 17, 3072), ("fused bwd carry S0 B=128", 512, 98, 3072)]
# (label, B, C, L, merged, with the residual, dtype)
TAIL_SHAPES = [("IE-L0 B=2 unmerged (headline)", 2, 40, 448 * 640, False, True, "bfloat16"),
               ("IE-L0 B=2", 2, 40, 448 * 640, True, True, "bfloat16"),
               ("IE-L0 B=32", 32, 40, 448 * 640, True, True, "bfloat16"),
               ("IE-L1 B=32", 32, 80, 224 * 320, True, True, "bfloat16"),
               ("IE-L2 B=32", 32, 160, 112 * 160, True, True, "bfloat16"),
               ("CG-L0 B=2", 2, 40, 28 * 40, True, True, "bfloat16"),
               ("train IE-L0 B=8", 8, 40, 128 * 128, True, True, "float32"),
               ("train IE-L2 B=8", 8, 160, 32 * 32, True, True, "float32")]
PLANS = [(TL, st, nth) for nth in (256, 512) for TL in (64, 32) for st in (2, 1)]


def _scan_args(M, L, D):
    """Seeded decays exp(-U(0, 3)) and inputs on the card, fp32."""
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.exp(-3 * torch.rand((M, L, D), generator=g, device="cuda"))
    return a, torch.randn((M, L, D), generator=g, device="cuda")


def _tail_args(B, C, L, merged, with_res, dtype):
    """A mean-dominated scan output (+3) and the block's weights on the card."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    y = lambda: torch.randn((B, C, L), generator=g, device="cuda")  # noqa: E731
    W = (2 * torch.rand((C, C), generator=g, device="cuda") - 1) * C ** -0.5
    return ((3 + 2 * y()).to(dt), None if merged else y().to(dt),
            1 + 0.1 * torch.randn(C, generator=g, device="cuda"),
            0.1 * torch.randn(C, generator=g, device="cuda"), W, None,
            y().to(dt) if with_res else None)


def _device_ms(fn, args, n=10):
    """(device ms a call, kernels a call) over n calls under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    ks = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return (sum(e.self_device_time_total for e in ks) / 1e3 / n,
            {e.key.split("(")[0][:48]: e.count / n for e in ks})


def _wrapper_run() -> str:
    """The program a checkout runs to time its public wrappers (it needs
    only linear_scan, ss2d_tail_cf and smoke.time_ms)."""
    return "\n".join([
        "import torch",
        "from bem_tpu_torch import _build, smoke",
        "from bem_tpu_torch.ops.scan import linear_scan",
        "from bem_tpu_torch.ops.ss2d_tail import ss2d_tail_cf",
        inspect.getsource(_scan_args),
        inspect.getsource(_tail_args),
        inspect.getsource(_device_ms),
        "_build.load()",
        f"for label, M, L, D in {SCAN_SHAPES!r}:",
        "    a, b = _scan_args(M, L, D)",
        "    for rev in (False, True):",
        "        ms = smoke.time_ms(linear_scan, (a, b, rev))",
        "        dev, ks = _device_ms(linear_scan, (a, b, rev))",
        "        print(f'wrapper linear_scan {label} ({M}, {L}, {D}) rev {int(rev)}: '",
        "              f'{ms:.4f} ms, '",
        "              f'device {dev:.4f} ms, kernels {ks}', flush=True)",
        "    del a, b",
        f"for label, B, C, L, merged, with_res, dtype in {TAIL_SHAPES!r}:",
        "    args = _tail_args(B, C, L, merged, with_res, dtype)",
        "    ms = smoke.time_ms(ss2d_tail_cf, args)",
        "    dev, ks = _device_ms(ss2d_tail_cf, args)",
        "    print(f'wrapper ss2d_tail_cf {label} C{C} {dtype}: {ms:.4f} ms, '",
        "          f'device {dev:.4f} ms, '",
        "          f'kernels {ks}', flush=True)",
        "    del args",
        "    torch.cuda.empty_cache()",
    ])


def sweep_tail_plans(card: str) -> None:
    """The tensor-core tail at every plan that fits, bf16 TAIL_SHAPES."""
    import ctypes

    from bem_tpu_torch import _build, smoke
    from bem_tpu_torch.ops import ss2d_tail as tail
    from bem_tpu_torch.ops._common import ptr

    lib = _build.load()
    fn = lib.bem_ss2d_tail_tc_with
    for label, B, C, L, merged, with_res, dtype in TAIL_SHAPES:
        if dtype != "bfloat16":
            continue
        yr, yc, sc, bi, W, bo, res = tail._tail_args(*_tail_args(B, C, L, merged, with_res,
                                                                 dtype))
        out = torch.empty((B, C, L), dtype=yr.dtype, device="cuda")
        ref = tail.ss2d_tail_cf(yr, yc, sc, bi, W, bo, res)
        picked = ctypes.c_int(0)
        parts = []
        for TL, st, nth in PLANS:
            def run(TL=TL, st=st, nth=nth):
                rc = fn(ptr(yr), ptr(yc), ptr(sc), ptr(bi), ptr(W), ptr(bo), ptr(res), ptr(out),
                        B, C, C, L, TL, st, nth, ctypes.addressof(picked),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"plan {TL}/{st}/{nth}: CUDA error {rc}")
            try:
                run()
            except RuntimeError:
                continue  # does not fit
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if err > smoke.TOL[torch.bfloat16] * max(1.0, ref.float().abs().max().item()):
                raise AssertionError(f"tail {label}: plan {TL}/{st}/{nth} off the rule's by {err}")
            parts.append(f"TL {TL} stages {st} threads {nth}: {smoke.time_ms(run, ()):.4f} ms")
        p = picked.value
        print(f"tail plans {label} C{C} bf16: {'; '.join(parts)}; the source picks TL "
              f"{p // 100} stages {p // 10 % 10} threads {256 * (p % 10)} ({card})", flush=True)
        del yr, yc, res, out, ref
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose wrappers are timed against this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_scan_tail: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    sweep_tail_plans(card)
    here = Path(__file__).resolve().parents[2]
    sides = [("change", here)]
    if args.parent is not None:
        sides = [("parent", args.parent), ("change", here), ("change", here),
                 ("parent", args.parent)]
    for side, cwd in sides:
        out = subprocess.run([sys.executable, "-c", _wrapper_run()], cwd=cwd,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise SystemExit(f"{side} run failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        for line in out.stdout.splitlines():
            print(f"{side}: {line} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
