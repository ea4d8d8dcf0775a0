"""Sweep the fused SS2D core's super-chunk length on the card (csrc/ss2d_fused.cu).

The forward (rows 8 / 10) runs as a chunked scan over super-chunks of S
positions; the source's ``fwd_chunk`` picks S (``ops.ss2d_fused.fused_chunk``:
the fewest super-chunks whose full-pass walkers reach ``kFwdFill``). This
times the forward (the projection; where L > S the summary pass and the
carry; the full pass; bf16, no checkpoints, as the throughput path runs it)
at the VMamba-T stages S0-S3 (``smoke.CLS_SHAPES``) for B = 2 and 128 over
super-chunk counts m = 1, 2, 3, 4, 6, ... up to one 32-position chunk each,
CUDA events as in ``smoke.time_ms``, and prints the S the source picks
beside them with the card's name and power limit. With ``--parent DIR`` (a
checkout of another commit, e.g. unpacked by ``git archive``) it also times
the public wrapper ``ss2d_dir_fused`` at the same shapes and inputs in
fresh processes, parent, change, change, parent, and prints each run:

    python -m bem_tpu_torch.tools.sweep_fused_chunk [--parent DIR]
"""

from __future__ import annotations

import argparse
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BATCHES = (2, 128)
COUNTS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def _inputs(B, C, L, R, N):
    """A seeded bf16 (B, 2, C, L) SiLU stream on the card and the core's
    weights at the v0 init's scales (smoke._fused_weights)."""
    from bem_tpu_torch import smoke

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, 2, C, L), generator=g, device="cuda")
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    return (x * torch.sigmoid(x)).to(torch.bfloat16), smoke._fused_weights(
        np.random.default_rng(1), C, R, N, t)


def _shapes():
    from bem_tpu_torch import smoke

    return [(label, B, C, H * W, R, N) for B in BATCHES
            for label, _, C, H, W, R, N in smoke.CLS_SHAPES]


def _wrapper_run(shapes) -> str:
    """The program a checkout runs to time its public wrapper (it needs
    only ss2d_dir_fused, smoke.time_ms and smoke._fused_weights)."""
    return "\n".join([
        "import numpy as np, torch",
        "from bem_tpu_torch import _build, smoke",
        "from bem_tpu_torch.ops.ss2d_fused import ss2d_dir_fused",
        inspect.getsource(_inputs),
        "_build.load()",
        f"for label, B, C, L, R, N in {shapes!r}:",
        "    xs2, w = _inputs(B, C, L, R, N)",
        "    ms = smoke.time_ms(ss2d_dir_fused, (xs2, *w))",
        "    print(f'wrapper {label} B={B} bf16: {ms:.4f} ms', flush=True)",
        "    del xs2, w",
        "    torch.cuda.empty_cache()",
    ])


def sweep(card: str) -> None:
    from bem_tpu_torch import _build, smoke
    from bem_tpu_torch.ops import ss2d_fused as fused

    _build.load()
    for label, B, C, L, R, N in _shapes():
        xs2, w = _inputs(B, C, L, R, N)
        wa = fused._args(xs2, *w)
        nck = -(-L // fused.CKPT)
        lengths = sorted({-(-nck // m) * fused.CKPT for m in COUNTS + (nck,) if m <= nck},
                         reverse=True)
        line = []
        for S in lengths:
            ms = smoke.time_ms(lambda S=S: fused._fwd_kernels(xs2, wa, False, False, S), ())
            line.append(f"m={-(-L // S)} (S={S}) {ms:.4f} ms")
        picked = fused.fused_chunk(B, C, N, L)
        print(f"fused forward {label} B={B} bf16: {', '.join(line)}; the source picks "
              f"S={picked} (m={-(-L // picked)}) ({card})", flush=True)
        del xs2, w, wa
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose ss2d_dir_fused is timed against this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_fused_chunk: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    sweep(card)
    if args.parent is not None:
        here = Path(__file__).resolve().parents[2]
        prog = _wrapper_run(_shapes())
        for side, cwd in (("parent", args.parent), ("change", here), ("change", here),
                          ("parent", args.parent)):
            out = subprocess.run([sys.executable, "-c", prog], cwd=cwd, capture_output=True,
                                 text=True, timeout=900)
            if out.returncode != 0:
                raise SystemExit(f"{side} run failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
            for line in out.stdout.splitlines():
                print(f"{side}: {line} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
