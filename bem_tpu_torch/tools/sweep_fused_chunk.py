"""Sweep the chunked forward scans' super-chunk length on the card.

Two kernels run as chunked scans over super-chunks of S positions, S from
``super_chunk`` in csrc/common.cuh (the fewest super-chunks whose
full-pass walkers reach ``kFwdFill``): the fused SS2D core's forward (rows
8 / 10, csrc/ss2d_fused.cu, ``ops.ss2d_fused.fused_chunk``) and the fused
selective scan (row 11, csrc/scan_fused.cu, ``ops.scan_fused.scan_chunk``).
This times each (the fused forward: the projection; where L > S the
summary pass and the carry; the full pass; bf16, no checkpoints, as the
throughput path runs it; row 11 on v052d's scans-2 inputs,
``smoke._scan_fused_inputs``, bf16) at the VMamba-T stages S0-S3
(``smoke.CLS_SHAPES``) for B = 2 and 128 over super-chunk counts m = 1, 2,
3, 4, 6, ... up to one 32-position chunk each, CUDA events as in
``smoke.time_ms``, and prints the S the source picks beside them with the
card's name and power limit. With ``--parent DIR`` (a checkout of another
commit, e.g. unpacked by ``git archive``) it also times the public wrappers
``ss2d_dir_fused`` and ``selective_scan_fused`` at the same shapes and
inputs in fresh processes, parent, change, change, parent, and prints each
run:

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
CK = 32  # positions per staged chunk: S is a multiple of it


def _inputs(B, C, L, R, N):
    """A seeded bf16 (B, 2, C, L) SiLU stream on the card and the core's
    weights at the v0 init's scales (smoke._fused_weights)."""
    from bem_tpu_torch import smoke

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, 2, C, L), generator=g, device="cuda")
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    return (x * torch.sigmoid(x)).to(torch.bfloat16), smoke._fused_weights(
        np.random.default_rng(1), C, R, N, t)


def _scan_inputs(B, C, H, W, R, N):
    """selective_scan_fused's bf16 inputs on the card as v052d makes them
    (smoke._scan_fused_inputs, scans 2)."""
    from bem_tpu_torch import smoke

    args, _ = smoke._scan_fused_inputs(B, C, H, W, R, N, 2, "cuda", 1)
    return tuple(a.to(torch.bfloat16) if i in (0, 1, 3, 4) else a for i, a in enumerate(args))


def _shapes():
    from bem_tpu_torch import smoke

    return [(label, B, C, H, W, R, N) for B in BATCHES
            for label, _, C, H, W, R, N in smoke.CLS_SHAPES]


def _wrapper_run(shapes) -> str:
    """The program a checkout runs to time its public wrappers (it needs
    only ss2d_dir_fused, selective_scan_fused, smoke.time_ms,
    smoke._fused_weights and smoke._scan_fused_inputs)."""
    return "\n".join([
        "import numpy as np, torch",
        "from bem_tpu_torch import _build, smoke",
        "from bem_tpu_torch.ops.ss2d_fused import ss2d_dir_fused",
        "from bem_tpu_torch.ops.scan_fused import selective_scan_fused",
        inspect.getsource(_inputs),
        inspect.getsource(_scan_inputs),
        "_build.load()",
        f"for label, B, C, H, W, R, N in {shapes!r}:",
        "    xs2, w = _inputs(B, C, H * W, R, N)",
        "    ms = smoke.time_ms(ss2d_dir_fused, (xs2, *w))",
        "    print(f'wrapper ss2d_dir_fused {label} B={B} bf16: {ms:.4f} ms', flush=True)",
        "    del xs2, w",
        "    args = _scan_inputs(B, C, H, W, R, N)",
        "    ms = smoke.time_ms(selective_scan_fused, args)",
        "    print(f'wrapper selective_scan_fused {label} B={B} bf16: {ms:.4f} ms', flush=True)",
        "    del args",
        "    torch.cuda.empty_cache()",
    ])


def _lengths(L):
    """The super-chunk lengths of the counts in COUNTS (and one chunk each)."""
    nck = -(-L // CK)
    return sorted({-(-nck // m) * CK for m in COUNTS + (nck,) if m <= nck}, reverse=True)


def _line(what, label, B, L, run, picked, card):
    """Time ``run(S)`` at every length of _lengths(L); print one line."""
    from bem_tpu_torch import smoke

    parts = []
    for S in _lengths(L):
        parts.append(f"m={-(-L // S)} (S={S}) {smoke.time_ms(lambda S=S: run(S), ()):.4f} ms")
    print(f"{what} {label} B={B} bf16: {', '.join(parts)}; the source picks S={picked} "
          f"(m={-(-L // picked)}) ({card})", flush=True)


def sweep(card: str) -> None:
    from bem_tpu_torch import _build
    from bem_tpu_torch.ops import scan_fused as sf
    from bem_tpu_torch.ops import ss2d_fused as fused

    _build.load()
    for label, B, C, H, W, R, N in _shapes():
        L = H * W
        xs2, w = _inputs(B, C, L, R, N)
        wa = fused._args(xs2, *w)
        _line("fused forward", label, B, L,
              lambda S: fused._fwd_kernels(xs2, wa, False, False, S),
              fused.fused_chunk(B, C, N, L), card)
        del xs2, w, wa
        ins = sf._cuda_args(*_scan_inputs(B, C, H, W, R, N))
        _line("selective scan", label, B, L, lambda S: sf._kernels(*ins, True, S),
              sf.scan_chunk(4 * B, C, N, L), card)
        del ins
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose wrappers are timed against this one's")
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
