"""Time the BEM nets' and VMamba-T's paths of two checkouts in turns on one card.

    python -m bem_tpu_torch.compare_paths PARENT_DIR CHANGE_DIR [--bem | --eval]

Each of 8 runs is a fresh process in one checkout (each with its own
kernel build) that calls that checkout's ``chip_smoke.train_phase`` (IE and
CG, 1 warm-up + 5 timed steps each), ``chip_smoke.serve`` (the flagship
K=16 pipeline, 3 requests), ``chip_smoke.cls_train_phase`` (VMamba-T v2,
batch 128, 1 warm-up + 5 timed steps) and ``chip_smoke.cls_throughput_phase``
(bf16, batch 128, forward types v2 and v052d), with chip_smoke's own
settings (``--bem``: the BEM paths alone, the train steps and serving;
``--eval``: ``chip_smoke.eval_phase`` alone, the eval CLI at full width in
its three modes, each mode's steady-state s/img); runs alternate parent,
change, parent, ... Prints each run's numbers, then
per metric the medians
over the runs of each side, beside the card's name and power limit.
Compares two versions inside one call, where the host's share of a step
varies least.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import sys
from pathlib import Path

RUNS = 8
RUN = """import torch, chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs.card_info()
cs.build_kernels()
cs.train_phase(card)
cs.serve(card)
"""
RUN_CLS = """cs.cls_train_phase(card)
cs.cls_throughput_phase(card)
cs.cls_throughput_phase(card, "v052d", ("selective_scan_fused",))
"""
RUN_EVAL = """import os, shutil, torch, chip_smoke as cs
from bem_tpu_torch import smoke
card = cs.card_info()
cs.build_kernels()
os.makedirs(cs.EVAL_DIR, exist_ok=True)
try:
    os.environ["BEM_CLIP_NPZ"] = smoke.write_clip_bundle(
        os.path.join(cs.EVAL_DIR, "clip_vitb32.npz"), seed=0)
    with cs.torch_tf32_defaults():
        cs.eval_phase(card)
finally:
    shutil.rmtree(cs.EVAL_DIR, ignore_errors=True)
"""
BEM_METRICS = ("IE ms/step", "CG ms/step", "serving ms/request")
EVAL_METRICS = {f"eval {m} s/img": rf"eval {m} K=.*steady-state ([\d.]+) s/img"
                for m in ("full reference", "niqe", "clip")}
METRICS = {
    "IE ms/step": r"ImageEnhancer train .*median ([\d.]+) ms/step",
    "CG ms/step": r"ConditionGenerator train .*median ([\d.]+) ms/step",
    "serving ms/request": r"pipeline K=.*median ([\d.]+) ms/request",
    "VMamba-T ms/step": r"VMamba-T v2 train B=.*median ([\d.]+) ms/step",
    "VMamba-T train images/s": r"VMamba-T v2 train B=.* ms/step, ([\d.]+) images/s",
    "VMamba-T peak GiB": r"VMamba-T v2 train B=.*peak memory ([\d.]+) GiB",
    "VMamba-T bf16 images/s": r"VMamba-T v2 throughput B=.*bf16: ([\d.]+) images/s",
    "VMamba-T v052d bf16 images/s": r"VMamba-T v052d throughput B=.*bf16: ([\d.]+) images/s",
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    bem_only, eval_only = "--bem" in argv, "--eval" in argv
    argv = [a for a in argv if a not in ("--bem", "--eval")]
    if len(argv) != 2 or (bem_only and eval_only):
        sys.exit(__doc__)
    dirs = {"parent": Path(argv[0]), "change": Path(argv[1])}
    if eval_only:
        run, metrics = RUN_EVAL, EVAL_METRICS
    else:
        run = RUN if bem_only else RUN + RUN_CLS
        metrics = {m: rx for m, rx in METRICS.items() if not bem_only or m in BEM_METRICS}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    results = {side: {m: [] for m in metrics} for side in dirs}
    for i in range(RUNS):
        side = "parent" if i % 2 == 0 else "change"
        out = subprocess.run([sys.executable, "-c", run], cwd=dirs[side],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.exit(f"run {i + 1} ({side}) failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        vals = {m: float(re.search(rx, out.stdout).group(1)) for m, rx in metrics.items()}
        for m, v in vals.items():
            results[side][m].append(v)
        print(f"run {i + 1} ({side}): " + ", ".join(f"{m} {v}" for m, v in vals.items()),
              flush=True)
    for m in metrics:
        par, chg = results["parent"][m], results["change"][m]
        print(f"{m}: parent median {statistics.median(par)} (runs {par}), change median "
              f"{statistics.median(chg)} (runs {chg}) ({card})")


if __name__ == "__main__":
    main()
