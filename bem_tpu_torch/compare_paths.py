"""Time the BEM nets' paths of two checkouts in turns on one card.

    python -m bem_tpu_torch.compare_paths PARENT_DIR CHANGE_DIR

Each of 8 runs is a fresh process in one checkout (each with its own
kernel build) that calls that checkout's ``chip_smoke.train_phase`` (IE and
CG, 1 warm-up + 5 timed steps each) and ``chip_smoke.serve`` (the flagship
K=16 pipeline, 3 requests), with chip_smoke's own settings; runs alternate
parent, change, parent, ... Prints each run's medians, then per metric the
medians over the runs of each side, beside the card's name and power
limit. Compares two versions inside one call, where the host's share of a
step varies least.
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
METRICS = {
    "IE ms/step": r"ImageEnhancer train .*median ([\d.]+) ms/step",
    "CG ms/step": r"ConditionGenerator train .*median ([\d.]+) ms/step",
    "serving ms/request": r"pipeline K=.*median ([\d.]+) ms/request",
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        sys.exit(__doc__)
    dirs = {"parent": Path(argv[0]), "change": Path(argv[1])}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    results = {side: {m: [] for m in METRICS} for side in dirs}
    for i in range(RUNS):
        side = "parent" if i % 2 == 0 else "change"
        out = subprocess.run([sys.executable, "-c", RUN], cwd=dirs[side],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            sys.exit(f"run {i + 1} ({side}) failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        vals = {m: float(re.search(rx, out.stdout).group(1)) for m, rx in METRICS.items()}
        for m, v in vals.items():
            results[side][m].append(v)
        print(f"run {i + 1} ({side}): " + ", ".join(f"{m} {v}" for m, v in vals.items()),
              flush=True)
    for m in METRICS:
        par, chg = results["parent"][m], results["change"][m]
        print(f"{m}: parent median {statistics.median(par)} (runs {par}), change median "
              f"{statistics.median(chg)} (runs {chg}) ({card})")


if __name__ == "__main__":
    main()
