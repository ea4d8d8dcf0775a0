"""Where an eval image's time goes: the eval CLI at full width under
torch.profiler.

Runs ``enhancement/eval.py::main`` (the LOLv1 option files, seeded nets,
three seeded 400x600 PNGs with targets, K=16, parallel_num 8, the fp32
stream) once to warm up, then once under the profiler, and prints per
image: the wall time, the device's busy share, the host and device time
of the two stages (the profiler ranges ``eval.cg``: the K condition
generator forwards with their weight samples; ``eval.ie``: the enhancer
over chunks of candidates), the rest of the wall (reading, scoring and
selection, writing), and device time by kernel; with the card's name and
power limit:

    python -m bem_tpu_torch.enhancement.profile_eval [--mode niqe|clip|full] [--flagship]

``clip`` scores on a seeded ViT-B/32 bundle (``smoke.write_clip_bundle``).
``--flagship``: the IE is DecompDualBranchDDWavelet, its option file as it
is, on a net_g of ``smoke.write_flagship_checkpoint`` (seeded, with the
frozen QD model4).
The files go to ``results/profile_eval/`` of the checkout, removed at the
end.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from .. import smoke
from .eval import main as eval_main

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODES = {"niqe": ["--no_ref", "niqe"], "clip": ["--no_ref", "clip"],
         "full": ["--GT_mean", "--Monte_Carlo"]}
N_IMAGES = 3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="niqe", choices=sorted(MODES))
    p.add_argument("--flagship", action="store_true",
                   help="the flagship (DecompDualBranchDDWavelet) as the IE")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    root = os.path.join(REPO, "results", "profile_eval")
    try:
        smoke.write_eval_images(root, N_IMAGES, 400, 600, seed=22)
        if args.mode == "clip":
            os.environ["BEM_CLIP_NPZ"] = smoke.write_clip_bundle(
                os.path.join(root, "clip_vitb32.npz"), seed=0)
        ie = ["--cond_opt", os.path.join(REPO, "Options", "IE_UNet_LOLv1.yml")]
        if args.flagship:
            opt = os.path.join(REPO, "Options", "DecompDualBranch2DDWavelet_4.yml")
            ie = ["--cond_opt", opt, "--cond_weights", smoke.write_flagship_checkpoint(
                os.path.join(root, "net_g_flagship.msgpack"), opt)]
        cli = ["--opt", os.path.join(REPO, "Options", "CG_UNet_LOLv1.yml"), *ie,
               "--input_dir", os.path.join(root, "input"), "--result_dir",
               os.path.join(root, "out"), "--num_samples", "16", "--parallel_num", "8",
               "--device", "cuda", *MODES[args.mode]]
        if args.mode == "full":
            cli += ["--target_dir", os.path.join(root, "target")]
        eval_main(cli)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = eval_main(cli)
            torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n = len(res["per_image_s"])
    wall_ms = 1e3 * sum(res["per_image_s"]) / n
    events = prof.key_averages()
    # the ranges show twice: as host events (their kernels' device time) and
    # as annotations on the device timeline (first kernel to last)
    kernels = [e for e in events if e.device_type.name == "CUDA" and not e.key.startswith("eval.")]
    span = {e.key: e.device_time_total for e in events
            if e.device_type.name == "CUDA" and e.key.startswith("eval.")}
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    print(f"{card}: eval {args.mode} 400x600 K=16 parallel_num 8 fp32"
          f"{', flagship IE' if args.flagship else ''}, per image over {n}: "
          f"{wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), idle {100 - 100 * busy_ms / wall_ms:.1f} %")
    host = 0.0
    for e in events:
        if e.key in ("eval.cg", "eval.ie") and e.device_type.name == "CPU":
            cpu_ms = e.cpu_time_total / 1e3 / n
            host += cpu_ms
            print(f"  {e.key}: host {cpu_ms:.1f} ms, its kernels {e.device_time_total / 1e3 / n:.1f}"
                  f" ms, device span {span.get(e.key, 0.0) / 1e3 / n:.1f} ms per image")
    print(f"  rest of the wall (read, wait for the device, score and select, write): "
          f"{wall_ms - host:.1f} ms per image")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        ms = e.self_device_time_total / 1e3 / n
        print(f"{ms:9.2f} ms {100 * ms / busy_ms:5.1f} % {e.count // n:6d}x  {e.key[:90]}")


if __name__ == "__main__":
    main()
