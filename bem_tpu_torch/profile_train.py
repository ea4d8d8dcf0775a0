"""Where a train step's time goes, on the card and on the host.

For each trainer of the LOLv1 options at full width (IE: batch 8, 128x128;
CG: batch 8, 8x8), runs two warm-up steps, then one step under
torch.profiler, and prints the step's wall time, the share of it the
device was busy, device time summed by kernel name, the host ops with the
most self CPU time, and the card's name and power limit:

    python -m bem_tpu_torch.profile_train
"""

from __future__ import annotations

import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .models import build_model
from .options import lolv1_options
from .train import synthetic_batch


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for model_type in ("ImageEnhancer", "ConditionGenerator"):
        opt = dict(lolv1_options(model_type), is_train=True)
        model = build_model(opt, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(2):
            model.train_step(synthetic_batch(opt, gen))
        batch = synthetic_batch(opt, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.train_step(batch)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type.name == "CUDA"]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        launches = sum(e.count for e in kernels)
        print(f"{card}: {model_type} train step {wall_ms:.1f} ms wall, device busy "
              f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %), idle "
              f"{100 - 100 * busy_ms / wall_ms:.1f} %, {launches} device kernels")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
            ms = e.self_device_time_total / 1e3
            print(f"  device {ms:9.2f} ms {100 * ms / busy_ms:5.1f} % {e.count:6d}x  {e.key[:80]}")
        host = [e for e in events if e.device_type.name == "CPU"]
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]:
            ms = e.self_cpu_time_total / 1e3
            print(f"  host   {ms:9.2f} ms {e.count:6d}x  {e.key[:80]}")
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
