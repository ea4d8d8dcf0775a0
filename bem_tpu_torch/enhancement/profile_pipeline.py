"""Where a serving request's device time goes, by kernel.

Runs the flagship pipeline (K=16, two 400x600 images, bf16) once to warm
up, then one request under torch.profiler, and prints device time summed
by kernel name (every kernel, the longest first), the share of the request's wall time the device was busy,
and the card's name and power limit:

    python -m bem_tpu_torch.enhancement.profile_pipeline
"""

from __future__ import annotations

import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .pipeline import build_pipeline, padded_size


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_pipeline: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    H, W, nimg = 400, 600, 2
    pipe = build_pipeline(nimg=nimg, K=16, device="cuda", dtype=torch.bfloat16, H=H, W=W)
    Hp, Wp = padded_size(H, W)
    g = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand(nimg, Hp, Wp, 3, device="cuda", generator=g).bfloat16()
    cond = torch.rand(nimg, Hp // 16, Wp // 16, 3, device="cuda", generator=g).bfloat16()
    pipe(g, img, cond)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(g, img, cond)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{card}: request {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), idle {100 - 100 * busy_ms / wall_ms:.1f} %")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        ms = e.self_device_time_total / 1e3
        print(f"{ms:9.2f} ms {100 * ms / busy_ms:5.1f} % {e.count:6d}x  {e.key[:90]}")


if __name__ == "__main__":
    main()
