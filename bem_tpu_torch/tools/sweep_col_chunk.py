"""Sweep the column pair's chunk length on the card (csrc/ss2d_col.cu).

The kernels take the chunk length T as an argument; the pair uses the
source's ``kColChunk`` halved by shared memory (``ops.ss2d_seq.col_chunk``).
This times the whole pair (summary pass, the two carries, the full pass),
CUDA events as in ``smoke.time_ms``, at the serving batch's two widest
levels (``smoke.SERVE_SHAPES``, bf16) and at IE-L0 B=2, for T in 8, 16, 32
and 64 where the full pass's shared memory allows it, and prints the
length the source picks beside them with the card's name and power limit:

    python -m bem_tpu_torch.tools.sweep_col_chunk
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build, smoke
from ..ops import ss2d_seq as seq
from ..ops.scan import linear_scan

CHUNKS = (8, 16, 32, 64)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_col_chunk: needs a CUDA device")
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    _build.load()
    shapes = [("IE-L0 448x640 C40 B=2", 2, 40, 448, 640)] + smoke.SERVE_SHAPES
    for label, B, C, H, W in shapes:
        rng = np.random.default_rng(0)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
        x = rng.standard_normal((B, C, H * W), dtype=np.float32)
        xs = t(x / (1.0 + np.exp(-x))).to(torch.bfloat16)
        w = smoke._scan_weights(rng, C, t)
        fwd, rev = seq._col_args(xs, *w, None, H, W)
        N = fwd[3].shape[-1]
        picked = seq.col_chunk(C, fwd[0].shape[0] - 2 * N, N, xs.dtype)
        line = []
        for T in CHUNKS:
            run = lambda T=T: seq._col_pair(  # noqa: E731
                xs, fwd, rev, None, H, W, T, seq.ss2d_col_sum, seq.ss2d_col_dir, linear_scan)
            try:
                line.append(f"T={T} {smoke.time_ms(run, ()):.4f} ms")
            except RuntimeError:  # the full pass's shared memory exceeds the budget
                line.append(f"T={T} n/a")
            torch.cuda.empty_cache()
        print(f"column pair {label} bf16: {', '.join(line)}; the source picks T={picked} "
              f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
