"""Export the full-width serving pipeline on the card and run the artifact
beside the live pipeline (counterpart of tools/export_onchip.py).

The pipeline is ``enhancement.pipeline.build_pipeline``'s at full width
(seed-0 flagship nets, K=16, NIMG=2, 400x600 padded to 448x640, bf16
stream). Its :class:`ServingPipeline` is exported with
``enhancement.export.export_pipeline`` (platforms "cuda"), saved, loaded
back with ``load_pipeline``, and both answer the same requests, the
weight noise of request i drawn from ``Generator("cuda").manual_seed(100
+ i)``: the live closure draws it itself, the artifact takes it from
``draw_eps``. Checks: the same chosen candidates, the NIQE scores within
1e-6 relative, the selected crops within 1e-6, every kernel of rows 1-7 launched inside the artifact's
requests, and a bem:: node of each of rows 1-7 in its graph. Then the host
cost of the operator layer: microseconds a call of bem::ss2d_tail against
its CUDA implementation called directly, at a tiny shape.

Prints one JSON line (bem_tpu's fields; ``iter_ms_jit`` is
``iter_ms_live`` here) and returns it as a dict:

    python -m bem_tpu_torch.tools.export_onchip [--path FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from .. import smoke
from ..enhancement.export import export_pipeline, load_pipeline
from ..enhancement.pipeline import build_pipeline, draw_eps, padded_size
from ..ops import ss2d_tail

K, NIMG, H, W = 16, 2, 400, 600
N_REQUESTS = 3
SCORE_RTOL = 1e-6
SELECTED_ATOL = 1e-6
# the operators of rows 1-7, each with the kernel whose launches it counts
# (``launches_in_artifact`` is keyed by the kernels' names, as smoke's counts)
ROW_OPS = {"stem_fused": "stem_fused_cf", "ss2d_seq_pair": "ss2d_seq_pair",
           "ss2d_tail": "ss2d_tail_cf", "gdmlp_fused": "gdmlp_fused_cf",
           "ss2d_col_sum": "ss2d_col_sum", "ss2d_col_dir": "ss2d_col_dir",
           "linear_scan": "linear_scan"}


def _inputs():
    """chip_smoke's serving inputs: seed 0, numpy, on the card in bf16."""
    Hp, Wp = padded_size(H, W)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((NIMG, Hp, Wp, 3), np.float32))
    cond = torch.from_numpy(rng.random((NIMG, Hp // 16, Wp // 16, 3), np.float32))
    return img.to("cuda", torch.bfloat16), cond.to("cuda", torch.bfloat16)


def _request(fn):
    """(outputs, seconds) of one request, the device drained after it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def op_overhead_us(n: int = 2000) -> tuple:
    """Host microseconds a call of bem::ss2d_tail and of its CUDA
    implementation called directly, at B=1, C=8, L=16 fp32 (each timed over
    ``n`` calls after as many warm-up calls, the device drained at the
    ends)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    y = torch.randn(1, 8, 16, device="cuda", generator=g)
    args = (y, None, torch.ones(8, device="cuda"), torch.zeros(8, device="cuda"),
            torch.eye(8, device="cuda"), None, None)
    out = []
    for fn in (torch.ops.bem.ss2d_tail.default, ss2d_tail._tail_cuda):
        for _ in range(n):  # warm-up
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
        out.append(1e6 * (time.perf_counter() - t0) / n)
    return tuple(out)


def main(path: str = None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("export_onchip: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    path = path or os.path.join("results", "export_onchip", "serve.pt2")
    pipe = build_pipeline(nimg=NIMG, K=K, device="cuda", dtype=torch.bfloat16, seed=0, H=H, W=W)
    cg = pipe.module.cg
    img, cond = _inputs()
    gen = lambda i: torch.Generator(device="cuda").manual_seed(100 + i)  # noqa: E731

    t0 = time.perf_counter()
    export_pipeline(pipe.module, (draw_eps(cg, gen(0), K), img, cond), path, platforms="cuda")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = load_pipeline(path)
    load_s = time.perf_counter() - t0
    nodes = {str(n.target).split(".")[1] for n in g.graph.nodes
             if str(n.target).startswith("bem.")}
    missing = set(ROW_OPS) - nodes
    if missing:
        raise AssertionError(f"export_onchip: no bem:: node of {sorted(missing)} in the graph")

    _request(lambda: pipe(gen(0), img, cond))                      # warm-up, each side
    _request(lambda: g(draw_eps(cg, gen(0), K), img, cond))
    live, exported, t_live, t_exp = [], [], [], []
    for i in range(N_REQUESTS):
        out, t = _request(lambda: pipe(gen(i), img, cond))
        live.append(out)
        t_live.append(t)
    smoke.reset_launch_counts()
    for i in range(N_REQUESTS):
        out, t = _request(lambda: g(draw_eps(cg, gen(i), K), img, cond))
        exported.append(out)
        t_exp.append(t)
    counts = {k: smoke.launch_counts()[k] for k in smoke.BEM_KERNELS}
    if min(counts[k] for k in ROW_OPS.values()) <= 0:
        raise AssertionError(f"export_onchip: a row never launched in the artifact: {counts}")

    rel, sel_err = 0.0, 0.0
    for (s_l, b_l, c_l), (s_e, b_e, c_e) in zip(live, exported):
        if not torch.equal(b_l, b_e):
            raise AssertionError(f"export_onchip: artifact chose {b_e.tolist()}, "
                                 f"live {b_l.tolist()}")
        c_l, c_e = c_l.double(), c_e.double()
        rel = max(rel, ((c_e - c_l).abs() / c_l.abs().clamp(min=1e-9)).max().item())
        if s_e.shape != s_l.shape or not torch.isfinite(s_e.float()).all():
            raise AssertionError(f"export_onchip: bad artifact output {tuple(s_e.shape)}")
        sel_err = max(sel_err, (s_e.float() - s_l.float()).abs().max().item())
    if rel > SCORE_RTOL:
        raise AssertionError(f"export_onchip: NIQE scores {rel:.3e} relative apart "
                             f"(> {SCORE_RTOL})")
    if sel_err > SELECTED_ATOL:
        raise AssertionError(f"export_onchip: the selected crops {sel_err:.3e} apart "
                             f"(> {SELECTED_ATOL})")
    op_us, body_us = op_overhead_us()
    med_live, med_exp = statistics.median(t_live), statistics.median(t_exp)
    out = {
        "metric": "export_onchip",
        "card": card,
        "value_rel_err": rel,
        "selected_max_abs_err": sel_err,
        "iter_ms_live": 1e3 * med_live,
        "iter_ms_exported": 1e3 * med_exp,
        "exported_vs_live": med_exp / med_live,
        "export_s": export_s,
        "load_s": load_s,
        "artifact_bytes": os.path.getsize(path),
        "graph_nodes": len(g.graph.nodes),
        "launches_in_artifact": counts,
        "chosen": [b.tolist() for _, b, _ in exported],
        "op_call_us": op_us,
        "op_body_us": body_us,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", default=None, help="artifact file (results/export_onchip/serve.pt2)")
    main(ap.parse_args().path)
