"""FLOPs, parameters and throughput (counterpart of bem_tpu/analysis/flops_param.py).

bem_tpu reads FLOPs from XLA's cost analysis of the compiled program,
which counts elementwise work too. The port counts with
``torch.utils.flop_counter.FlopCounterMode``, which counts matmuls and
convolutions only (two FLOPs a multiply-add), so the two counts of one
net differ; ``flops_selective_scan`` is the same analytical estimate in
both.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def count_params(params: Any) -> int:
    """Elements of a module's parameters, or of a {name: tensor} mapping."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return int(sum(p.numel() for p in params.values()))


def flops_selective_scan(B=1, L=256, D=768, N=16, with_D=True, with_Z=False) -> int:
    """Analytical estimate 9*B*L*D*N (csms6s.py:143-164, per
    state-spaces/mamba#110)."""
    flops = 9 * B * L * D * N
    if with_D:
        flops += B * D * L
    if with_Z:
        flops += B * D * L
    return flops


@torch.no_grad()
def count_flops(fn: Callable, *example_args) -> Dict[str, float]:
    """FLOPs of one call of ``fn`` (matmuls and convolutions, as
    FlopCounterMode counts them); bytes accessed are not counted (-1, as
    bem_tpu reports a figure its cost analysis lacks)."""
    with FlopCounterMode(display=False) as counter:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": -1.0}


@torch.no_grad()
def throughput(fn: Callable, *example_args, iters: int = 10, warmup: int = 2,
               batch: int = 1) -> float:
    """Images/s of ``fn`` over ``iters`` calls after ``warmup`` ones; each
    call ends in a host read of its output's sum, which waits for the
    device (bem_tpu's forced fetch), and the clock stops after a
    synchronize."""
    def call():
        out = fn(*example_args)
        out = out[-1] if isinstance(out, (list, tuple)) else out
        return float(out.float().sum())

    for _ in range(warmup):
        call()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return batch * iters / (time.perf_counter() - t0)


def analyze_network(net: torch.nn.Module, example_input) -> Dict[str, Any]:
    """Parameters and forward FLOPs of an initialized module (the last
    output where it returns several)."""
    stats = count_flops(net, example_input)
    stats["params"] = count_params(net)
    return stats
