"""Tracing and timing helpers (counterpart of bem_tpu/utils/profiler.py).

``torch.profiler`` takes the JAX profiler's place: :func:`trace` records
the host and, where there is a card, its kernels, and exports a Chrome
trace (chrome://tracing or Perfetto); :func:`annotate` names a span in it.
:func:`device_time` times a call with the card synchronised after each
run, as bem_tpu's forces a scalar back to the host.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "bem_trace")):
    """Profile the body (CPU, and CUDA where there is a card) and write
    ``<log_dir>/trace.json``; yields log_dir."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out) -> None:
    leaves = out if isinstance(out, (list, tuple)) else [out]
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()


def device_time(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Median seconds per call of ``fn(*args)`` over ``iters`` runs after
    ``warmup``, the card synchronised after each (where the output lies
    on one)."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def annotate(name: str):
    """A named span in the profiler's trace."""
    return record_function(name)
