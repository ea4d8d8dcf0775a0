"""Throughput of the scan's inner operations on the card: kernels 12 and 13.

The counterpart of tools/microbench_vpu.py. Each kernel of
``csrc/microbench_vpu.cu`` runs a fixed number of rounds of one inner
operation over fp32 (n_blocks, 40, lanes) data, n_blocks = TOTAL / lanes,
so every variant touches the same TOTAL * 40 elements:

- :func:`vpu_scan_step` (``run``): ``npass`` rounds of the doubling scan's
  masked shift step (roll by 1 << (i % 5) within 32-lane segments, the
  wrapped lanes masked to the monoid's identity, then an FMA and a
  multiply);
- :func:`vpu_op_rounds` (``run2``): 10 rounds of ``arith``, ``exp``,
  ``softplus`` or ``roll`` (by one lane over the whole row, with wrap).

Both start from a = x, b = x / 2 and return a + b; each has a plain
PyTorch version (``torch.roll`` + ``torch.where`` + multiply-add), which
the wrapper runs for CPU tensors. The data are the tool's:
``default_rng(0).random((n_blocks, 40, lanes))`` as fp32, the same numbers
in the same order for every ``lanes``, so they are drawn once per process.
Times are CUDA-event times of the kernel alone, the least of ``reps``
launches after one warm-up. Needs a card:

    python -m bem_tpu_torch.tools.microbench_vpu          # lanes and npass sweep
    python -m bem_tpu_torch.tools.microbench_vpu modes    # the four modes
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import _build
from ..ops._common import on_cuda, ptr

TOTAL = 16 * 2 * 286720  # lane-equivalents per variant (the IE-L0 shape's)
C = 40
NPASS = 10
MODES = ("arith", "roll", "exp", "softplus")
LANES_SWEEP = (1024, 2048, 4096, 8192)
NPASS_SWEEP = (5, 20, 40)
_MODE_ID = {"arith": 0, "exp": 1, "softplus": 2, "roll": 3}


def _check(x: torch.Tensor, name: str) -> None:
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous fp32 (n_blocks, C, lanes), "
                         f"got {tuple(x.shape)} {x.dtype}")


def vpu_scan_step_plain(x: torch.Tensor, npass: int = NPASS) -> torch.Tensor:
    """The plain PyTorch version of :func:`vpu_scan_step`."""
    a = x
    b = a * 0.5
    col = torch.arange(x.shape[-1], device=x.device) % 32
    for i in range(npass):
        sh = 1 << (i % 5)
        mask = col < sh
        a_sh = torch.where(mask, 1.0, torch.roll(a, sh, -1))
        b_sh = torch.where(mask, 0.0, torch.roll(b, sh, -1))
        b = a * b_sh + b
        a = a * a_sh
    return a + b


def vpu_scan_step(x: torch.Tensor, npass: int = NPASS) -> torch.Tensor:
    """``npass`` rounds of the masked shift-scan step on x (n_blocks, C,
    lanes) fp32, lanes a multiple of 32: the plain version for a CPU
    tensor, the kernel for a CUDA one."""
    _check(x, "vpu_scan_step")
    if not on_cuda(x, "vpu_scan_step"):
        return vpu_scan_step_plain(x, npass)
    lanes = x.shape[-1]
    if lanes % 32:
        raise ValueError(f"vpu_scan_step: lanes {lanes} is not a multiple of 32")
    out = torch.empty_like(x)
    _build.call("bem_vpu_scan_step", ptr(x), ptr(out), x.numel() // lanes, lanes, int(npass))
    vpu_scan_step.launches += 1
    return out


def vpu_op_rounds_plain(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The plain PyTorch version of :func:`vpu_op_rounds`."""
    if mode not in _MODE_ID:
        raise ValueError(f"vpu_op_rounds: mode {mode!r} not in {tuple(_MODE_ID)}")
    a = x
    b = a * 0.5
    for _ in range(10):
        if mode == "arith":
            b = a * b + b
            a = a * a
            continue
        if mode == "exp":
            a = torch.exp(a * -0.01)
        elif mode == "softplus":
            v = a * 0.01
            a = torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))
        else:
            a = torch.roll(a, 1, -1)
        b = a * b + b
    return a + b


def vpu_op_rounds(x: torch.Tensor, mode: str) -> torch.Tensor:
    """10 rounds of ``mode`` (arith / exp / softplus / roll) on x
    (n_blocks, C, lanes) fp32: the plain version for a CPU tensor, the
    kernel for a CUDA one (roll: lanes a multiple of 512, at most 16384)."""
    _check(x, "vpu_op_rounds")
    if mode not in _MODE_ID:
        raise ValueError(f"vpu_op_rounds: mode {mode!r} not in {tuple(_MODE_ID)}")
    if not on_cuda(x, "vpu_op_rounds"):
        return vpu_op_rounds_plain(x, mode)
    lanes = x.shape[-1]
    out = torch.empty_like(x)
    _build.call("bem_vpu_op_rounds", ptr(x), ptr(out), x.numel() // lanes, lanes,
                _MODE_ID[mode])
    vpu_op_rounds.launches += 1
    return out


vpu_scan_step.launches = 0
vpu_op_rounds.launches = 0

_DATA = {}


def draw(device="cuda") -> torch.Tensor:
    """The tool's numbers, flat: default_rng(0).random(TOTAL * C) as fp32 on
    ``device``; ``.view(TOTAL // lanes, C, lanes)`` is the input for ``lanes``."""
    flat = np.random.default_rng(0).random(TOTAL * C).astype(np.float32)
    return torch.from_numpy(flat).to(device)


def data(lanes: int, device="cuda") -> torch.Tensor:
    """The tool's input for ``lanes`` (drawn once per device and process,
    then viewed)."""
    key = str(device)
    if key not in _DATA:
        _DATA[key] = draw(device)
    return _DATA[key].view(TOTAL // lanes, C, lanes)


def _time_s(fn, reps: int) -> float:
    """The least CUDA-event time of ``fn()`` over ``reps`` calls, after one warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _cuda() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("microbench_vpu: needs a CUDA device")


def run(lanes: int, npass: int = NPASS, reps: int = 3) -> float:
    """Time :func:`vpu_scan_step` at ``lanes`` and ``npass``; print the
    tool's line; return the seconds."""
    _cuda()
    n_blocks = TOTAL // lanes
    x = data(lanes)
    dt = _time_s(lambda: vpu_scan_step(x, npass), reps)
    elems = TOTAL * C
    print(f"lanes={lanes:6d} npass={npass:3d} blocks={n_blocks:6d}: "
          f"{dt * 1e3:10.4f} ms  -> {elems * npass / dt / 1e9:7.1f} G elem-pass/s  "
          f"({dt / n_blocks * 1e6:8.4f} us/step)", flush=True)
    return dt


def run2(mode: str, lanes: int = 4096, reps: int = 3) -> float:
    """Time :func:`vpu_op_rounds` in ``mode``; print the tool's line;
    return the seconds."""
    _cuda()
    x = data(lanes)
    dt = _time_s(lambda: vpu_op_rounds(x, mode), reps)
    print(f"mode={mode:9s}: {dt * 1e3:10.4f} ms for 10 rounds "
          f"-> {TOTAL * C * 10 / dt / 1e9:7.1f} G elem-round/s", flush=True)
    return dt


def sweep() -> dict:
    """The tool's default sweep: every lanes at npass 10, then npass 5 /
    20 / 40 at 4096 lanes; {(lanes, npass): seconds}."""
    out = {(lanes, NPASS): run(lanes) for lanes in LANES_SWEEP}
    out.update({(4096, npass): run(4096, npass) for npass in NPASS_SWEEP})
    return out


def sweep_modes() -> dict:
    """The tool's ``modes`` sweep at 4096 lanes; {mode: seconds}."""
    return {mode: run2(mode) for mode in MODES}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    _cuda()
    print(torch.cuda.get_device_name(0), flush=True)
    if argv and argv[0] == "modes":
        sweep_modes()
    else:
        sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
