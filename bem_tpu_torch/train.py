"""The training loop of bem_tpu/train.py:144-207, over any iterable of batches.

``train(model, batches)`` takes one optimizer step per batch and logs the
learning rate and losses every ``print_freq`` steps. Datasets, the CLI,
checkpoints and validation are not ported yet; :func:`synthetic_batch`
makes seeded batches with the LOLv1 training shapes.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import torch


def synthetic_batch(opt: dict, gen: torch.Generator,
                    batch_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Uniform [0, 1) NHWC images with the shapes of ``opt``'s training set:
    lq / gt (B, gt_size, gt_size, 3) and lq_down / gt_down at 1/scale_down,
    drawn from ``gen`` on its device."""
    ds = opt["datasets"]["train"]
    B = batch_size or ds["batch_size_per_gpu"]
    S = ds["gt_size"]
    s = S // opt["condition"]["scale_down"]
    shapes = {"lq": (B, S, S, 3), "gt": (B, S, S, 3),
              "lq_down": (B, s, s, 3), "gt_down": (B, s, s, 3)}
    return {k: torch.rand(v, generator=gen, device=gen.device) for k, v in shapes.items()}


def train(model, batches: Iterable, print_freq: Optional[int] = None,
          log: Callable[[str], None] = print):
    """Run ``model.train_step`` on each batch; every ``print_freq`` steps
    (the options' ``logger.print_freq`` by default) log iter, lr, the mean
    step time and the scalar logs. Returns the last step's logs."""
    print_freq = print_freq or model.opt["logger"]["print_freq"]
    logs, t0 = {}, time.perf_counter()
    for batch in batches:
        logs = model.train_step(batch)
        if model.step % print_freq == 0:
            vals = {k: float(v) for k, v in logs.items()}
            dt = (time.perf_counter() - t0) / print_freq
            log(f"iter {model.step} lr {vals.pop('lr'):.3e} time {dt:.4f} s/step "
                + " ".join(f"{k} {v:.4e}" for k, v in vals.items()))
            t0 = time.perf_counter()
    return logs
