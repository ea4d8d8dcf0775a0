"""Serving-artifact export: serialize the inference pipeline with ``torch.export``.

Counterpart of bem_tpu/enhancement/export.py. ``torch.export`` captures the
module's forward as a graph of ATen operators and the port's kernel
operators (``bem::stem_fused``, ``bem::ss2d_seq_pair``, ... : every kernel
row's launch sequence is a ``torch.library`` operator, ops/_common.py) with
its weights, and ``torch.export.save`` writes it to one file. A serving
process loads it and runs it WITHOUT the model-building code: it needs only
the operators, which importing ``bem_tpu_torch.ops`` registers (this
module does). The artifact records its inputs' shapes and dtypes and
refuses others.

The trace runs on fake tensors, so an artifact for the card can be traced
on a machine without its kernels built, except where a net asks the built
library for a plan as a Python int (the column pair's chunk length on the
card); an artifact traced on the CPU runs the plain versions. Data-
dependent Python (NIQE's ``np_cov`` host reading) refuses to trace.

Usage:
    from bem_tpu_torch.enhancement.export import export_pipeline, load_pipeline
    export_pipeline(module, example_args, "/path/pipe.pt2")
    g = load_pipeline("/path/pipe.pt2")   # callable
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn

from .. import ops  # noqa: F401  (registers the bem:: operators a loaded artifact calls)

PLATFORMS = ("cuda", "cpu")


class _Wrapped(nn.Module):
    """A function as a module, so that ``torch.export`` takes it."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _devices(tree) -> set:
    leaves, _ = torch.utils._pytree.tree_flatten(tree)
    return {t.device.type for t in leaves if isinstance(t, torch.Tensor)}


def export_pipeline(fn: Union[nn.Module, Callable], example_args: Sequence, path: str,
                    platforms: Optional[Union[str, Sequence[str]]] = None) -> None:
    """Serialize ``fn(*example_args)`` to ``path``.

    ``fn`` is an ``nn.Module`` or a function (wrapped in one); it is traced
    under ``torch.no_grad()`` at the example arguments' shapes and dtypes.
    ``platforms`` names the device type the example arguments are on
    ("cuda" or "cpu"; a sequence of one); any other value raises, as does
    an example argument on another device. The file is written to
    ``path + ".tmp"`` and moved into place.
    """
    if platforms is not None:
        want = {platforms} if isinstance(platforms, str) else set(platforms)
        if len(want) != 1 or not want <= set(PLATFORMS):
            raise ValueError(f"export_pipeline: platforms {platforms!r}: the port exports "
                             f"for one of {PLATFORMS}")
        have = _devices(example_args)
        if have - want:
            raise ValueError(f"export_pipeline: example arguments on {sorted(have)}, "
                             f"platforms {sorted(want)}")
    module = fn if isinstance(fn, nn.Module) else _Wrapped(fn)
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args), strict=False)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.export.save(program, f)
    os.replace(tmp, path)


def load_pipeline(path: str) -> Callable:
    """Deserialize an exported pipeline; returns the program's callable.
    It runs without the model-building code: the bem:: operators it calls
    are registered by importing ``bem_tpu_torch.ops``, which this module
    does. An input of another shape or dtype than the example's raises."""
    return torch.export.load(path).module()
