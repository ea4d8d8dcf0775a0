"""Context-parallel linear scan: one sequence split over the ranks.

Counterpart of bem_tpu/parallel/context.py. Each rank scans its own
chunk of the sequence from a zero state on :func:`..ops.scan.linear_scan`
(kernel 7 on the card), the chunks' boundary summaries ``(prod a, h_last)``
are all-gathered, an exclusive scan over the ranks in rank order gives the
state entering each chunk, and each rank folds it in as
``h_local + prefix * carry_in``, with ``prefix`` the running product of a
over the chunk: bem_tpu's order of operations (context.py:26-46).
Communication is O(D) a sequence per rank, whatever L is.
"""

from __future__ import annotations

import torch

from ..ops.scan import linear_scan
from .mesh import Mesh


def exclusive_carry(decays, ends, reverse: bool = False):
    """The state entering each rank's chunk from ``decays`` / ``ends``, the
    gathered per-rank (prod a, h_last) in rank order: rank r's carry is
    ``decay[r-1] * carry[r-1] + end[r-1]`` from 0 (from the last rank down
    when ``reverse``). Returns the carries in rank order."""
    n = len(decays)
    order = range(n - 1, -1, -1) if reverse else range(n)
    carries = [None] * n
    c = torch.zeros_like(ends[0])
    for r in order:
        carries[r] = c
        c = decays[r] * c + ends[r]
    return carries


def context_parallel_linear_scan(a: torch.Tensor, b: torch.Tensor, mesh: Mesh,
                                 axis: str = "seq") -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` over a sequence whose
    axis -2 is split over the ranks of ``mesh`` (its one axis; ``axis``,
    bem_tpu's choice among several, is not read): a, b are this rank's
    (..., L/n, D) chunk, the chunks concatenated in rank order the whole
    sequence. Returns this rank's chunk of h."""
    h_local = linear_scan(a, b)  # zero-initialized local scan
    prefix = torch.cumprod(a, dim=-2)
    a_prod = prefix[..., -1:, :]
    boundary = h_local[..., -1:, :]
    summaries = mesh.all_gather(torch.stack([a_prod, boundary]))  # one exchange for both
    carry_in = exclusive_carry([t[0] for t in summaries], [t[1] for t in summaries])[mesh.rank]
    return h_local + prefix * carry_in
