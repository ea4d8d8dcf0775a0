"""What the ``bem::`` operators' dispatch costs a train step and a request.

    python -m bem_tpu_torch.tools.op_dispatch_ab [--rounds N]

In one process on one card, times the IE and CG train steps at the LOLv1
options (IE: batch 8, 128x128; CG: batch 8, 8x8) and one request of the
flagship serving pipeline (K=16, NIMG=2, 400x600, bf16) two ways in turns:
through the kernel rows' ``bem::`` operators, as the port runs, and with
each operator's CUDA implementation called directly in its place (the
wrappers' module globals swapped), which is the route before the rows
became operators. Each round runs one step (or request) each way, the
order alternating from round to round. Also counts the operator calls a
step and a request make, and checks that both ways give the same outputs.
Prints per path the medians of both ways, their difference, the
difference per operator call, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import time

import torch

from ..enhancement.pipeline import build_pipeline, padded_size
from ..models import build_model
from ..ops import gdmlp_fused, scan, scan_fused, ss2d_fused, ss2d_seq, ss2d_tail
from ..options import lolv1_options
from ..profile_train import card_setup
from ..train import synthetic_batch

# (module, global the wrapper calls, the operator's CUDA implementation)
ROUTES = ((gdmlp_fused, "_stem_op", gdmlp_fused._stem_cuda),
          (gdmlp_fused, "_gdmlp_op", gdmlp_fused._gdmlp_cuda),
          (ss2d_seq, "_seq_pair_op", ss2d_seq._seq_pair_cuda),
          (ss2d_seq, "_col_sum_op", ss2d_seq._col_sum_cuda),
          (ss2d_seq, "_col_dir_op", ss2d_seq._col_dir_cuda),
          (ss2d_tail, "_tail_op", ss2d_tail._tail_cuda),
          (scan, "_run", scan.scan_cuda),
          (ss2d_fused, "_fwd_op", ss2d_fused._fwd_cuda),
          (scan_fused, "_run", scan_fused._scan_cuda))


@contextlib.contextmanager
def direct(count=None):
    """The wrappers call the operators' CUDA implementations directly;
    with ``count`` (a dict), each call adds one to ``count["calls"]``."""
    saved = [getattr(m, g) for m, g, _ in ROUTES]

    def counted(impl):
        def call(*args):
            count["calls"] += 1
            return impl(*args)
        return call

    try:
        for m, g, impl in ROUTES:
            setattr(m, g, impl if count is None else counted(impl))
        yield
    finally:
        for (m, g, _), op in zip(ROUTES, saved):
            setattr(m, g, op)


def timed_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def ab(card, what, step, rounds):
    """Counts one ``step()``'s operator calls, then times ``rounds`` rounds
    of one step each way."""
    count = {"calls": 0}
    with direct(count):
        step()
    times = {"operators": [], "direct": []}
    for r in range(rounds):
        for way in (("operators", "direct") if r % 2 == 0 else ("direct", "operators")):
            with direct() if way == "direct" else contextlib.nullcontext():
                times[way].append(timed_ms(step))
    med = {w: statistics.median(t) for w, t in times.items()}
    diff = med["operators"] - med["direct"]
    print(f"{what}: {count['calls']} operator calls; median {med['operators']:.2f} ms through "
          f"the operators (runs {[round(t, 2) for t in times['operators']]}), "
          f"{med['direct']:.2f} ms direct (runs {[round(t, 2) for t in times['direct']]}), "
          f"difference {diff:.2f} ms ({100 * diff / med['direct']:.2f} %), "
          f"{1e3 * diff / max(count['calls'], 1):.2f} us a call ({card})", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=12)
    args = p.parse_args(argv)
    card = card_setup("op_dispatch_ab")
    for mt in ("ImageEnhancer", "ConditionGenerator"):
        opt = dict(lolv1_options(mt), is_train=True)
        model = build_model(opt, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        batch = synthetic_batch(opt, gen)
        model.train_step(batch)  # warm-up, both ways
        with direct():
            model.train_step(batch)
        ab(card, f"{mt} train step", lambda: model.train_step(batch), args.rounds)
        del model
        torch.cuda.empty_cache()

    nimg, K, H, W = 2, 16, 400, 600
    pipe = build_pipeline(nimg=nimg, K=K, device="cuda", dtype=torch.bfloat16, seed=0, H=H, W=W)
    g = torch.Generator(device="cuda").manual_seed(0)
    Hp, Wp = padded_size(H, W)
    img = torch.rand((nimg, Hp, Wp, 3), generator=g, device="cuda").to(torch.bfloat16)
    cond = torch.rand((nimg, Hp // 16, Wp // 16, 3), generator=g, device="cuda").to(torch.bfloat16)
    request = lambda: pipe(torch.Generator(device="cuda").manual_seed(100), img, cond)  # noqa: E731
    want = request()
    with direct():
        got = request()
    same = all(torch.equal(a, b) for a, b in zip(want, got))
    print(f"serving request: direct and operator outputs equal: {same}", flush=True)
    if not same:
        raise AssertionError("the direct route's request differs from the operators'")
    ab(card, f"serving request K={K} NIMG={nimg} {H}x{W} bf16", request, args.rounds)


if __name__ == "__main__":
    main()
