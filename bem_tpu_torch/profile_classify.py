"""Where a VMamba-T train step and a throughput batch spend their time.

The classification harness's defaults (VSSM depths (2,2,9,2), embed 96,
d_state 16, 224x224) with the given forward type: two warm-up train steps
(fp32), then one step under torch.profiler; two warm-up bf16 forwards at
the config's batch (128), then one under the profiler. Prints each one's
wall time, the device's busy share, device time by kernel and the busiest
host ops, beside the card's name and power limit:

    python -m bem_tpu_torch.profile_classify                       # v2, train batch 128
    python -m bem_tpu_torch.profile_classify --forward-type v052d --train-batch 8

v052d trains at batch 8: its backward recomputes through the unfolded
composition, whose (4 B, d_inner, L, d_state) fp32 tensors would take
19.7 GB each at stage 0 with batch 128.
"""

from __future__ import annotations

import argparse

import torch

from .classification import build_model_from_config, get_config, make_trainer, synthetic_batch
from .profile_train import card_setup, profiled, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forward-type", default="v2")
    ap.add_argument("--train-batch", type=int, default=None,
                    help="batch of the profiled train step (default: the config's)")
    args = ap.parse_args(argv)
    card = card_setup("profile_classify")
    c = get_config()
    c.MODEL.VSSM.SSM_FORWARDTYPE = args.forward_type
    ft = args.forward_type
    model = build_model_from_config(c, torch.Generator().manual_seed(c.SEED))
    state, train_step, _ = make_trainer(model, total_steps=10, base_lr=c.TRAIN.BASE_LR,
                                        warmup_steps=2, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tb = args.train_batch or c.DATA.BATCH_SIZE
    for _ in range(2):
        train_step(state, *synthetic_batch(c, gen, tb))
    batch = synthetic_batch(c, gen, tb)
    wall_ms, prof = profiled(lambda: train_step(state, *batch))
    report(card, f"VMamba-T {ft} train step B={tb} fp32", wall_ms, prof, top=20)
    x = synthetic_batch(c, gen)[0].to(torch.bfloat16)
    with torch.no_grad():
        for _ in range(2):
            model(x)
        wall_ms, prof = profiled(lambda: model(x))
    report(card, f"VMamba-T {ft} throughput batch B={c.DATA.BATCH_SIZE} bf16", wall_ms, prof,
           top=20)


if __name__ == "__main__":
    main()
