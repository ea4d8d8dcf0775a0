"""Where a VMamba-T train step and a throughput batch spend their time.

The classification harness's defaults (VSSM depths (2,2,9,2), embed 96,
d_state 16, forward_type v2, batch 128, 224x224): two warm-up train steps
(fp32), then one step under torch.profiler; two warm-up bf16 forwards, then
one under the profiler. Prints each one's wall time, the device's busy
share, device time by kernel and the busiest host ops, beside the card's
name and power limit:

    python -m bem_tpu_torch.profile_classify
"""

from __future__ import annotations

import torch

from .classification import build_model_from_config, get_config, make_trainer, synthetic_batch
from .profile_train import card_setup, profiled, report


def main():
    card = card_setup("profile_classify")
    c = get_config()
    model = build_model_from_config(c, torch.Generator().manual_seed(c.SEED))
    state, train_step, _ = make_trainer(model, total_steps=10, base_lr=c.TRAIN.BASE_LR,
                                        warmup_steps=2, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        train_step(state, *synthetic_batch(c, gen))
    batch = synthetic_batch(c, gen)
    wall_ms, prof = profiled(lambda: train_step(state, *batch))
    report(card, f"VMamba-T train step B={c.DATA.BATCH_SIZE} fp32", wall_ms, prof, top=20)
    x = batch[0].to(torch.bfloat16)
    with torch.no_grad():
        for _ in range(2):
            model(x)
        wall_ms, prof = profiled(lambda: model(x))
    report(card, f"VMamba-T throughput batch B={c.DATA.BATCH_SIZE} bf16", wall_ms, prof, top=20)


if __name__ == "__main__":
    main()
