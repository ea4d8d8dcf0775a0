"""The VMamba classification harness: training, evaluation, throughput,
and its command line.

Counterpart of bem_tpu/classification/train.py (reference
basicsr/vmamba/main.py): cross-entropy with label smoothing, the optax chain
``clip_by_global_norm(5) -> adamw(warmup_cosine_decay_schedule(0, lr,
warmup, total), weight_decay)`` (:class:`..models.base_model.AdamWChain`
reproduces it), drop-path and SSM dropout drawn from the trainer's generator, top-1 / top-5
evaluation and the bf16 throughput probe. Data is any iterable of
``(images NHWC, labels)``: the ImageFolder loader of :mod:`.data` or
:func:`synthetic_batch`'s seeded batches of the configured shapes. As in
bem_tpu, the loader reports ``mixup_active`` and nothing applies mixup.

    python -m bem_tpu_torch.classification.train --cfg MODEL.yaml \
        --data-path ROOT [--batch-size N] [--opts KEY VALUE ...] \
        [--eval | --throughput] [--device cuda|cpu]

takes bem_tpu's arguments (``parse_option``) plus ``--device``: the card
by default (a missing card raises at once), ``cpu`` for the plain
versions. The model lives on that device; the trainer updates its
parameters in place.
"""

from __future__ import annotations

import argparse
import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F

from ..models.base_model import AdamWChain, global_norm
from ..nn import init
from ..nn.vssm import VSSM
from ..utils.logger import get_root_logger
from .config import get_config
from .data import build_loader

def cross_entropy(logits, labels, smoothing: float = 0.1):
    """Mean cross-entropy against one-hot labels smoothed by ``smoothing``."""
    n = logits.shape[-1]
    soft = F.one_hot(labels.long(), n).to(logits.dtype) * (1 - smoothing) + smoothing / n
    return -(soft * F.log_softmax(logits, -1)).sum(-1).mean()


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule: linear from init to peak over
    ``warmup_steps``, then cosine to ``end_value`` at ``decay_steps``; in
    float32, as optax computes it."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps ({decay_steps}, "
                         f"{warmup_steps})")
    f = np.float32
    alpha = f(0.0 if peak_value == 0.0 else end_value / peak_value)
    span = decay_steps - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = f(1) - f(min(max(step, 0), warmup_steps)) / f(warmup_steps)
            return float(f(init_value - peak_value) * frac + f(peak_value))
        t = f(min(step - warmup_steps, span))
        cosine = f(0.5) * (f(1) + np.cos(f(math.pi) * t / f(span)))
        return float(f(peak_value) * ((f(1) - alpha) * cosine + alpha))

    return schedule


@dataclass
class ClsTrainState:
    """The model (updated in place), its optimizer and drop-path generator."""

    model: VSSM
    optimizer: AdamWChain
    gen: torch.Generator
    label_smoothing: float
    step: int = 0
    logs: dict = field(default_factory=dict)
    timing: dict = field(default_factory=dict)

    @property
    def device(self):
        return self.gen.device


def make_trainer(model: VSSM, total_steps: int, base_lr: float = 1e-3, warmup_steps: int = 0,
                 weight_decay: float = 0.05, label_smoothing: float = 0.1, seed: int = 0,
                 device="cuda"):
    """(state, train_step, eval_step) as bem_tpu's make_trainer
    (train.py:41-81), for an already initialized ``model``, moved to
    ``device``. train_step(state, images, labels) -> (state, loss); the
    step's grad_norm and lr land in ``state.logs``. eval_step(state, images,
    labels) -> (top1, top5) fractions of the batch."""
    device = torch.device(device)
    model.to(device)
    params = dict(model.named_parameters())
    schedule = warmup_cosine_decay_schedule(0.0, base_lr, max(warmup_steps, 1),
                                            max(total_steps, 2))
    opt = AdamWChain(params, schedule, weight_decay=weight_decay, max_norm=5.0)
    state = ClsTrainState(model, opt, torch.Generator(device=device).manual_seed(seed),
                          label_smoothing)

    def train_step(state: ClsTrainState, images, labels):
        images = torch.as_tensor(images).to(state.device, torch.float32)
        labels = torch.as_tensor(labels).to(state.device)
        model.train()
        loss = cross_entropy(model(images, gen=state.gen), labels, state.label_smoothing)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        state.logs = {"grad_norm": global_norm(grads.values()).detach(),
                      "lr": state.optimizer.step(params, grads)}
        state.step += 1
        return state, loss.detach()

    @torch.no_grad()
    def eval_step(state: ClsTrainState, images, labels):
        images = torch.as_tensor(images).to(state.device, torch.float32)
        labels = torch.as_tensor(labels).to(state.device)
        model.eval()
        logits = model(images)
        top1 = (logits.argmax(-1) == labels).float().mean()
        top5 = (logits.topk(5, -1).indices == labels[:, None]).any(-1).float().mean()
        return top1, top5

    return state, train_step, eval_step


def train_one_epoch(state, train_step, loader: Iterable, log_every: int = 50, log=print):
    """One pass over ``loader``; the mean loss. ``state.timing`` gets each
    step's seconds waiting on the loader (``data_time``) and in the step
    up to its loss on the host (``step_time``)."""
    losses, data_time, step_time = [], [], []
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        t1 = time.perf_counter()
        state, loss = train_step(state, *batch)
        losses.append(float(loss))
        data_time.append(t1 - t0)
        step_time.append(time.perf_counter() - t1)
        if (len(losses) - 1) % log_every == 0:
            log(f"step {state.step} loss {losses[-1]:.4f}")
    state.timing = {"data_time": data_time, "step_time": step_time}
    return state, float(np.mean(losses))


def validate(state, eval_step, loader: Iterable):
    t1s, t5s = [], []
    for images, labels in loader:
        t1, t5 = eval_step(state, images, labels)
        t1s.append(float(t1))
        t5s.append(float(t5))
    return float(np.mean(t1s)), float(np.mean(t5s))


@torch.no_grad()
def throughput(model: VSSM, batch: int = 64, size: int = 224, iters: int = 10,
               device="cuda") -> float:
    """images/s of the forward on a bf16 batch with fp32 parameters
    (train.py:104-114), after one warm-up call; each call ends in a
    host read of the logits' sum, as bem_tpu's does."""
    model.to(device).eval()
    x = torch.from_numpy(np.random.default_rng(0).random((batch, size, size, 3))).to(
        device, torch.bfloat16)
    float(model(x).float().sum())
    t0 = time.perf_counter()
    for _ in range(iters):
        float(model(x).float().sum())
    return batch * iters / (time.perf_counter() - t0)


def build_model_from_config(config, gen=None) -> VSSM:
    """MODEL.VSSM config subtree -> VSSM, every field bem_tpu passes
    (train.py:122-149), its weights drawn from ``gen`` (a CPU generator;
    seed 0 when None)."""
    v = config.MODEL.VSSM
    model = VSSM(
        patch_size=v.PATCH_SIZE, in_chans=v.IN_CHANS, num_classes=config.MODEL.NUM_CLASSES,
        depths=tuple(v.DEPTHS), dims=v.EMBED_DIM, ssm_d_state=v.SSM_D_STATE,
        ssm_ratio=v.SSM_RATIO, ssm_dt_rank=v.SSM_DT_RANK, ssm_conv=v.SSM_CONV,
        ssm_conv_bias=v.SSM_CONV_BIAS, ssm_drop_rate=v.SSM_DROP_RATE, ssm_init=v.SSM_INIT,
        forward_type=v.SSM_FORWARDTYPE, mlp_ratio=v.MLP_RATIO, mlp_drop_rate=v.MLP_DROP_RATE,
        gmlp=v.GMLP, drop_path_rate=config.MODEL.DROP_PATH_RATE, patch_norm=v.PATCH_NORM,
        downsample_version=v.DOWNSAMPLE, patchembed_version=v.PATCHEMBED,
        posembed=v.POSEMBED, imgsize=config.DATA.IMG_SIZE)
    return init.initialize(model, gen if gen is not None else torch.Generator().manual_seed(0))


def synthetic_batch(config, gen: torch.Generator, batch_size=None):
    """Uniform [0, 1) NHWC images (B, IMG_SIZE, IMG_SIZE, IN_CHANS) and
    uniform labels in [0, NUM_CLASSES), drawn from ``gen`` on its device."""
    B = batch_size or config.DATA.BATCH_SIZE
    S = config.DATA.IMG_SIZE
    images = torch.rand((B, S, S, config.MODEL.VSSM.IN_CHANS), generator=gen, device=gen.device)
    labels = torch.randint(0, config.MODEL.NUM_CLASSES, (B,), generator=gen, device=gen.device)
    return images, labels


# ---------------------------------------------------------------------------
# The command line (train.py:152-217; vmamba/main.py parse_option + main)
# ---------------------------------------------------------------------------


def parse_option(args_list=None):
    """bem_tpu's fifteen arguments plus ``--device`` -> (args, config)."""
    p = argparse.ArgumentParser("VMamba classification", add_help=True)
    p.add_argument("--cfg", type=str, metavar="FILE", help="path to config yaml")
    p.add_argument("--opts", nargs="+", default=None, help="KEY VALUE override pairs")
    p.add_argument("--batch-size", dest="batch_size", type=int)
    p.add_argument("--data-path", dest="data_path", type=str)
    p.add_argument("--zip", action="store_true")
    p.add_argument("--cache-mode", dest="cache_mode", type=str)
    p.add_argument("--pretrained", type=str)
    p.add_argument("--resume", type=str)
    p.add_argument("--accumulation-steps", dest="accumulation_steps", type=int)
    p.add_argument("--use-checkpoint", dest="use_checkpoint", action="store_true")
    p.add_argument("--disable_amp", action="store_true")
    p.add_argument("--output", type=str)
    p.add_argument("--tag", type=str)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--throughput", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu (the kernels' plain versions)")
    args = p.parse_args(args_list)
    return args, get_config(args)


def main(args_list=None):
    """bem_tpu's main (train.py:181-217): the model from the config with
    weights drawn from ``Generator().manual_seed(SEED)``; throughput mode
    -> images/s; eval mode -> (top1, top5) over the validation folder;
    else the epochs (train, then validate) -> the state. Each epoch logs
    its loss, accuracies, median step and data times and, on a card, the
    peak memory."""
    args, config = parse_option(args_list)
    logger = get_root_logger()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (--device cpu runs the plain versions)")
    model = build_model_from_config(config, torch.Generator().manual_seed(config.SEED))
    if config.THROUGHPUT_MODE:
        ips = throughput(model, batch=config.DATA.BATCH_SIZE, size=config.DATA.IMG_SIZE,
                         device=device)
        logger.info(f"throughput: {ips:.1f} images/s")
        return ips
    _, _, loader_train, loader_val, _ = build_loader(config)
    steps_per_epoch = max(len(loader_train), 1)
    state, train_step, eval_step = make_trainer(
        model, total_steps=config.TRAIN.EPOCHS * steps_per_epoch, base_lr=config.TRAIN.BASE_LR,
        warmup_steps=config.TRAIN.WARMUP_EPOCHS * steps_per_epoch,
        weight_decay=config.TRAIN.WEIGHT_DECAY, label_smoothing=config.MODEL.LABEL_SMOOTHING,
        seed=config.SEED, device=device)
    if config.EVAL_MODE:
        t1, t5 = validate(state, eval_step, loader_val)
        logger.info(f"eval top1 {t1:.4f} top5 {t5:.4f}")
        return t1, t5
    for epoch in range(config.TRAIN.START_EPOCH, config.TRAIN.EPOCHS):
        loader_train.set_epoch(epoch)
        state, loss = train_one_epoch(state, train_step, loader_train, log=logger.info)
        t1, t5 = validate(state, eval_step, loader_val)
        logger.info(f"epoch {epoch}: loss {loss:.4f} top1 {t1:.4f} top5 {t5:.4f}")
        mem = (f", peak memory {torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB"
               if device.type == "cuda" else "")
        logger.info(f"epoch {epoch}: {len(state.timing['step_time'])} steps, median step "
                    f"{1e3 * statistics.median(state.timing['step_time']):.1f} ms, data_time "
                    f"{1e3 * statistics.median(state.timing['data_time']):.1f} ms{mem}")
    return state


if __name__ == "__main__":
    main()
