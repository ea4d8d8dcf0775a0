"""The QD decomposition trainer (counterpart of bem_tpu/qd/train.py):

    python -m bem_tpu_torch.qd.train --model_type model4 --low_dir ... --high_dir ...
        [--val_low_dir ... --val_high_dir ...] [--device cuda|cpu]

AdamW 3e-4 with weight decay 0.01 and no clip (the port's ``AdamWChain``,
optax.adamw's update); the learning rate is constant through the first
``warmup_epochs`` epochs, then a cosine to ``lr_min``, stepped per epoch with
a one-epoch phase shift (:func:`make_schedule`); the first
``recon_only_epochs`` epochs minimise the reconstruction terms only, then
the extended Retinex loss. Each epoch appends {epoch, loss[, recon_psnr,
recon_ssim]} to ``history.jsonl`` (the validation's reconstruction PSNR /
SSIM of the Hamilton product) and writes ``<model_type>_<epoch>.msgpack``,
the flax params tree that both packages' ``Decomp`` read.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..convert import state_dict_to_flax
from ..data import DataLoader
from ..metrics.psnr_ssim import calculate_psnr_torch, calculate_ssim_torch
from ..models.base_model import AdamWChain
from ..nn.init import initialize
from ..ops.quaternion import hamilton_product
from ..utils.checkpoint import msgpack_serialize
from ..utils.logger import get_root_logger
from .dataset import PairDataset
from .loss import RetinexLoss
from .models import Decomp


def make_schedule(base_lr: float, total_epochs: int, steps_per_epoch: int,
                  warmup_epochs: int = 10, lr_min: float = 1e-7):
    """lr of update ``step``: epoch e = step // steps_per_epoch + 1 (the
    scheduler steps once before the first epoch), constant base_lr while
    e <= warmup_epochs, then a cosine over T = total - warmup epochs."""
    t_max = max(total_epochs - warmup_epochs, 1)

    def sched(step):
        epoch = step // steps_per_epoch + 1
        cos_t = min(max(epoch - warmup_epochs, 0), t_max)
        return lr_min + (base_lr - lr_min) * 0.5 * (1.0 + math.cos(math.pi * cos_t / t_max))

    return sched


def _nchw(x, device) -> torch.Tensor:
    """(B, H, W, 3) numpy or tensor -> fp32 (B, 3, H, W) on ``device``."""
    return torch.as_tensor(x, device=device).float().permute(0, 3, 1, 2)


class QDTrainer:
    """A ``Decomp`` (seeded init, or ``net``), its optimizer and loss."""

    def __init__(self, model_type: str, schedule, device="cuda", seed: int = 0,
                 net: Optional[torch.nn.Module] = None):
        self.device = torch.device(device)
        if net is None:
            net = initialize(Decomp(model_type), torch.Generator().manual_seed(seed))
        self.net = net.to(self.device)
        self.params = dict(self.net.named_parameters())
        self.optimizer = AdamWChain(self.params, schedule, weight_decay=0.01)
        self.criterion = RetinexLoss(extended=True)
        self.step = 0

    def train_step(self, low, high, recon_only: bool):
        """One update on a batch of (B, H, W, 3) low / high images; returns
        {loss[, recon_low, freq]}."""
        low, high = _nchw(low, self.device), _nchw(high, self.device)
        q1_low, q2_low = self.net(low)
        q1_high, q2_high = self.net(high)
        if recon_only:
            loss = self.criterion.recon_only(q1_low, q2_low, low, q1_high, q2_high, high)
            aux = {"loss": loss}
        else:
            terms = self.criterion(q1_low, q2_low, low, q1_high, q2_high, high)
            loss = terms["loss_Decom"]
            aux = {"loss": loss, "recon_low": terms["recon_loss_low"], "freq": terms["freq_loss"]}
        names = list(self.params)
        gs = torch.autograd.grad(loss, [self.params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in zip(names, gs)}
        self.optimizer.step(self.params, grads)
        self.step += 1
        return {k: v.detach() for k, v in aux.items()}

    @torch.no_grad()
    def recon_metrics(self, img):
        """Mean PSNR and SSIM of the clipped reconstruction of (B, H, W, 3) ``img``."""
        x = _nchw(img, self.device)
        q1, q2 = self.net(x)
        recon = hamilton_product(q1, q2)[:, 1:].clamp(0.0, 1.0).permute(0, 2, 3, 1)
        x = x.permute(0, 2, 3, 1)
        return (float(calculate_psnr_torch(recon, x).mean()),
                float(calculate_ssim_torch(recon, x).mean()))

    def params_tree(self) -> dict:
        return state_dict_to_flax(self.net)


def train_qd(model_type: str = "model4", low_dir: str = "data/LOLv1/Train/input",
             high_dir: str = "data/LOLv1/Train/target", val_low_dir: str = None,
             val_high_dir: str = None, epochs: int = 1000, batch_size: int = 8,
             patch_size: int = 256, lr: float = 3e-4, recon_only_epochs: int = 50,
             out_dir: str = "experiments/qd", seed: int = 0, num_workers: int = 4,
             log_every: int = 50, save_every: int = 1, device="cuda",
             net: Optional[torch.nn.Module] = None):
    """Train a ``Decomp`` on the pairs of ``low_dir`` / ``high_dir``. Returns
    the trainer (its ``timings`` hold each step's seconds, the batch's
    loading excluded) and the per-epoch history."""
    logger = get_root_logger()
    dataset = PairDataset(low_dir, high_dir, patch_size=patch_size, train=True, seed=seed)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True,
                        num_workers=num_workers, drop_last=True, seed=seed)
    steps_per_epoch = max(len(loader), 1)
    trainer = QDTrainer(model_type, make_schedule(lr, epochs, steps_per_epoch), device, seed, net)
    trainer.timings = []
    os.makedirs(out_dir, exist_ok=True)
    history = []
    val_set = None
    if val_low_dir and val_high_dir:
        val_set = PairDataset(val_low_dir, val_high_dir, train=False)

    for epoch in range(epochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        ep_losses = []
        for i, batch in enumerate(loader):
            t = time.perf_counter()
            aux = trainer.train_step(batch["low"], batch["high"],
                                     recon_only=epoch < recon_only_epochs)
            ep_losses.append(float(aux["loss"]))
            trainer.timings.append(time.perf_counter() - t)
            if i % log_every == 0:
                logger.info(f"epoch {epoch} step {trainer.step} loss {ep_losses[-1]:.4f}")
        rec = {"epoch": epoch, "loss": float(np.mean(ep_losses))}
        if val_set is not None:
            psnrs, ssims = [], []
            for k in range(len(val_set)):
                img = val_set[k]["low"][None]
                h, w = img.shape[1] // 2 * 2, img.shape[2] // 2 * 2
                p, s = trainer.recon_metrics(img[:, :h, :w])
                psnrs.append(p)
                ssims.append(s)
            logger.info(f"epoch {epoch}: recon PSNR {np.mean(psnrs):.2f} SSIM "
                        f"{np.mean(ssims):.4f} ({time.time() - t0:.1f}s)")
            rec["recon_psnr"] = float(np.mean(psnrs))
            rec["recon_ssim"] = float(np.mean(ssims))
        history.append(rec)
        with open(os.path.join(out_dir, "history.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        if (epoch + 1) % save_every == 0 or epoch == epochs - 1:
            with open(os.path.join(out_dir, f"{model_type}_{epoch}.msgpack"), "wb") as f:
                f.write(msgpack_serialize(trainer.params_tree()))
    return trainer, history


def main(args_list=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_type", default="model4",
                   choices=["model1", "model2", "model3", "model4"])
    p.add_argument("--low_dir", required=True)
    p.add_argument("--high_dir", required=True)
    p.add_argument("--val_low_dir")
    p.add_argument("--val_high_dir")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--out_dir", default="experiments/qd")
    p.add_argument("--device", default="cuda")
    return train_qd(**vars(p.parse_args(args_list)))


if __name__ == "__main__":
    main()
