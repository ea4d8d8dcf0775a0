"""The training CLI (counterpart of bem_tpu/train.py):

    python -m bem_tpu_torch.train --opt Options/<cfg>.yml [--auto_resume] [--debug]
        [--force_yml key:sub=value ...] [--device cuda|cpu]

``train_pipeline`` reads the options, makes the experiment's directories
(or takes up the latest training state with ``--auto_resume``), builds the
datasets, the threaded loader and the trainer on the device, and runs
``train``: a step per batch, the progress line every ``print_freq``
steps, checkpoints every ``save_checkpoint_freq``, validation every
``val_freq`` (with the best PSNR's network file), then a last save and
validation. As in bem_tpu, ``path.pretrain_network_g`` is not read here
(the test CLI reads it). :func:`synthetic_batch` makes seeded batches with
the LOLv1 training shapes.
"""

from __future__ import annotations

import datetime
import logging
import math
import time
from os import path as osp
from typing import Callable, Dict, Iterable, Optional

import torch

from .data import CPUPrefetcher, DevicePrefetcher, EnlargedSampler, build_dataloader, build_dataset
from .models import build_model
from .utils.checkpoint import find_latest_state
from .utils.img_util import imwrite, tensor2img
from .utils.logger import (AvgTimer, MessageLogger, get_root_logger, init_tb_logger,
                           init_wandb_logger)
from .utils.misc import make_exp_dirs, mkdir_and_rename
from .utils.options import copy_opt_file, parse_options


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
          log: Callable[[str], None] = print,
          after_step: Optional[Callable[[dict], None]] = None):
    """Run ``model.train_step`` on each batch. ``after_step(logs)``, when
    given, runs after every step and does the logging (the train CLI's
    progress line, checkpoints, validation); else every ``print_freq`` steps
    (the options' ``logger.print_freq`` by default) log iter, lr, the mean
    step time and the scalar logs. Returns the last step's logs."""
    print_freq = print_freq or model.opt["logger"]["print_freq"]
    logs, t0 = {}, time.perf_counter()
    for batch in batches:
        logs = model.train_step(batch)
        if after_step is not None:
            after_step(logs)
        elif model.step % print_freq == 0:
            vals = {k: float(v) for k, v in logs.items()}
            dt = (time.perf_counter() - t0) / print_freq
            log(f"iter {model.step} lr {vals.pop('lr'):.3e} time {dt:.4f} s/step "
                + " ".join(f"{k} {v:.4e}" for k, v in vals.items()))
            t0 = time.perf_counter()
    return logs


def init_tb_loggers(opt):
    if (opt["logger"].get("wandb") is not None
            and opt["logger"]["wandb"].get("project") is not None
            and "debug" not in opt["name"]):
        init_wandb_logger(opt)
    if opt["logger"].get("use_tb_logger") and "debug" not in opt["name"]:
        return init_tb_logger(log_dir=osp.join(opt["root_path"], "tb_logger", opt["name"]))
    return None


def create_train_val_dataloader(opt, logger):
    """The train loader (EnlargedSampler, threads, drop_last) and the val
    loaders (bem_tpu/train.py:49)."""
    train_loader, train_sampler, val_loaders = None, None, []
    total_epochs = total_iters = 0
    for phase, dataset_opt in opt["datasets"].items():
        if phase == "train":
            enlarge = dataset_opt.get("dataset_enlarge_ratio", 1)
            train_set = build_dataset(dataset_opt)
            train_sampler = EnlargedSampler(len(train_set), opt["world_size"], opt["rank"],
                                            enlarge, seed=opt.get("manual_seed") or 0)
            train_loader = build_dataloader(train_set, dataset_opt, num_gpu=opt.get("num_gpu", 1),
                                            dist=opt["dist"], sampler=train_sampler,
                                            seed=opt["manual_seed"])
            if len(train_loader) == 0:
                raise ValueError(f"{dataset_opt['name']}: {len(train_set)} images x "
                                 f"dataset_enlarge_ratio {enlarge} make no full batch of "
                                 f"{dataset_opt['batch_size_per_gpu']}")
            num_iter_per_epoch = math.ceil(len(train_set) * enlarge / (
                dataset_opt["batch_size_per_gpu"] * opt["world_size"]))
            total_iters = int(opt["train"]["total_iter"])
            total_epochs = math.ceil(total_iters / num_iter_per_epoch)
            logger.info("Training statistics:"
                        f"\n\tNumber of train images: {len(train_set)}"
                        f"\n\tBatch size per gpu: {dataset_opt['batch_size_per_gpu']}"
                        f"\n\tWorld size: {opt['world_size']}"
                        f"\n\tRequire iter per epoch: {num_iter_per_epoch}"
                        f"\n\tTotal epochs: {total_epochs}; iters: {total_iters}.")
        elif phase.split("_")[0] == "val":
            val_set = build_dataset(dataset_opt)
            val_loaders.append(build_dataloader(val_set, dataset_opt,
                                                num_gpu=opt.get("num_gpu", 1), dist=opt["dist"],
                                                seed=opt["manual_seed"]))
            logger.info(f"Number of val images in {dataset_opt['name']}: {len(val_set)}")
        else:
            raise ValueError(f"Dataset phase {phase} is not recognized.")
    return train_loader, train_sampler, val_loaders, total_epochs, total_iters


def train_pipeline(root_path, args_list=None):
    """The train CLI (bem_tpu/train.py:92). Returns the trainer; its
    ``timings`` hold each step's (iter, logged time, data_time, wall)."""
    opt, args = parse_options(root_path, is_train=True, args_list=args_list)
    opt["root_path"] = root_path
    resume_state_path = None
    if opt.get("auto_resume"):
        resume_state_path = find_latest_state(opt["path"]["training_states"])
    elif opt["path"].get("resume_state"):
        resume_state_path = opt["path"]["resume_state"]
    if resume_state_path is None:
        make_exp_dirs(opt)
        if opt["logger"].get("use_tb_logger") and "debug" not in opt["name"]:
            mkdir_and_rename(osp.join(opt["root_path"], "tb_logger", opt["name"]))
    copy_opt_file(args.opt, opt["path"]["experiments_root"])

    log_file = osp.join(opt["path"]["log"], f"train_{opt['name']}_{int(time.time())}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    tb_logger = init_tb_loggers(opt)
    train_loader, _, val_loaders, _, total_iters = create_train_val_dataloader(opt, logger)

    model = build_model(opt, device=opt["device"])
    # bem_tpu draws an example batch to initialise its params; the port's
    # weights come from manual_seed, but it draws the batch too, so that a
    # seeded dataset goes on to yield bem_tpu's crops and flips
    next(iter(train_loader))
    start_epoch = current_iter = 0
    best_metric = {"iter": 0, "psnr": 0.0}
    if resume_state_path:
        model.resume_training(resume_state_path)
        current_iter = model.step
        start_epoch = current_iter // max(len(train_loader), 1)
        logger.info(f"Resuming training from epoch: {start_epoch}, iter: {current_iter}.")
    msg_logger = MessageLogger(opt, current_iter, tb_logger)
    if opt["datasets"]["train"].get("prefetch_mode") == "device":
        prefetcher = DevicePrefetcher(train_loader, opt["device"])
    else:
        prefetcher = CPUPrefetcher(train_loader)

    logger.info(f"Start training from epoch: {start_epoch}, iter: {current_iter}")
    data_timer, iter_timer = AvgTimer(), AvgTimer()
    start_time = time.time()
    at = {"iter": current_iter, "epoch": start_epoch}
    model.timings = []
    val_opt = opt.get("val")

    def batches():
        while at["iter"] <= total_iters:
            train_loader.set_epoch(at["epoch"])
            prefetcher.reset()
            train_data = prefetcher.next()
            while train_data is not None:
                data_timer.record()
                at["iter"] += 1
                if at["iter"] > total_iters:
                    break
                yield train_data
                data_timer.start()
                iter_timer.start()
                train_data = prefetcher.next()
            at["epoch"] += 1

    def after_step(log_vars):
        nonlocal best_metric
        current_iter, epoch = at["iter"], at["epoch"]
        iter_timer.record()
        if current_iter == 1:
            msg_logger.reset_start_time()
        if current_iter % opt["logger"]["print_freq"] == 0:
            log_vars = dict(log_vars)
            logs = {"epoch": epoch, "iter": current_iter, "lrs": [float(log_vars.pop("lr", 0.0))],
                    "time": iter_timer.get_avg_time(), "data_time": data_timer.get_avg_time()}
            logs.update({k: float(v) for k, v in log_vars.items()})
            msg_logger(logs)
            if tb_logger is not None:
                for tag, val in model.sigma_logs().items():
                    tb_logger.add_scalar(tag, val, current_iter)
        # wall: the whole iteration up to here (a printed step has waited
        # for the device to read its losses)
        model.timings.append((current_iter, iter_timer.get_current_time(),
                              data_timer.get_current_time(), time.time() - iter_timer.start_time))
        if current_iter % 100 == 0 and model.last_visuals:
            vis_dir = opt["path"].get("visualization", ".")
            for name, arr in model.last_visuals.items():
                imwrite(tensor2img(arr.float().cpu().numpy(), rgb2bgr=False),
                        osp.join(vis_dir, "train.png" if name == "pred" else f"train_{name}.png"))
        if current_iter % opt["logger"]["save_checkpoint_freq"] == 0:
            logger.info("Saving models and training states.")
            model.save(epoch, current_iter, best_metric=best_metric)
        if val_opt is not None and current_iter % int(val_opt["val_freq"]) == 0:
            for val_loader in val_loaders:
                psnr = model.validation(val_loader, current_iter, tb_logger,
                                        val_opt.get("save_img", False), val_opt.get("rgb2bgr", True),
                                        val_opt.get("use_image", True))
                if psnr and psnr > best_metric["psnr"]:
                    best_metric = {"psnr": float(psnr), "iter": current_iter}
                    model.save_best(best_metric)
                    logger.info(f"New best PSNR {psnr:.4f} @ iter {current_iter}")

    train(model, batches(), after_step=after_step)
    current_iter = at["iter"]
    logger.info("End of training. Time consumed: "
                f"{datetime.timedelta(seconds=int(time.time() - start_time))}")
    logger.info("Save the latest model.")
    model.save(epoch=-1, current_iter=current_iter)
    if val_opt is not None:
        for val_loader in val_loaders:
            model.validation(val_loader, current_iter, tb_logger, val_opt.get("save_img", False))
    if tb_logger:
        tb_logger.close()
    return model


if __name__ == "__main__":
    train_pipeline(osp.abspath("."))
