"""Logging (counterpart of bem_tpu/utils/logger.py): the root logger with its
optional file, windowed timers, the train-progress line with its ETA, and
the tensorboardX / wandb loggers, which return None with a warning where
their package is absent."""

from __future__ import annotations

import datetime
import logging
import time

initialized_logger = {}


def get_root_logger(log_level=logging.INFO, log_file=None):
    """A stream logger, set up once per name (logger.py:22; one process, so
    rank 0). A ``log_file`` replaces the logger's earlier file, where
    bem_tpu keeps only the first: each CLI run in a process logs to its own."""
    logger_name = "bem_tpu_torch"
    logger = logging.getLogger(logger_name)
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    if logger_name not in initialized_logger:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.propagate = False
        logger.setLevel(log_level)
        initialized_logger[logger_name] = True
    if log_file is not None:
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        fh = logging.FileHandler(log_file, "w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class AvgTimer:
    """Seconds between ``start`` / ``record`` calls, averaged over a window
    of ``window`` records (logger.py:49)."""

    def __init__(self, window: int = 200):
        self.window = window
        self.current_time = 0.0
        self.total_time = 0.0
        self.count = 0
        self.avg_time = 0.0
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self):
        return self.current_time

    def get_avg_time(self):
        return self.avg_time


class MessageLogger:
    """The train-progress line: epoch, iter, learning rates, ETA, times and
    losses (logger.py:79); scalars also to tensorboard when it is on."""

    def __init__(self, opt, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt["name"]
        self.start_iter = start_iter
        self.max_iters = opt["train"]["total_iter"]
        self.use_tb_logger = opt["logger"].get("use_tb_logger", False)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def reset_start_time(self):
        self.start_time = time.time()

    def __call__(self, log_vars: dict):
        epoch = log_vars.pop("epoch")
        current_iter = log_vars.pop("iter")
        lrs = log_vars.pop("lrs")
        message = f"[{self.exp_name[:5]}..][epoch:{epoch:3d}, iter:{current_iter:8,d}, lr:("
        message += ", ".join(f"{lr:.3e}" for lr in lrs) + ")] "
        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time")
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(current_iter - self.start_iter + 1, 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += f"[eta: {eta_str}, time (data): {iter_time:.3f} ({data_time:.3f})] "
        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            if self.tb_logger and self.use_tb_logger:
                self.tb_logger.add_scalar(f"losses/{k}" if k.startswith("l_") else k, v,
                                          current_iter)
        self.logger.info(message)


def init_tb_logger(log_dir: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        get_root_logger().warning("tensorboardX unavailable; skipping the tensorboard logger.")
        return None
    return SummaryWriter(log_dir=log_dir)


def init_wandb_logger(opt):
    try:
        import wandb
    except ImportError:
        get_root_logger().warning("wandb unavailable; skipping wandb logger.")
        return None
    project = opt["logger"]["wandb"]["project"]
    resume_id = opt["logger"]["wandb"].get("resume_id")
    kwargs = dict(id=resume_id, resume="allow") if resume_id else {}
    wandb.init(project=project, name=opt["name"], sync_tensorboard=True, **kwargs)
    return None
