"""Experiment directories and resume paths (counterpart of
bem_tpu/utils/misc.py)."""

from __future__ import annotations

import os
import time
from os import path as osp


def get_time_str():
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str):
    """Rename an existing ``path`` with a timestamp suffix, then create it
    (misc.py:14)."""
    if osp.exists(path):
        new_name = path + "_archived_" + get_time_str()
        print(f"Path already exists. Rename it to {new_name}", flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt):
    """experiments_root (training) or results_root (testing), archived if it
    exists, and the other directories of ``opt['path']`` (misc.py:23)."""
    path_opt = dict(opt["path"])
    mkdir_and_rename(path_opt.pop("experiments_root" if opt.get("is_train")
                                  else "results_root"))
    for key, p in path_opt.items():
        if ("strict_load" in key or "pretrain_network" in key or "resume" in key
                or "param_key" in key):
            continue
        if isinstance(p, str):
            os.makedirs(p, exist_ok=True)


def check_resume(opt, resume_iter: int):
    """Point every ``pretrain_network_*`` path at the resumed iteration's
    network file (misc.py:38)."""
    if opt["path"].get("resume_state"):
        for key in list(opt["path"].keys()):
            if key.startswith("pretrain_network"):
                name = key.replace("pretrain_network_", "")
                opt["path"][key] = osp.join(opt["path"]["models"],
                                            f"net_{name}_{resume_iter}.msgpack")
