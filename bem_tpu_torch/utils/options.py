"""Options files (counterpart of bem_tpu/utils/options.py ``yaml_load``,
``parse_options``, ``parse``, ``_expand`` and ``copy_opt_file``), read
with :mod:`.yaml_lite`.

``bem_tpu_torch.options.lolv1_options`` stays the LOLv1 training options
as Python dicts; ``parse`` reads any ``Options/*.yml``.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from os import path as osp
from shutil import copyfile
from typing import Any, Dict

import numpy as np
import torch

from .yaml_lite import load


def yaml_load(f: str) -> Dict[str, Any]:
    """A ``.yml`` / ``.yaml`` file's contents, or ``f`` itself as YAML text."""
    if f.endswith((".yml", ".yaml")) and os.path.exists(f):
        with open(f, "r") as fh:
            return load(fh.read(), f)
    return load(f)


def set_random_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)


def _set_nested(opt: Dict, keys, value):
    d = opt
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def parse_options(root_path: str, is_train: bool = True, args_list=None):
    """The CLIs' options (options.py:43): the YAML of ``--opt`` with the
    ``--force_yml key:sub=value`` overrides (values read as YAML), the
    ``--debug`` name and frequencies, the seed, and ``--device`` (cuda by
    default: there is no CPU fallback). One process on one device: rank 0,
    world size 1. Returns (opt, args)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", "--opt", type=str, required=True, help="Path to option YAML file.")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm"], default="none",
                        help="distributed launcher (only 'none' is ported)")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--force_yml", nargs="+", default=None,
                        help="Force to update yml files. Examples: train:ema_decay=0.999")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (the port's kernels) or cpu (their plain versions)")
    args = parser.parse_args(args_list)
    if args.launcher != "none":
        raise NotImplementedError(f"--launcher {args.launcher}: multi-GPU runs are not ported")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; --device cpu runs the "
                           f"plain versions of the kernels")

    opt = yaml_load(args.opt)
    opt["dist"], opt["rank"], opt["world_size"] = False, 0, 1
    opt["device"] = args.device
    seed = opt.get("manual_seed")
    if seed is None:
        seed = opt["manual_seed"] = random.randint(1, 10000)
    set_random_seed(seed + opt["rank"])
    for entry in args.force_yml or ():
        keys, value = entry.replace(" ", "").split("=")
        _set_nested(opt, keys.split(":"), load(value))
    opt["auto_resume"] = args.auto_resume
    opt["is_train"] = is_train
    if args.debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]
    if opt.get("num_gpu") == "auto":
        opt["num_gpu"] = 1
    if opt.get("num_gpu", 1) != 1:
        raise NotImplementedError(f"num_gpu {opt['num_gpu']}: multi-GPU runs are not ported")
    _expand(opt, root_path, is_train)
    if args.debug:
        if "val" in opt:
            opt["val"]["val_freq"] = 8
        opt["logger"]["print_freq"] = 1
        opt["logger"]["save_checkpoint_freq"] = 8
    return opt, args


def parse(opt_path: str, root_path: str = ".", is_train: bool = True) -> Dict[str, Any]:
    """Library-style parse (options.py:220-260), no CLI."""
    opt = yaml_load(opt_path)
    opt.setdefault("dist", False)
    opt.setdefault("rank", 0)
    opt.setdefault("world_size", 1)
    opt["is_train"] = is_train
    if opt.get("manual_seed") is not None:
        set_random_seed(opt["manual_seed"])
    _expand(opt, root_path, is_train)
    return opt


def _expand(opt: Dict[str, Any], root_path: str, is_train: bool):
    """datasets/paths injection (options.py:156-198)."""
    opt["scale"] = opt.get("scale", 1)
    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase.split("_")[0]
        dataset["scale"] = opt["scale"]
        dataset["model_type"] = opt.get("model_type", "ImageEnhancer")
        if "condition" in opt and "condition" not in dataset:
            dataset["condition"] = opt["condition"]
        for key in ("dataroot_gt", "dataroot_lq"):
            if dataset.get(key) is not None:
                dataset[key] = osp.expanduser(dataset[key])

    opt.setdefault("path", {})
    for key, val in opt["path"].items():
        if val is not None and ("resume_state" in key or "pretrain_network" in key):
            opt["path"][key] = osp.expanduser(val)
    if is_train:
        root = osp.join(root_path, "experiments", opt["name"])
        opt["path"].update(experiments_root=root, models=osp.join(root, "models"),
                           training_states=osp.join(root, "training_states"), log=root,
                           visualization=osp.join(root, "visualization"))
    else:
        root = osp.join(root_path, "results", opt["name"])
        opt["path"].update(results_root=root, log=root,
                           visualization=osp.join(root, "visualization"))


def copy_opt_file(opt_file: str, experiments_root: str):
    """Copy the options file into the experiment with a header of the time
    and the command line (options.py:154)."""
    os.makedirs(experiments_root, exist_ok=True)
    filename = osp.join(experiments_root, osp.basename(opt_file))
    copyfile(opt_file, filename)
    with open(filename, "r+") as f:
        lines = f.readlines()
        lines.insert(0, f"# GENERATE TIME: {time.asctime()}\n# CMD:\n# {' '.join(sys.argv)}\n\n")
        f.seek(0)
        f.writelines(lines)
