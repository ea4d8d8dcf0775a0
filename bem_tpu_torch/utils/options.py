"""Options files (counterpart of bem_tpu/utils/options.py ``yaml_load``,
``parse`` and ``_expand``), read with :mod:`.yaml_lite`.

``bem_tpu_torch.options.lolv1_options`` stays the LOLv1 training options
as Python dicts; ``parse`` reads any ``Options/*.yml``.
"""

from __future__ import annotations

import os
import random
from os import path as osp
from typing import Any, Dict

import numpy as np

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
