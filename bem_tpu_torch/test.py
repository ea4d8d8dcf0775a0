"""The test CLI (counterpart of bem_tpu/test.py):

    python -m bem_tpu_torch.test --opt Options/<test cfg>.yml
        [--force_yml path:pretrain_network_g=<net_g file> ...] [--device cuda|cpu]
        [--launcher none|pytorch|slurm|jax] [--local_rank N]

Every dataset of the options is a test set. The trainer is built from
manual_seed, then takes ``path.pretrain_network_g`` (``strict_load_g``,
``param_key``) where it is set, and runs the validation of each test set.
Returns the trainer, its ``metric_results`` those of the last set.
"""

from __future__ import annotations

import logging
import time
from os import path as osp

from .data import build_dataloader, build_dataset
from .models import build_model
from .utils.logger import get_root_logger
from .utils.misc import make_exp_dirs
from .utils.options import parse_options


def test_pipeline(root_path, args_list=None):
    """The test CLI (bem_tpu/test.py:18)."""
    opt, _ = parse_options(root_path, is_train=False, args_list=args_list)
    opt["root_path"] = root_path
    if opt["rank"] == 0:  # under a launcher, rank 0 alone writes and validates
        make_exp_dirs(opt)
    log_file = osp.join(opt["path"]["log"], f"test_{opt['name']}_{int(time.time())}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)

    test_loaders = []
    for _, dataset_opt in sorted(opt["datasets"].items()):
        test_set = build_dataset(dataset_opt)
        test_loaders.append(build_dataloader(test_set, dataset_opt))
        logger.info(f"Number of test images in {dataset_opt['name']}: {len(test_set)}")

    model = build_model(opt, device=opt["device"])
    load_path = opt["path"].get("pretrain_network_g")
    if load_path:
        model.load_network(load_path, opt["path"].get("strict_load_g", True),
                           opt["path"].get("param_key", "params"))
    for test_loader in test_loaders:
        logger.info(f"Testing {test_loader.dataset.opt['name']}...")
        model.validation(test_loader, current_iter=opt["name"], tb_logger=None,
                         save_img=opt["val"].get("save_img", True),
                         rgb2bgr=opt["val"].get("rgb2bgr", True),
                         use_image=opt["val"].get("use_image", True))
    return model


if __name__ == "__main__":
    test_pipeline(osp.abspath("."))
