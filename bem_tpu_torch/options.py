"""The training options of the LOLv1 protocol as Python dicts.

``lolv1_options("ImageEnhancer" | "ConditionGenerator")`` returns what
``Options/IE_UNet_LOLv1.yml`` / ``Options/CG_UNet_LOLv1.yml`` parse to
(a test holds the two equal), so the port needs no YAML parser.
"""

from __future__ import annotations

import copy

_CONDITION = {"type": "mean", "scale_down": 16, "noise_level": 0.1}


def _dataset(phase: str) -> dict:
    root = "./data/LOLv1/" + ("Train" if phase == "train" else "Test")
    d = {"name": "TrainSet" if phase == "train" else "ValSet",
         "type": "Dataset_PairedImage_Mask",
         "dataroot_gt": root + "/target", "dataroot_lq": root + "/input"}
    if phase == "train":
        d.update({"geometric_augs": True, "condition": dict(_CONDITION),
                  "filename_tmpl": "{}", "io_backend": {"type": "disk"},
                  "use_shuffle": True, "num_worker_per_gpu": 8, "batch_size_per_gpu": 8,
                  "mini_batch_sizes": [8], "iters": [300000], "gt_size": 128,
                  "gt_sizes": [128], "dataset_enlarge_ratio": 1, "prefetch_mode": None})
    else:
        d.update({"condition": dict(_CONDITION), "io_backend": {"type": "disk"}})
    return d


_BASE = {
    "scale": 1, "num_gpu": 1, "manual_seed": 100, "sigma_init": 0.05, "selective": True,
    "condition": _CONDITION,
    "datasets": {"train": _dataset("train"), "val": _dataset("val")},
    "network_g": {"type": "Network", "out_channels": 3, "n_feat": 40,
                  "d_state": [1, 1, 1], "ssm_ratio": 1, "mlp_ratio": 4, "mlp_type": "gdmlp",
                  "use_pixelshuffle": True, "drop_path": 0.0, "sam": False, "stage": 1,
                  "num_blocks": [2, 2, 2]},
    "path": {"pretrain_network_g": None, "strict_load_g": True, "resume_state": None},
    "train": {
        "total_iter": 300000, "warmup_iter": -1, "max_grad_norm": 1,
        "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                      "periods": [150000, 46000, 104000], "restart_weights": [1, 1, 1],
                      "eta_mins": [0.0002, 0.0002, 0.000001]},
        "optim_g": {"type": "AdamW", "lr": 0.0002, "weight_decay": 1e-4,
                    "betas": [0.9, 0.999]},
        "mixing_augs": {"mixup": False},
        "pixel_opt": {"type": "L1Loss", "loss_weight": 1, "reduction": "mean"},
    },
    "val": {"val_freq": 1000.0, "save_img": False, "rgb2bgr": True, "use_image": True,
            "metrics": {"psnr": {"type": "calculate_psnr", "crop_border": 0,
                                 "test_y_channel": False}}},
    "logger": {"print_freq": 100, "save_checkpoint_freq": 1000.0, "use_tb_logger": True,
               "record_grad": False, "wandb": {"project": "low_light", "resume_id": None}},
    "dist_params": {"backend": "nccl", "port": 29500},
}

_MODELS = {
    "ImageEnhancer": ("IE_UNet_LOLv1", 6, 16),
    "ConditionGenerator": ("CG_UNet_LOLv1", 3, 4),
}


def lolv1_options(model_type: str) -> dict:
    """A fresh copy of the LOLv1 options of ``model_type``."""
    name, in_channels, window = _MODELS[model_type]
    opt = copy.deepcopy(_BASE)
    opt = {"name": name, "model_type": model_type, **opt}
    opt["network_g"] = {"type": "Network", "in_channels": in_channels,
                        **{k: v for k, v in opt["network_g"].items() if k != "type"}}
    opt["val"] = {"window_size": window, **opt["val"]}
    return opt
