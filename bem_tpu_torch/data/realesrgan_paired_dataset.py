"""Real-ESRGAN's paired dataset (counterpart of
bem_tpu/data/realesrgan_paired_dataset.py): LQ / GT pairs from two
folders or a ``meta_info`` list, the train phase's paired crop and flips
drawn from ``np.random.default_rng(seed)`` as in bem_tpu, optional mean /
std normalization. The lmdb backend is not ported and raises."""

from __future__ import annotations

import os

import numpy as np

from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from .data_util import paired_paths_from_folder
from .transforms import augment, paired_random_crop


class RealESRGANPairedDataset:
    """Paired LQ / GT with the standard SR augmentations (crop, flips)."""

    def __init__(self, opt):
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt["io_backend"])
        self.mean = opt.get("mean")
        self.std = opt.get("std")
        self.gt_folder, self.lq_folder = opt["dataroot_gt"], opt["dataroot_lq"]
        self.filename_tmpl = opt.get("filename_tmpl", "{}")
        self.rng = np.random.default_rng(opt.get("seed"))
        if self.io_backend_opt["type"] == "lmdb":
            raise NotImplementedError("RealESRGANPairedDataset: the lmdb file backend is not "
                                      "ported (disk is)")
        if self.opt.get("meta_info") is not None:
            with open(self.opt["meta_info"]) as f:
                names = [line.strip() for line in f if line.strip()]
            self.paths = [{"gt_path": os.path.join(self.gt_folder, n),
                           "lq_path": os.path.join(self.lq_folder, n)} for n in names]
        else:
            self.paths = paired_paths_from_folder([self.lq_folder, self.gt_folder], ["lq", "gt"],
                                                  self.filename_tmpl)

    def __getitem__(self, index):
        if self.file_client is None:
            io_opt = dict(self.io_backend_opt)
            self.file_client = FileClient(io_opt.pop("type"), **io_opt)
        scale = self.opt.get("scale", 1)
        gt_path = self.paths[index]["gt_path"]
        lq_path = self.paths[index]["lq_path"]
        img_gt = imfrombytes(self.file_client.get(gt_path, "gt"), float32=True, name=gt_path)
        img_lq = imfrombytes(self.file_client.get(lq_path, "lq"), float32=True, name=lq_path)
        if self.opt["phase"] == "train":
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, self.opt["gt_size"], scale,
                                                gt_path, rng=self.rng)
            img_gt, img_lq = augment([img_gt, img_lq], self.opt.get("use_hflip", True),
                                     self.opt.get("use_rot", True), rng=self.rng)
        img_gt, img_lq = img2tensor(img_gt), img2tensor(img_lq)
        if self.mean is not None or self.std is not None:
            mean = np.asarray(self.mean or 0.0, np.float32)
            std = np.asarray(self.std or 1.0, np.float32)
            img_gt = (img_gt - mean) / std
            img_lq = (img_lq - mean) / std
        return {"lq": img_lq, "gt": img_gt, "lq_path": lq_path, "gt_path": gt_path}

    def __len__(self):
        return len(self.paths)
