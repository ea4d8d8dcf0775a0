"""Paired LQ / GT datasets (counterpart of bem_tpu/data/paired_image_dataset.py):
``Dataset_PairedImage`` and ``Dataset_PairedImage_Mask``, the dataset of
every LOLv1 option file.

A sample is a dict {lq, gt, lq_path, gt_path} plus the condition: hist_gt
(and hist_lq for the ConditionGenerator) or gt_down (and lq_down) at
1 / scale_down. Images are HWC RGB float32 in [0, 1]; bem_tpu decodes
BGR through cv2 and flips, so the histogram's flip and label noise's
colour temperature are written for RGB here. The /16 condition is cv2's
``resize(fx=1/scale_down)`` (:func:`..utils.img_util.downsample`).
"""

from __future__ import annotations

import numpy as np

from ..utils.file_client import FileClient
from ..utils.histogram import histogram_condition
from ..utils.img_util import downsample, imfrombytes, img2tensor, padding
from ..utils.labelnoise import add_label_noise
from .data_util import paired_paths_from_folder, paired_paths_from_meta_info_file
from .transforms import paired_random_crop, random_augmentation


class _PairedBase:
    def __init__(self, opt):
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt["io_backend"])
        self.mean = opt.get("mean")
        self.std = opt.get("std")
        self.gt_folder = opt["dataroot_gt"]
        self.lq_folder = opt["dataroot_lq"]
        self.filename_tmpl = opt.get("filename_tmpl", "{}")
        # one generator for crops, flips and label noise; loader threads
        # share it, so only a single-threaded loader draws in a fixed order
        self.rng = np.random.default_rng(opt.get("seed"))
        if self.io_backend_opt["type"] == "lmdb":
            raise NotImplementedError("the lmdb io_backend is not ported (disk is)")
        if opt.get("meta_info_file") is not None:
            self.paths = paired_paths_from_meta_info_file(
                [self.lq_folder, self.gt_folder], ["lq", "gt"], opt["meta_info_file"],
                self.filename_tmpl)
        else:
            self.paths = paired_paths_from_folder(
                [self.lq_folder, self.gt_folder], ["lq", "gt"], self.filename_tmpl)

    def _load_pair(self, index):
        if self.file_client is None:
            io_opt = dict(self.io_backend_opt)
            self.file_client = FileClient(io_opt.pop("type"), **io_opt)
        gt_path = self.paths[index]["gt_path"]
        lq_path = self.paths[index]["lq_path"]
        img_gt = imfrombytes(self.file_client.get(gt_path, "gt"), float32=True, name=gt_path)
        img_lq = imfrombytes(self.file_client.get(lq_path, "lq"), float32=True, name=lq_path)
        return img_gt, img_lq, gt_path, lq_path

    def _crop(self, img_gt, img_lq, gt_path):
        """Train phase: pad up to gt_size, one paired random crop, then the
        optional geometric variant."""
        gt_size = self.opt["gt_size"]
        img_gt, img_lq = padding(img_gt, img_lq, gt_size)
        img_gt, img_lq = paired_random_crop(img_gt, img_lq, gt_size, self.opt.get("scale", 1),
                                            gt_path, rng=self.rng)
        if self.opt.get("geometric_augs"):
            img_gt, img_lq = random_augmentation(img_gt, img_lq, rng=self.rng)
        return img_gt, img_lq

    def _normalize(self, img):
        if self.mean is not None or self.std is not None:
            mean = np.asarray(self.mean or 0.0, np.float32)
            std = np.asarray(self.std or 1.0, np.float32)
            img = (img - mean) / std
        return img

    def __len__(self):
        return len(self.paths)


class Dataset_PairedImage(_PairedBase):
    """Plain paired dataset (paired_image_dataset.py:83)."""

    def __getitem__(self, index):
        index = index % len(self.paths)
        img_gt, img_lq, gt_path, lq_path = self._load_pair(index)
        if self.opt["phase"] == "train":
            img_gt, img_lq = self._crop(img_gt, img_lq, gt_path)
        return {"lq": self._normalize(img2tensor(img_lq)), "gt": self._normalize(img2tensor(img_gt)),
                "lq_path": lq_path, "gt_path": gt_path}


class Dataset_PairedImage_Mask(_PairedBase):
    """Paired dataset with the mean or histogram condition and GT label noise
    (paired_image_dataset.py:103). The MIM mask (``mim``) is not ported."""

    def __init__(self, opt):
        super().__init__(opt)
        cond = opt["condition"]
        if cond["type"] not in ("histogram", "mean"):
            raise ValueError(f"condition type {cond['type']} not supported")
        if opt.get("mim"):
            raise NotImplementedError("the MIM mask (mim) is not ported")
        self.model_type = opt.get("model_type", "ImageEnhancer")
        self.cond = cond

    def __getitem__(self, index):
        index = index % len(self.paths)
        img_gt, img_lq, gt_path, lq_path = self._load_pair(index)
        if self.opt["phase"] == "train":
            img_gt, img_lq = self._crop(img_gt, img_lq, gt_path)
            ln = self.opt.get("labelnoise")
            if ln:
                img_gt = add_label_noise(
                    img_gt, tem_mean=ln.get("tem_mean", 1), tem_var=ln.get("tem_var", 0.03),
                    bright_mean=ln.get("bright_mean", 1.15), bright_var=ln.get("bright_var", 0.15),
                    contrast_mean=ln.get("contrast_mean", 1.15),
                    contrast_var=ln.get("contrast_var", 0.15), rng=self.rng)

        out = {"lq_path": lq_path, "gt_path": gt_path}
        cg = self.model_type == "ConditionGenerator"
        if self.cond["type"] == "histogram":
            p, bins = self.cond["hist_patch_size"], self.cond["num_bins"]
            out["hist_gt"] = histogram_condition(img_gt, p, bins)
            if cg:
                out["hist_lq"] = histogram_condition(img_lq, p, bins)
        else:
            sd = self.cond["scale_down"]
            out["gt_down"] = self._normalize(img2tensor(downsample(img_gt, sd)))
            if cg:
                out["lq_down"] = self._normalize(img2tensor(downsample(img_lq, sd)))
        out["gt"] = self._normalize(img2tensor(img_gt))
        out["lq"] = self._normalize(img2tensor(img_lq))
        return out
