"""GT-only datasets (counterpart of bem_tpu/data/gaussian_denoising_dataset.py):
``Dataset_GaussianDenoising``, whose LQ is the GT plus Gaussian noise, and
``FFHQDataset``."""

from __future__ import annotations

import numpy as np

from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor, padding
from .data_util import scandir
from .transforms import paired_random_crop, random_augmentation


def _gt_paths(opt):
    if opt.get("meta_info_file"):
        with open(opt["meta_info_file"]) as f:
            return [f"{opt['dataroot_gt']}/{line.split(' ')[0].strip()}" for line in f]
    return sorted(scandir(opt["dataroot_gt"], full_path=True))


class Dataset_GaussianDenoising:
    """Train: pad, crop, the optional geometric variant, then noise of a
    sigma drawn by ``sigma_type`` (constant / random / choice over
    ``sigma_range``); val / test: noise of ``sigma_test`` from a generator
    seeded 0. ``in_ch`` 1 reads grey (cv2's IMREAD_GRAYSCALE); like
    bem_tpu's, a grey image that needed padding comes out 2-D
    (gaussian_denoising_dataset.py:25)."""

    def __init__(self, opt):
        self.opt = opt
        if opt["phase"] == "train":
            self.sigma_type = opt["sigma_type"]
            self.sigma_range = opt["sigma_range"]
            if self.sigma_type not in ("constant", "random", "choice"):
                raise ValueError(f"sigma_type {self.sigma_type} not supported")
        else:
            self.sigma_test = opt["sigma_test"]
        self.in_ch = opt.get("in_ch", 3)
        self.file_client = None
        self.io_backend_opt = dict(opt["io_backend"])
        self.rng = np.random.default_rng(opt.get("seed"))
        if self.io_backend_opt["type"] == "lmdb":
            raise NotImplementedError("the lmdb io_backend is not ported (disk is)")
        self.paths = _gt_paths(opt)

    def _sigma(self):
        if self.sigma_type == "constant":
            return self.sigma_range
        if self.sigma_type == "random":
            return float(self.rng.uniform(*self.sigma_range))
        return float(self.rng.choice(self.sigma_range))

    def __getitem__(self, index):
        if self.file_client is None:
            io_opt = dict(self.io_backend_opt)
            self.file_client = FileClient(io_opt.pop("type"), **io_opt)
        gt_path = self.paths[index % len(self.paths)]
        content = self.file_client.get(gt_path, "gt")
        if self.in_ch == 3:
            img_gt = imfrombytes(content, float32=True, name=gt_path)
        else:
            img_gt = imfrombytes(content, "grayscale", float32=True, name=gt_path)[..., None]
        if self.opt["phase"] == "train":
            gt_size = self.opt["gt_size"]
            img_gt, _ = padding(img_gt, img_gt, gt_size)
            img_gt, _ = paired_random_crop(img_gt, img_gt.copy(), gt_size, 1, gt_path,
                                           rng=self.rng)
            if self.opt.get("geometric_augs", True):
                (img_gt,) = random_augmentation(img_gt, rng=self.rng)
            noise = self.rng.normal(0, self._sigma() / 255.0, img_gt.shape)
        else:
            noise = np.random.default_rng(0).normal(0, self.sigma_test / 255.0, img_gt.shape)
        img_lq = img_gt + noise.astype(np.float32)
        return {"lq": img_lq.astype(np.float32), "gt": img_gt.astype(np.float32),
                "lq_path": gt_path, "gt_path": gt_path}

    def __len__(self):
        return len(self.paths)


class FFHQDataset:
    """GT-only faces: a horizontal flip with p = 0.5 (the draw made whether or
    not ``use_hflip``), normalised by ``mean`` / ``std`` where given
    (gaussian_denoising_dataset.py:95)."""

    def __init__(self, opt):
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt["io_backend"])
        self.mean, self.std = opt.get("mean"), opt.get("std")
        self.rng = np.random.default_rng(opt.get("seed"))
        if self.io_backend_opt["type"] == "lmdb":
            raise NotImplementedError("the lmdb io_backend is not ported (disk is)")
        self.paths = sorted(scandir(opt["dataroot_gt"], full_path=True))

    def __getitem__(self, index):
        if self.file_client is None:
            io_opt = dict(self.io_backend_opt)
            self.file_client = FileClient(io_opt.pop("type"), **io_opt)
        gt_path = self.paths[index]
        img_gt = imfrombytes(self.file_client.get(gt_path, "gt"), float32=True, name=gt_path)
        if self.rng.random() < 0.5 and self.opt.get("use_hflip", True):
            img_gt = img_gt[:, ::-1]
        img_gt = img2tensor(img_gt)
        if self.mean is not None or self.std is not None:
            img_gt = (img_gt - np.asarray(self.mean or 0.0, np.float32)) / np.asarray(
                self.std or 1.0, np.float32)
        return {"gt": img_gt, "gt_path": gt_path}

    def __len__(self):
        return len(self.paths)
