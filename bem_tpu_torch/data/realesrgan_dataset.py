"""Real-ESRGAN's on-the-fly degradation dataset (counterpart of
bem_tpu/data/realesrgan_dataset.py): a GT crop with the two random blur
kernels and the final sinc kernel that a degradation-in-the-loop trainer
applies on the device.

Every draw comes from the dataset's own generators, all seeded from the
option ``seed``: ``random.Random`` for the kernel sizes, types and crop
offsets (bem_tpu: Python's global ``random``), ``np.random.RandomState``
for the kernel shapes and the sinc / pulse choices (bem_tpu: numpy's
global state) and ``np.random.Generator`` for the flips (bem_tpu:
``augment`` with no ``rng``, an unseeded ``default_rng()`` a call).
"""

from __future__ import annotations

import math
import random

import numpy as np

from ..utils.cv_ops import copy_make_border_reflect101
from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from .data_util import scandir
from .degradations import circular_lowpass_kernel, random_mixed_kernels
from .transforms import augment


class RealESRGANDataset:
    """GT images from ``dataroot_gt`` (or the names in ``meta_info``):
    flipped, reflect-101 padded up to ``crop_pad_size`` (400), cropped to
    it at random; ``kernel1`` / ``kernel2`` (21 x 21, a mixed kernel or,
    with ``sinc_prob``, a sinc, of a random odd size 7-21 zero-padded) and
    ``sinc_kernel`` (with ``final_sinc_prob``, else a pulse)."""

    def __init__(self, opt):
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt["io_backend"])
        self.gt_folder = opt["dataroot_gt"]
        if self.opt.get("meta_info"):
            with open(self.opt["meta_info"]) as f:
                self.paths = [f"{self.gt_folder}/{line.strip()}" for line in f if line.strip()]
        else:
            self.paths = sorted(scandir(self.gt_folder, full_path=True))
        self.first = {k: opt[k] for k in ("blur_kernel_size", "kernel_list", "kernel_prob",
                                           "blur_sigma", "betag_range", "betap_range",
                                           "sinc_prob")}
        self.second = {k: opt[k + "2"] for k in self.first}
        self.final_sinc_prob = opt["final_sinc_prob"]
        self.kernel_range = [2 * v + 1 for v in range(3, 11)]  # 7..21
        self.pulse_tensor = np.zeros((21, 21), np.float32)
        self.pulse_tensor[10, 10] = 1.0
        seed = opt.get("seed")
        self.py_rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.aug_rng = np.random.default_rng(seed)

    def _random_kernel(self, s):
        """A kernel of a random size, sinc with ``sinc_prob`` else mixed,
        zero-padded to 21 x 21 (realesrgan_dataset.py:62)."""
        kernel_size = self.py_rng.choice(self.kernel_range)
        if self.np_rng.uniform() < s["sinc_prob"]:
            omega_c = (self.np_rng.uniform(np.pi / 3, np.pi) if kernel_size < 13
                       else self.np_rng.uniform(np.pi / 5, np.pi))
            kernel = circular_lowpass_kernel(omega_c, kernel_size, pad_to=0)
        else:
            kernel = random_mixed_kernels(
                s["kernel_list"], s["kernel_prob"], kernel_size, s["blur_sigma"],
                s["blur_sigma"], (-math.pi, math.pi), s["betag_range"], s["betap_range"],
                noise_range=None, rng=self.np_rng, py_rng=self.py_rng)
        pad = (21 - kernel_size) // 2
        return np.pad(kernel, ((pad, pad), (pad, pad))).astype(np.float32)

    def __getitem__(self, index):
        if self.file_client is None:
            io_opt = dict(self.io_backend_opt)
            self.file_client = FileClient(io_opt.pop("type"), **io_opt)
        gt_path = self.paths[index % len(self.paths)]
        img_gt = imfrombytes(self.file_client.get(gt_path, "gt"), float32=True, name=gt_path)
        img_gt = augment(img_gt, self.opt.get("use_hflip", True), self.opt.get("use_rot", True),
                         rng=self.aug_rng)
        crop_pad_size = self.opt.get("crop_pad_size", 400)
        h, w = img_gt.shape[:2]
        if h < crop_pad_size or w < crop_pad_size:
            img_gt = copy_make_border_reflect101(img_gt, 0, max(0, crop_pad_size - h), 0,
                                                 max(0, crop_pad_size - w))
        h, w = img_gt.shape[:2]
        if h > crop_pad_size or w > crop_pad_size:
            top = self.py_rng.randint(0, h - crop_pad_size)
            left = self.py_rng.randint(0, w - crop_pad_size)
            img_gt = img_gt[top:top + crop_pad_size, left:left + crop_pad_size]
        kernel = self._random_kernel(self.first)
        kernel2 = self._random_kernel(self.second)
        if self.np_rng.uniform() < self.final_sinc_prob:
            kernel_size = self.py_rng.choice(self.kernel_range)
            omega_c = self.np_rng.uniform(np.pi / 3, np.pi)
            sinc_kernel = circular_lowpass_kernel(omega_c, kernel_size, pad_to=21).astype(
                np.float32)
        else:
            sinc_kernel = self.pulse_tensor
        return {"gt": img2tensor(img_gt), "kernel1": kernel, "kernel2": kernel2,
                "sinc_kernel": sinc_kernel, "gt_path": gt_path}

    def __len__(self):
        return len(self.paths)
