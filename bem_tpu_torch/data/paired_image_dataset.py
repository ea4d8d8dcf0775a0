"""Paired LQ / GT datasets (counterpart of bem_tpu/data/paired_image_dataset.py):
``Dataset_PairedImage`` and ``Dataset_PairedImage_Mask`` (the dataset of
every LOLv1 option file), ``Dataset_PairedImage_Slide``,
``Dataset_PairedImage_Norm``, ``Dataset_DefocusDeblur_DualPixel_16bit``
and ``PairedImageDataset``.

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
from ..utils.img_util import (downsample, imfrombytes, imfrombytesDP, img2tensor, padding,
                              padding_DP)
from ..utils.labelnoise import add_label_noise
from ..utils.mask import MaskGenerator
from .data_util import (paired_DP_paths_from_folder, paired_paths_from_folder,
                        paired_paths_from_meta_info_file)
from .transforms import augment, paired_random_crop, random_augmentation


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
    """Paired dataset with the mean or histogram condition, GT label noise
    and the MIM mask (paired_image_dataset.py:103). With ``mim`` each sample
    carries an int32 ``mask`` at the network's input size (``gt_size`` for
    the ImageEnhancer, ``gt_size / scale_down`` for the ConditionGenerator),
    drawn from the dataset's generator after the crop, the flips and the
    label noise, as bem_tpu draws it."""

    def __init__(self, opt):
        super().__init__(opt)
        cond = opt["condition"]
        if cond["type"] not in ("histogram", "mean"):
            raise ValueError(f"condition type {cond['type']} not supported")
        self.model_type = opt.get("model_type", "ImageEnhancer")
        self.cond = cond
        self.mask_generator = None
        if opt.get("mim"):
            if cond["type"] == "histogram":
                raise NotImplementedError("mim not supported for histogram condition")
            mim = opt["mim"]
            input_size = (opt["gt_size"] if self.model_type == "ImageEnhancer"
                          else int(opt["gt_size"] / cond.get("scale_down", 1)))
            self.mask_generator = MaskGenerator(
                input_size=input_size, mask_patch_size=mim["mask_patch_size"],
                model_patch_size=mim["model_patch_size"], mask_ratio=mim["mask_ratio"],
                rng=self.rng)

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
        if self.mask_generator is not None:
            out["mask"] = self.mask_generator()
        return out


class Dataset_PairedImage_Slide(_PairedBase):
    """A fixed grid of ``gt_size`` patches at ``stride`` over each 400x600
    image, the index naming (image, row, column); train-phase patches
    rotated 0-3 quarter turns, then flipped (paired_image_dataset.py:185)."""

    IMG_H, IMG_W = 400, 600  # fixed, as bem_tpu's

    def __init__(self, opt):
        super().__init__(opt)
        stride, crop = opt["stride"], opt["gt_size"]
        self.patch_per_line = (self.IMG_W - crop) // stride + 1
        self.patch_per_colum = (self.IMG_H - crop) // stride + 1
        self.patch_per_img = self.patch_per_line * self.patch_per_colum

    def __getitem__(self, index):
        stride, crop = self.opt["stride"], self.opt["gt_size"]
        img_idx, patch_idx = divmod(index, self.patch_per_img)
        h_idx, w_idx = divmod(patch_idx, self.patch_per_line)
        img_gt, img_lq, gt_path, lq_path = self._load_pair(img_idx % len(self.paths))
        rows = slice(h_idx * stride, h_idx * stride + crop)
        cols = slice(w_idx * stride, w_idx * stride + crop)
        img_lq, img_gt = img_lq[rows, cols, :], img_gt[rows, cols, :]
        if self.opt["phase"] == "train":
            rot_times = int(self.rng.integers(0, 4))
            vflip = int(self.rng.integers(0, 2))
            hflip = int(self.rng.integers(0, 2))

            def aug(img):
                img = np.rot90(img, rot_times, axes=(0, 1))
                if vflip:
                    img = img[:, ::-1, :]
                if hflip:
                    img = img[::-1, :, :]
                return np.ascontiguousarray(img)

            img_lq, img_gt = aug(img_lq), aug(img_gt)
        return {"lq": img2tensor(img_lq), "gt": img2tensor(img_gt), "lq_path": lq_path,
                "gt_path": gt_path}

    def __len__(self):
        return len(self.paths) * self.patch_per_img


class Dataset_PairedImage_Norm(Dataset_PairedImage):
    """``Dataset_PairedImage`` with the LQ stretched to [0, 1] by its own
    minimum and maximum (paired_image_dataset.py:236)."""

    def __getitem__(self, index):
        out = super().__getitem__(index)
        lq = out["lq"]
        span = lq.max() - lq.min()
        out["lq"] = (lq - lq.min()) / (span if span > 0 else 1.0)
        return out


class Dataset_DefocusDeblur_DualPixel_16bit:
    """Dual-pixel defocus deblurring: (left, right, GT) 16-bit images read
    unchanged and divided by 65535; the sample's lq is left and right
    concatenated over channels (paired_image_dataset.py:249)."""

    def __init__(self, opt):
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt["io_backend"])
        self.mean, self.std = opt.get("mean"), opt.get("std")
        self.rng = np.random.default_rng(opt.get("seed"))
        if self.io_backend_opt["type"] == "lmdb":
            raise NotImplementedError("the lmdb io_backend is not ported (disk is)")
        self.paths = paired_DP_paths_from_folder(
            [opt["dataroot_lqL"], opt["dataroot_lqR"], opt["dataroot_gt"]],
            ["lqL", "lqR", "gt"], opt.get("filename_tmpl", "{}"))

    def _read(self, path, key):
        return imfrombytesDP(self.file_client.get(path, key), float32=True, name=path)

    def __getitem__(self, index):
        if self.file_client is None:
            io_opt = dict(self.io_backend_opt)
            self.file_client = FileClient(io_opt.pop("type"), **io_opt)
        paths = self.paths[index % len(self.paths)]
        gt_path, lqL_path, lqR_path = paths["gt_path"], paths["lqL_path"], paths["lqR_path"]
        img_gt = self._read(gt_path, "gt")
        img_lqL, img_lqR = self._read(lqL_path, "lqL"), self._read(lqR_path, "lqR")
        if self.opt["phase"] == "train":
            gt_size = self.opt["gt_size"]
            img_lqL, img_lqR, img_gt = padding_DP(img_lqL, img_lqR, img_gt, gt_size)
            img_gt, (img_lqL, img_lqR) = paired_random_crop(
                img_gt, [img_lqL, img_lqR], gt_size, self.opt.get("scale", 1), gt_path,
                rng=self.rng)
            if self.opt.get("geometric_augs"):
                img_gt, img_lqL, img_lqR = random_augmentation(img_gt, img_lqL, img_lqR,
                                                               rng=self.rng)
        imgs = [img2tensor(a) for a in (img_gt, img_lqL, img_lqR)]
        if self.mean is not None or self.std is not None:
            mean = np.asarray(self.mean or 0.0, np.float32)
            std = np.asarray(self.std or 1.0, np.float32)
            imgs = [(a - mean) / std for a in imgs]
        img_gt, img_lqL, img_lqR = imgs
        return {"lq": np.concatenate([img_lqL, img_lqR], axis=-1), "gt": img_gt,
                "lq_path": lqL_path, "gt_path": gt_path}

    def __len__(self):
        return len(self.paths)


class PairedImageDataset(Dataset_PairedImage):
    """BasicSR's paired dataset: the train crop followed by ``augment``'s
    flips and transpose (``use_hflip`` / ``use_rot``) instead of
    ``random_augmentation`` (paired_image_dataset.py:312)."""

    def __getitem__(self, index):
        index = index % len(self.paths)
        img_gt, img_lq, gt_path, lq_path = self._load_pair(index)
        if self.opt["phase"] == "train":
            gt_size = self.opt["gt_size"]
            img_gt, img_lq = padding(img_gt, img_lq, gt_size)
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, gt_size, self.opt.get("scale", 1),
                                                gt_path, rng=self.rng)
            img_gt, img_lq = augment([img_gt, img_lq], self.opt.get("use_hflip", True),
                                     self.opt.get("use_rot", True), rng=self.rng)
        return {"lq": self._normalize(img2tensor(img_lq)), "gt": self._normalize(img2tensor(img_gt)),
                "lq_path": lq_path, "gt_path": gt_path}
