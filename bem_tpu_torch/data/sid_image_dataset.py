"""See-in-the-Dark clips (counterpart of bem_tpu/data/sid_image_dataset.py).

Per-clip folders of short-exposure LQ frames, each paired with its clip's
first long-exposure GT frame. The train phase keeps the clips whose folder
name starts with '0' or '2', val / test those starting with '1'. ``.npy``
frames are uint8 BGR arrays; other files go through ``imread``. Every
frame is resized to ``train_size`` (width, height) with cv2.resize's
INTER_LINEAR (``resize_linear``: uint8 ``.npy`` frames before the / 255,
image files after it, in float32). Train samples flip left-right, then
up-down, each with p = 0.5.

Deliberate difference: bem_tpu draws the flips from Python's global
``random``; the port draws them from the dataset's ``rng``
(``np.random.default_rng(seed)``), in the same order.
"""

from __future__ import annotations

import glob
from os import path as osp

import numpy as np

from ..utils.img_util import imread, resize_linear


def _glob_file_list(root):
    return sorted(glob.glob(osp.join(root, "*")))


def _read_frame(path, train_size=None):
    """One frame as float32 HWC RGB in [0, 1] (sid_image_dataset.py:40)."""
    if path.endswith(".npy"):
        img = np.load(path)
        if train_size is not None:
            img = resize_linear(img, (train_size[0], train_size[1]))
        img = img.astype(np.float32) / 255.0
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] > 3:
            img = img[:, :, :3]
        img = img[:, :, ::-1]  # BGR -> RGB
    else:
        img = imread(path)
        if train_size is not None:
            img = resize_linear(img, (train_size[0], train_size[1]))
    return np.ascontiguousarray(img, dtype=np.float32)


class Dataset_SIDImage:
    """(sid_image_dataset.py:69) A sample: {lq, gt, folder, idx ("i/n"),
    border, lq_path, gt_path}; ``border`` marks the first and last
    N_frames // 2 frames of a clip."""

    def __init__(self, opt):
        self.opt = opt
        self.half_N_frames = opt.get("N_frames", 1) // 2
        self.train_size = opt.get("train_size")
        self.rng = np.random.default_rng(opt.get("seed"))
        self.data_info = {"path_LQ": [], "path_GT": [], "folder": [], "idx": [], "border": []}
        self.imgs_lq, self.imgs_gt = {}, {}
        keep = ("0", "2") if opt.get("phase", "train") == "train" else ("1",)
        for sub_lq, sub_gt in zip(_glob_file_list(opt["dataroot_lq"]),
                                  _glob_file_list(opt["dataroot_gt"])):
            folder = osp.basename(sub_lq)
            if folder[:1] not in keep:
                continue
            lq_paths, gt_paths = _glob_file_list(sub_lq), _glob_file_list(sub_gt)
            if not gt_paths:
                raise ValueError(f"SID clip {folder}: no GT frames in {sub_gt}")
            n = len(lq_paths)
            self.imgs_lq[folder], self.imgs_gt[folder] = lq_paths, gt_paths
            self.data_info["path_LQ"].extend(lq_paths)
            self.data_info["path_GT"].extend([gt_paths[0]] * n)
            self.data_info["folder"].extend([folder] * n)
            self.data_info["idx"].extend(f"{i}/{n}" for i in range(n))
            border = [0] * n
            for i in range(self.half_N_frames):
                border[i] = border[n - i - 1] = 1
            self.data_info["border"].extend(border)

    def __getitem__(self, index):
        folder = self.data_info["folder"][index]
        idx = int(self.data_info["idx"][index].split("/")[0])
        lq = _read_frame(self.imgs_lq[folder][idx], self.train_size)
        gt = _read_frame(self.imgs_gt[folder][0], self.train_size)
        if self.opt.get("phase") == "train":
            if self.opt.get("use_flip", True) and self.rng.random() < 0.5:
                lq, gt = lq[:, ::-1], gt[:, ::-1]
            if self.opt.get("use_rot", True) and self.rng.random() < 0.5:
                lq, gt = lq[::-1], gt[::-1]
        return {"lq": np.ascontiguousarray(lq), "gt": np.ascontiguousarray(gt), "folder": folder,
                "idx": self.data_info["idx"][index], "border": self.data_info["border"][index],
                "lq_path": self.imgs_lq[folder][idx], "gt_path": self.imgs_gt[folder][0]}

    def __len__(self):
        return len(self.data_info["path_LQ"])
