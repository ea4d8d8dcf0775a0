"""Video restoration datasets (counterpart of bem_tpu/data/video_datasets.py,
BasicSR's EDVR-era REDS / Vimeo90K loaders): clips stacked on a leading
frame axis, each frame RGB HWC float32.

bem_tpu draws the temporal interval, the centre frame and the reversal
from the module-level ``random`` and its crops and flips from a fresh
unseeded generator; the port draws all of them, in bem_tpu's order, from
the dataset's ``rng`` (``np.random.default_rng(opt["seed"])``). The disk
backend of :mod:`..utils.file_client` reads the frames; lmdb stays
refused there.
"""

from __future__ import annotations

import os
from os import path as osp

import numpy as np

from ..utils.file_client import FileClient
from ..utils.flow_util import dequantize_flow
from ..utils.img_util import imfrombytes, img2tensor, imread
from .data_util import scandir
from .transforms import augment, mod_crop, paired_random_crop


def generate_frame_indices(crt_idx, max_frame_num, num_frames, padding="reflection"):
    """The ``num_frames`` indices around ``crt_idx``, padded at the clip's
    borders by ``padding`` (video_datasets.py:24)."""
    assert num_frames % 2 == 1
    assert padding in ("replicate", "reflection", "reflection_circle", "circle")
    max_frame_num = max_frame_num - 1
    num_pad = num_frames // 2
    indices = []
    for i in range(crt_idx - num_pad, crt_idx + num_pad + 1):
        if i < 0:
            pad_idx = {"replicate": 0, "reflection": -i,
                       "reflection_circle": crt_idx + num_pad - i}.get(padding, num_frames + i)
        elif i > max_frame_num:
            pad_idx = {"replicate": max_frame_num, "reflection": max_frame_num * 2 - i,
                       "reflection_circle": (crt_idx - num_pad) - (i - max_frame_num)
                       }.get(padding, i - num_frames)
        else:
            pad_idx = i
        indices.append(pad_idx)
    return indices


def generate_gaussian_kernel(kernel_size=13, sigma=1.6):
    """A centred delta through scipy's gaussian_filter (video_datasets.py:270)."""
    from scipy.ndimage import gaussian_filter

    kernel = np.zeros((kernel_size, kernel_size))
    kernel[kernel_size // 2, kernel_size // 2] = 1
    return gaussian_filter(kernel, sigma)


def duf_downsample(x: np.ndarray, kernel_size: int = 13, scale: int = 4):
    """DUF's Gaussian blur and stride-``scale`` subsample of (T, H, W, C)
    frames, reflect-padded, the 2-pixel border cropped
    (video_datasets.py:280)."""
    assert scale in (2, 3, 4), f"Only support scale (2, 3, 4), but got {scale}."
    pad = kernel_size // 2 + scale * 2
    kern = generate_gaussian_kernel(kernel_size, 0.4 * scale).astype(x.dtype)
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect")
    sw = np.lib.stride_tricks.sliding_window_view(xp, kern.shape, axis=(1, 2))
    out = np.einsum("thwcij,ij->thwc", sw[:, ::scale, ::scale], kern)
    return out[:, 2:-2, 2:-2]


def _reds_keys(meta_info_file):
    keys = []
    with open(meta_info_file) as f:
        for line in f:
            folder, frame_num, _ = line.split(" ")
            keys.extend(f"{folder}/{i:08d}" for i in range(int(frame_num)))
    return keys


class _Clips:
    """What the training sets share: the options, the seeded draws and the
    lazily opened file client."""

    def __init__(self, opt):
        self.opt = opt
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        self.io_backend_opt = dict(opt["io_backend"])
        self.file_client = None
        self.random_reverse = opt.get("random_reverse", False)
        self.rng = np.random.default_rng(opt.get("seed"))

    def _read(self, path, key):
        if self.file_client is None:
            io_opt = dict(self.io_backend_opt)
            self.file_client = FileClient(io_opt.pop("type"), **io_opt)
        return imfrombytes(self.file_client.get(path, key), float32=True, name=path)

    def _interval(self):
        return self.interval_list[int(self.rng.integers(len(self.interval_list)))]

    def _reverse(self, neighbors):
        if self.random_reverse and self.rng.random() < 0.5:
            neighbors.reverse()
        return neighbors

    def _augment(self, imgs, flows=None):
        return augment(imgs, self.opt.get("use_hflip", True), self.opt.get("use_rot", True),
                       flows, rng=self.rng)


class REDSDataset(_Clips):
    """REDS training: the GT centre frame and ``num_frame`` LQ neighbours at
    a random temporal interval, optionally reversed, with their quantized
    flows from ``dataroot_flow`` (video_datasets.py:60)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.flow_root = opt.get("dataroot_flow")
        assert opt["num_frame"] % 2 == 1
        self.num_frame = opt["num_frame"]
        self.num_half_frames = opt["num_frame"] // 2
        self.keys = _reds_keys(opt["meta_info_file"])
        val_partition = (["000", "011", "015", "020"]
                         if opt.get("val_partition", "REDS4") == "REDS4"
                         else [f"{v:03d}" for v in range(240, 270)])
        train = opt["phase"] == "train"
        self.keys = [k for k in self.keys if (k.split("/")[0] in val_partition) != train]
        self.interval_list = opt.get("interval_list", [1])
        self.frames_per_clip = opt.get("frames_per_clip", 100)

    def __getitem__(self, index):
        scale, gt_size = self.opt["scale"], self.opt["gt_size"]
        clip_name, frame_name = self.keys[index].split("/")
        center = int(frame_name)
        interval = self._interval()
        last = self.frames_per_clip - 1
        half = self.num_half_frames * interval
        while center - half < 0 or center + half > last:
            center = int(self.rng.integers(0, last + 1))
        neighbors = self._reverse(list(range(center - half, center + half + 1, interval)))

        gt_path = osp.join(self.gt_root, clip_name, f"{center:08d}.png")
        img_gt = self._read(gt_path, "gt")
        img_lqs = [self._read(osp.join(self.lq_root, clip_name, f"{n:08d}.png"), "lq")
                   for n in neighbors]
        img_flows = None
        if self.flow_root is not None:
            # the centre frame's quantized flows to its _p / _n neighbours
            # (dx over dy, max_val 20, not denormalized), cropped with the LQs
            img_flows = []
            for order, tag in ((range(self.num_half_frames, 0, -1), "p"),
                               (range(1, self.num_half_frames + 1), "n")):
                for i in order:
                    fpath = osp.join(self.flow_root, clip_name, f"{frame_name}_{tag}{i}.png")
                    cat_flow = imfrombytes(self.file_client.get(fpath, "flow"), "grayscale",
                                           name=fpath)
                    dx, dy = np.split(cat_flow, 2, axis=0)
                    img_flows.append(dequantize_flow(dx, dy, max_val=20, denorm=False))
            img_lqs.extend(img_flows)

        img_gt, img_lqs = paired_random_crop(img_gt, img_lqs, gt_size, scale, gt_path,
                                             rng=self.rng)
        if img_flows is not None:
            img_lqs, img_flows = img_lqs[:self.num_frame], img_lqs[self.num_frame:]
            imgs, img_flows = self._augment(img_lqs + [img_gt], img_flows)
        else:
            imgs = self._augment(img_lqs + [img_gt])
        out = {"lq": np.stack([img2tensor(i) for i in imgs[:-1]]), "gt": img2tensor(imgs[-1])}
        if img_flows is not None:
            # a zero flow for the centre frame, at the middle position
            img_flows = [f.astype(np.float32) for f in img_flows]
            img_flows.insert(self.num_half_frames, np.zeros_like(img_flows[0]))
            out["flow"] = np.stack(img_flows)
        out["key"] = self.keys[index]
        return out

    def __len__(self):
        return len(self.keys)


class Vimeo90KDataset(_Clips):
    """Vimeo90K septuplets: GT frame 4, LQ the ``num_frame`` frames around
    it, optionally reversed (video_datasets.py:163)."""

    def __init__(self, opt):
        super().__init__(opt)
        with open(opt["meta_info_file"]) as f:
            self.keys = [line.strip().split(" ")[0] for line in f if line.strip()]
        self.neighbor_list = [i + (9 - opt["num_frame"]) // 2 for i in range(opt["num_frame"])]

    def __getitem__(self, index):
        key = self.keys[index]
        clip, seq = key.split("/")
        gt_path = osp.join(self.gt_root, clip, seq, "im4.png")
        img_gt = self._read(gt_path, "gt")
        neighbors = self._reverse(list(self.neighbor_list))
        img_lqs = [self._read(osp.join(self.lq_root, clip, seq, f"im{n}.png"), "lq")
                   for n in neighbors]
        img_gt, img_lqs = paired_random_crop(img_gt, img_lqs, self.opt["gt_size"],
                                             self.opt["scale"], gt_path, rng=self.rng)
        imgs = self._augment(img_lqs + [img_gt])
        return {"lq": np.stack([img2tensor(i) for i in imgs[:-1]]),
                "gt": img2tensor(imgs[-1]), "key": key}

    def __len__(self):
        return len(self.keys)


class VideoTestDataset:
    """Whole-clip testing: every frame of every clip under ``dataroot_lq``
    with its padded neighbour window (video_datasets.py:212)."""

    def __init__(self, opt):
        self.opt = opt
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        self.data_info = {"lq_path": [], "gt_path": [], "folder": [], "idx": [], "border": []}
        self.imgs_lq, self.imgs_gt = {}, {}
        half = opt["num_frame"] // 2
        for clip in sorted(os.listdir(self.lq_root)):
            lq_frames = sorted(scandir(osp.join(self.lq_root, clip), full_path=True))
            gt_frames = sorted(scandir(osp.join(self.gt_root, clip), full_path=True))
            n = len(lq_frames)
            self.imgs_lq[clip], self.imgs_gt[clip] = lq_frames, gt_frames
            for i in range(n):
                self.data_info["lq_path"].append(lq_frames[i])
                self.data_info["gt_path"].append(gt_frames[i])
                self.data_info["folder"].append(clip)
                self.data_info["idx"].append(f"{i}/{n}")
                self.data_info["border"].append(int(i < half or i >= n - half))

    def _window(self, index):
        folder = self.data_info["folder"][index]
        idx, max_idx = map(int, self.data_info["idx"][index].split("/"))
        return folder, generate_frame_indices(idx, max_idx, self.opt["num_frame"],
                                              padding=self.opt.get("padding", "reflection"))

    def _info(self, index):
        return {k: self.data_info[k][index] for k in ("folder", "idx", "border", "lq_path")}

    def __getitem__(self, index):
        folder, select = self._window(index)
        img_lqs = np.stack([img2tensor(imread(self.imgs_lq[folder][i])) for i in select])
        img_gt = img2tensor(imread(self.data_info["gt_path"][index]))
        return {"lq": img_lqs, "gt": img_gt, **self._info(index)}

    def __len__(self):
        return len(self.data_info["gt_path"])


class REDSRecurrentDataset(_Clips):
    """REDS clips for recurrent nets: ``num_frame`` frames from the key's
    frame at a random interval (a random start where they would run past
    the clip), optionally reversed, one crop and one flip for the window
    (video_datasets.py:299)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.num_frame = opt["num_frame"]
        self.keys = _reds_keys(opt["meta_info_file"])
        if opt.get("val_partition", "REDS4") == "REDS4":
            val_partition = ["000", "011", "015", "020"]
        elif opt["val_partition"] == "official":
            val_partition = [f"{v:03d}" for v in range(240, 270)]
        else:
            raise ValueError(f"Wrong validation partition {opt['val_partition']}.")
        test = bool(opt.get("test_mode"))
        self.keys = [v for v in self.keys if (v.split("/")[0] in val_partition) == test]
        self.interval_list = opt.get("interval_list", [1])
        self.frames_per_clip = opt.get("frames_per_clip", 100)

    def __getitem__(self, index):
        clip_name, frame_name = self.keys[index].split("/")
        interval = self._interval()
        start = int(frame_name)
        limit = self.frames_per_clip - self.num_frame * interval
        if start > limit:
            start = int(self.rng.integers(0, limit + 1))
        neighbors = self._reverse(list(range(start, start + self.num_frame * interval,
                                             interval)))
        img_lqs, img_gts = [], []
        for n in neighbors:
            gt_path = osp.join(self.gt_root, clip_name, f"{n:08d}.png")
            img_lqs.append(self._read(osp.join(self.lq_root, clip_name, f"{n:08d}.png"), "lq"))
            img_gts.append(self._read(gt_path, "gt"))
        img_gts, img_lqs = paired_random_crop(img_gts, img_lqs, self.opt["gt_size"],
                                              self.opt["scale"], gt_path, rng=self.rng)
        imgs = self._augment(img_lqs + img_gts)
        t = len(neighbors)
        return {"lq": np.stack([img2tensor(i) for i in imgs[:t]]),
                "gt": np.stack([img2tensor(i) for i in imgs[t:]]), "key": self.keys[index]}

    def __len__(self):
        return len(self.keys)


class Vimeo90KRecurrentDataset(Vimeo90KDataset):
    """Vimeo90K septuplets for recurrent nets: all 7 frames as LQ and GT
    sequences, optionally followed by their reverse (video_datasets.py:364).
    A reversal flips the dataset's frame order for every later item too,
    as bem_tpu's does."""

    def __init__(self, opt):
        super().__init__(opt)
        self.flip_sequence = opt.get("flip_sequence", False)
        self.neighbor_list = [1, 2, 3, 4, 5, 6, 7]

    def __getitem__(self, index):
        if self.random_reverse and self.rng.random() < 0.5:
            self.neighbor_list.reverse()
        key = self.keys[index]
        clip, seq = key.split("/")
        img_lqs, img_gts = [], []
        for n in self.neighbor_list:
            gt_path = osp.join(self.gt_root, clip, seq, f"im{n}.png")
            img_lqs.append(self._read(osp.join(self.lq_root, clip, seq, f"im{n}.png"), "lq"))
            img_gts.append(self._read(gt_path, "gt"))
        img_gts, img_lqs = paired_random_crop(img_gts, img_lqs, self.opt["gt_size"],
                                              self.opt["scale"], gt_path, rng=self.rng)
        imgs = self._augment(img_lqs + img_gts)
        lq = np.stack([img2tensor(i) for i in imgs[:7]])
        gt = np.stack([img2tensor(i) for i in imgs[7:]])
        if self.flip_sequence:
            lq = np.concatenate([lq, lq[::-1]], axis=0)
            gt = np.concatenate([gt, gt[::-1]], axis=0)
        return {"lq": lq, "gt": gt, "key": key}


class VideoTestVimeo90KDataset:
    """Vimeo90K-Test: the centre frame's GT with its ``num_frame`` window
    (video_datasets.py:410)."""

    def __init__(self, opt):
        self.opt = opt
        if opt.get("cache_data"):
            raise NotImplementedError("cache_data in Vimeo90K-Test dataset is not implemented.")
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        self.data_info = {"lq_path": [], "gt_path": [], "folder": [], "idx": [], "border": []}
        neighbor_list = [i + (9 - opt["num_frame"]) // 2 for i in range(opt["num_frame"])]
        with open(opt["meta_info_file"]) as fin:
            subfolders = [line.split(" ")[0] for line in fin if line.strip()]
        for idx, subfolder in enumerate(subfolders):
            self.data_info["gt_path"].append(osp.join(self.gt_root, subfolder, "im4.png"))
            self.data_info["lq_path"].append(
                [osp.join(self.lq_root, subfolder, f"im{i}.png") for i in neighbor_list])
            self.data_info["folder"].append("vimeo90k")
            self.data_info["idx"].append(f"{idx}/{len(subfolders)}")
            self.data_info["border"].append(0)

    def __getitem__(self, index):
        lq_paths = self.data_info["lq_path"][index]
        return {"lq": np.stack([imread(p) for p in lq_paths]),
                "gt": imread(self.data_info["gt_path"][index]),
                "folder": self.data_info["folder"][index],
                "idx": self.data_info["idx"][index],
                "border": self.data_info["border"][index],
                "lq_path": lq_paths[self.opt["num_frame"] // 2]}

    def __len__(self):
        return len(self.data_info["gt_path"])


class VideoTestDUFDataset(VideoTestDataset):
    """DUF's test set: with ``use_duf_downsampling`` the LQ window is the GT
    window through :func:`duf_downsample`; frames mod-cropped to ``scale``
    (video_datasets.py:458)."""

    def __getitem__(self, index):
        folder, select = self._window(index)
        scale = self.opt["scale"]
        if self.opt.get("use_duf_downsampling"):
            gt_frames = np.stack([mod_crop(imread(self.imgs_gt[folder][i]), scale)
                                  for i in select])
            imgs_lq = duf_downsample(gt_frames, kernel_size=13, scale=scale)
        else:
            imgs_lq = np.stack([imread(self.imgs_lq[folder][i]) for i in select])
        img_gt = mod_crop(imread(self.data_info["gt_path"][index]), scale)
        return {"lq": imgs_lq, "gt": img_gt, **self._info(index)}


class VideoRecurrentTestDataset(VideoTestDataset):
    """Whole clips as single items for recurrent nets (video_datasets.py:500)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.folders = sorted(set(self.data_info["folder"]))

    def __getitem__(self, index):
        folder = self.folders[index]
        return {"lq": np.stack([imread(p) for p in self.imgs_lq[folder]]),
                "gt": np.stack([imread(p) for p in self.imgs_gt[folder]]), "folder": folder}

    def __len__(self):
        return len(self.folders)


VIDEO_DATASETS = {cls.__name__: cls for cls in (
    REDSDataset, Vimeo90KDataset, VideoTestDataset, REDSRecurrentDataset,
    Vimeo90KRecurrentDataset, VideoTestVimeo90KDataset, VideoTestDUFDataset,
    VideoRecurrentTestDataset)}
