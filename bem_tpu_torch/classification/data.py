"""ImageNet-style loaders of the classification harness (counterpart of
bem_tpu/classification/data.py; reference basicsr/vmamba/data/build.py,
cached_image_folder.py, samplers.py).

Images are read by the port's codecs (``utils/img_util.imread``, colour,
RGB) and augmented in numpy by :mod:`..utils.cv_ops`, bem_tpu's cv2 calls
(resizes, warpAffine, equalizeHist, GaussianBlur), into NHWC float32
batches normalized with the ImageNet mean / std.

bem_tpu draws its augmentations from Python's global ``random`` and
numpy's global legacy ``np.random``. The port draws them from a
``random.Random`` and an ``np.random.RandomState`` that the loader owns
(seeded with its ``aug_seed``) and passes to the dataset, which passes
them to the transform. Seeded with one number, the two packages draw the
same Mersenne-Twister streams, so their batches are equal bit for bit.
bem_tpu's quirks are kept: ``AUG.AUTO_AUGMENT`` turns RandAugment on for
any non-empty string (``"none"`` too), and color jitter runs only
without it; at eval, ``"random"`` interpolation is INTER_LINEAR;
random erasing writes float64 normal draws into the float32 image;
``build_dataset`` reports 1000 classes whatever the folder holds.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Tuple

import numpy as np

from ..utils import cv_ops
from ..utils.cv_ops import INTER_CUBIC, INTER_LINEAR, INTER_NEAREST
from ..utils.img_util import imread

IMAGENET_DEFAULT_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_DEFAULT_STD = np.array([0.229, 0.224, 0.225], np.float32)

_INTERP = {
    "bilinear": INTER_LINEAR,
    "bicubic": INTER_CUBIC,
    "random": INTER_LINEAR,  # resolved per sample in the train transform
    "nearest": INTER_NEAREST,
}

# bem_tpu's glob; a .webp file raises in the decoder, naming the file
IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".JPEG")


def _gens(py_rng, np_rng):
    return (py_rng if py_rng is not None else random.Random(),
            np_rng if np_rng is not None else np.random.RandomState())


def find_classes(root: str) -> Tuple[List[str], dict]:
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    return classes, {c: i for i, c in enumerate(classes)}


class ImageFolderDataset:
    """root/<class>/<image> (data.py:48): the files whose names end with
    one of ``IMG_EXTS``, in sorted order per sorted class."""

    def __init__(self, root: str, transform=None):
        self.root = root
        self.transform = transform
        self.classes, class_to_idx = find_classes(root)
        self.samples: List[Tuple[str, int]] = []
        for c in self.classes:
            d = os.path.join(root, c)
            for fn in sorted(os.listdir(d)):
                if fn.endswith(IMG_EXTS):
                    self.samples.append((os.path.join(d, fn), class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def get(self, idx, py_rng: Optional[random.Random] = None,
            np_rng: Optional[np.random.RandomState] = None):
        """(image, label): the file decoded in colour (RGB uint8), through
        the transform with the given generators."""
        path, label = self.samples[idx]
        img = imread(path, float32=False)
        if self.transform is not None:
            img = self.transform(img, *_gens(py_rng, np_rng))
        return img, label

    def __getitem__(self, idx):
        return self.get(idx)


# ---------------------------------------------------------------------------
# Transforms (build_transform, vmamba/data/build.py:125-162)
# ---------------------------------------------------------------------------


def _random_resized_crop(img, size, interp, py_rng, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """Up to 10 tries of a crop of random area and aspect, resized to
    size x size; else the centre square (data.py:80)."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = py_rng.uniform(*scale) * area
        ar = np.exp(py_rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target_area * ar)))
        ch = int(round(np.sqrt(target_area / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            y = py_rng.randint(0, h - ch)
            x = py_rng.randint(0, w - cw)
            return cv_ops.resize(img[y:y + ch, x:x + cw], (size, size), interp)
    m = min(h, w)
    y, x = (h - m) // 2, (w - m) // 2
    return cv_ops.resize(img[y:y + m, x:x + m], (size, size), interp)


def _color_jitter(img, strength, py_rng):
    """With p = 0.8, brightness / contrast / saturation in random order,
    each by 1 + U(-strength, strength) (data.py:101)."""
    f = img.astype(np.float32)
    if py_rng.random() < 0.8:
        for op in py_rng.sample(("b", "c", "s"), 3):
            v = 1.0 + py_rng.uniform(-strength, strength)
            if op == "b":
                f = f * v
            elif op == "c":
                f = (f - f.mean()) * v + f.mean()
            else:
                g = f.mean(axis=2, keepdims=True)
                f = g + (f - g) * v
    return np.clip(f, 0, 255).astype(np.uint8)


def _rand_augment(img, py_rng, magnitude=9, num_ops=2):
    """bem_tpu's compact RandAugment (data.py:117): ``num_ops`` of twelve
    ops drawn without replacement, each at ``magnitude`` / 30."""
    m = magnitude / 30.0
    h, w = img.shape[:2]
    gray = (128, 128, 128)

    def sign():
        return py_rng.choice([-1, 1])

    def shear_x(x):
        return cv_ops.warp_affine(x, np.float32([[1, sign() * m, 0], [0, 1, 0]]), (w, h), gray)

    def shear_y(x):
        return cv_ops.warp_affine(x, np.float32([[1, 0, 0], [sign() * m, 1, 0]]), (w, h), gray)

    def trans_x(x):
        return cv_ops.warp_affine(x, np.float32([[1, 0, sign() * m * w / 3], [0, 1, 0]]),
                                  (w, h), gray)

    def trans_y(x):
        return cv_ops.warp_affine(x, np.float32([[1, 0, 0], [0, 1, sign() * m * h / 3]]),
                                  (w, h), gray)

    def rotate(x):
        M = cv_ops.get_rotation_matrix_2d((w / 2, h / 2), sign() * m * 30, 1.0)
        return cv_ops.warp_affine(x, M, (w, h), gray)

    def auto_contrast(x):
        f = x.astype(np.float32)
        lo, hi = f.min(axis=(0, 1)), f.max(axis=(0, 1))
        return np.clip((f - lo) * 255.0 / np.maximum(hi - lo, 1), 0, 255).astype(np.uint8)

    def equalize(x):
        return np.stack([cv_ops.equalize_hist(x[..., c]) for c in range(3)], -1)

    def solarize(x):
        t = 256 - int(m * 256)
        return np.where(x < t, x, 255 - x).astype(np.uint8)

    def posterize(x):
        bits = max(1, 8 - int(m * 4))
        return (x >> (8 - bits)) << (8 - bits)

    def contrast(x):
        f = x.astype(np.float32)
        return np.clip((f - f.mean()) * (1 + m) + f.mean(), 0, 255).astype(np.uint8)

    def brightness(x):
        return np.clip(x.astype(np.float32) * (1 + m), 0, 255).astype(np.uint8)

    def sharpness(x):
        blur = cv_ops.gaussian_blur(x, 3)
        f = x.astype(np.float32) * (1 + m) - blur.astype(np.float32) * m
        return np.clip(f, 0, 255).astype(np.uint8)

    ops = [shear_x, shear_y, trans_x, trans_y, rotate, auto_contrast, equalize, solarize,
           posterize, contrast, brightness, sharpness]
    for op in py_rng.sample(ops, num_ops):
        img = op(img)
    return img


def _random_erasing(img, prob, py_rng, np_rng, mode="pixel"):
    """With p = ``prob``, one rectangle of random area and aspect (up to 10
    tries) set to N(0, 1) draws (``pixel``) or 0 (data.py:177)."""
    if py_rng.random() >= prob:
        return img
    h, w = img.shape[:2]
    for _ in range(10):
        area = py_rng.uniform(0.02, 1 / 3) * h * w
        ar = np.exp(py_rng.uniform(np.log(0.3), np.log(1 / 0.3)))
        eh, ew = int(round(np.sqrt(area / ar))), int(round(np.sqrt(area * ar)))
        if eh < h and ew < w:
            y, x = py_rng.randint(0, h - eh), py_rng.randint(0, w - ew)
            if mode == "pixel":
                img[y:y + eh, x:x + ew] = np_rng.normal(0, 1, (eh, ew, img.shape[2]))
            else:
                img[y:y + eh, x:x + ew] = 0
            return img
    return img


def build_transform(is_train: bool, config):
    """uint8 RGB HWC -> float32 normalized HWC (data.py:199): a callable
    ``tf(img, py_rng, np_rng)``."""
    size = config.DATA.IMG_SIZE
    interp_name = config.DATA.INTERPOLATION

    def normalize(img_u8):
        f = img_u8.astype(np.float32) / 255.0
        return (f - IMAGENET_DEFAULT_MEAN) / IMAGENET_DEFAULT_STD

    if is_train:
        def tf(img, py_rng: random.Random, np_rng: np.random.RandomState):
            interp = (py_rng.choice([INTER_LINEAR, INTER_CUBIC]) if interp_name == "random"
                      else _INTERP[interp_name])
            img = _random_resized_crop(img, size, interp, py_rng)
            if py_rng.random() < 0.5:
                img = img[:, ::-1]
            if config.AUG.AUTO_AUGMENT:
                img = _rand_augment(np.ascontiguousarray(img), py_rng)
            elif config.AUG.COLOR_JITTER:
                img = _color_jitter(img, config.AUG.COLOR_JITTER, py_rng)
            out = normalize(img)
            if config.AUG.REPROB > 0:
                out = _random_erasing(out, config.AUG.REPROB, py_rng, np_rng, config.AUG.REMODE)
            return out

        return tf

    crop = config.TEST.CROP
    interp = _INTERP.get(interp_name, INTER_CUBIC)

    def tf_eval(img, py_rng=None, np_rng=None):
        if crop:
            rs = int(size / 0.875)  # DEFAULT_CROP_PCT: resize, then the centre crop
            h, w = img.shape[:2]
            s = rs / min(h, w)
            img = cv_ops.resize(img, (int(round(w * s)), int(round(h * s))), interp)
            h, w = img.shape[:2]
            y, x = (h - size) // 2, (w - size) // 2
            img = img[y:y + size, x:x + size]
        else:
            img = cv_ops.resize(img, (size, size), interp)
        return normalize(img)

    return tf_eval


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


class ShardedBatchLoader:
    """Per-process deterministic shard (indices[rank::world_size]) with an
    epoch-seeded shuffle (default_rng(seed + epoch)), as bem_tpu's
    (data.py:265). It owns the augmentation generators, a random.Random
    and a RandomState seeded with ``aug_seed`` (unseeded when None), and
    hands them to the dataset item by item; they run on across epochs."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, rank: int = 0,
                 world_size: int = 1, seed: int = 0, drop_last: bool = True,
                 aug_seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.py_rng = random.Random(aug_seed)
        self.np_rng = np.random.RandomState(aug_seed)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(range(self.rank, len(self.dataset), self.world_size))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        idx = np.arange(self.rank, len(self.dataset), self.world_size)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        batch_imgs, batch_labels = [], []
        for i in idx:
            img, label = self.dataset.get(int(i), self.py_rng, self.np_rng)
            batch_imgs.append(img)
            batch_labels.append(label)
            if len(batch_imgs) == self.batch_size:
                yield (np.stack(batch_imgs).astype(np.float32),
                       np.asarray(batch_labels, np.int32))
                batch_imgs, batch_labels = [], []
        if batch_imgs and not self.drop_last:
            yield np.stack(batch_imgs).astype(np.float32), np.asarray(batch_labels, np.int32)


def build_dataset(is_train: bool, config):
    """(ImageFolderDataset of DATA_PATH/train or /val, 1000) (data.py:302)."""
    transform = build_transform(is_train, config)
    if config.DATA.DATASET != "imagenet":
        raise NotImplementedError(config.DATA.DATASET)
    root = os.path.join(config.DATA.DATA_PATH, "train" if is_train else "val")
    return ImageFolderDataset(root, transform), 1000


def build_loader(config, rank: int = 0, world_size: int = 1):
    """(dataset_train, dataset_val, loader_train, loader_val, mixup_active)
    (data.py:312): the train loader shuffles by SEED and draws its
    augmentations from generators seeded with SEED; the validation loader
    keeps the order and every image (its transform draws nothing).
    ``mixup_active`` is reported; nothing applies mixup, as in bem_tpu."""
    ds_train, _ = build_dataset(True, config)
    ds_val, _ = build_dataset(False, config)
    lt = ShardedBatchLoader(ds_train, config.DATA.BATCH_SIZE, True, rank, world_size,
                            config.SEED, aug_seed=config.SEED)
    lv = ShardedBatchLoader(
        ds_val, config.DATA.BATCH_SIZE, shuffle=bool(config.TEST.SHUFFLE),
        rank=rank if config.TEST.SEQUENTIAL else 0,
        world_size=world_size if config.TEST.SEQUENTIAL else 1, drop_last=False,
        aug_seed=config.SEED)
    mixup_active = (config.AUG.MIXUP > 0 or config.AUG.CUTMIX > 0
                    or config.AUG.CUTMIX_MINMAX is not None)
    return ds_train, ds_val, lt, lv, mixup_active
