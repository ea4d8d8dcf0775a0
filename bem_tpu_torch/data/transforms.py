"""Paired crops and geometric augmentations (counterpart of
bem_tpu/data/transforms.py), HWC numpy on the host. Each function draws
from the ``np.random.Generator`` it is given in bem_tpu's order, so a
seeded dataset yields bem_tpu's crops and flips.
"""

from __future__ import annotations

import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W to multiples of ``scale`` (transforms.py:10)."""
    if img.ndim not in (2, 3):
        raise ValueError(f"Wrong img ndim: {img.ndim}")
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % scale or None, : w - w % scale or None, ...]


def paired_random_crop(img_gts, img_lqs, gt_patch_size: int, scale: int, gt_path=None,
                       rng: np.random.Generator = None):
    """One random crop at the same place of every GT (``gt_patch_size``) and
    LQ (``gt_patch_size // scale``) image (transforms.py:19): top, then left."""
    rng = rng or np.random.default_rng()
    squeeze_gt, squeeze_lq = not isinstance(img_gts, list), not isinstance(img_lqs, list)
    img_gts = [img_gts] if squeeze_gt else img_gts
    img_lqs = [img_lqs] if squeeze_lq else img_lqs
    h_lq, w_lq = img_lqs[0].shape[:2]
    h_gt, w_gt = img_gts[0].shape[:2]
    lq_patch_size = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(
            f"Scale mismatches. GT ({h_gt},{w_gt}) is not {scale}x of LQ ({h_lq},{w_lq}).")
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f"LQ ({h_lq},{w_lq}) is smaller than patch size ({lq_patch_size},"
                         f"{lq_patch_size}). Path: {gt_path}.")
    top = int(rng.integers(0, h_lq - lq_patch_size + 1))
    left = int(rng.integers(0, w_lq - lq_patch_size + 1))
    img_lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...] for v in img_lqs]
    top_gt, left_gt = top * scale, left * scale
    img_gts = [v[top_gt:top_gt + gt_patch_size, left_gt:left_gt + gt_patch_size, ...]
               for v in img_gts]
    return (img_gts[0] if squeeze_gt else img_gts), (img_lqs[0] if squeeze_lq else img_lqs)


def augment(imgs, hflip: bool = True, rotation: bool = True, flows=None,
            return_status: bool = False, rng: np.random.Generator = None):
    """hflip, vflip and a transpose, each with p = 0.5 and drawn in that
    order, applied alike to every image and to every (H, W, 2) flow map in
    ``flows`` (transforms.py:57): flipping a flow negates the flipped
    component, the transpose swaps dx and dy. Returns the images, then the
    flows where given, else the (hflip, vflip, rot90) status where
    ``return_status``."""
    rng = rng or np.random.default_rng()
    hflip = hflip and rng.random() < 0.5
    vflip = rotation and rng.random() < 0.5
    rot90 = rotation and rng.random() < 0.5

    def _augment(img):
        if hflip:
            img = img[:, ::-1, ...]
        if vflip:
            img = img[::-1, :, ...]
        if rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return np.ascontiguousarray(img)

    def _augment_flow(flow):
        flow = np.array(flow, copy=True)
        if hflip:
            flow = flow[:, ::-1]
            flow[:, :, 0] = -flow[:, :, 0]
        if vflip:
            flow = flow[::-1, :]
            flow[:, :, 1] = -flow[:, :, 1]
        if rot90:
            flow = flow.transpose(1, 0, 2)[:, :, [1, 0]]
        return np.ascontiguousarray(flow)

    def _each(fn, xs):
        return fn(xs) if not isinstance(xs, list) else [fn(x) for x in xs]

    imgs = _each(_augment, imgs)
    if flows is not None:
        return imgs, _each(_augment_flow, flows)
    if return_status:
        return imgs, (hflip, vflip, rot90)
    return imgs


def data_augmentation(image: np.ndarray, mode: int) -> np.ndarray:
    """The 8 flips and rotations of a square's symmetry group (transforms.py:108)."""
    if not 0 <= mode <= 7:
        raise ValueError("Invalid choice of image transformation")
    out = np.rot90(image, k=mode // 2) if mode // 2 else image
    if mode % 2:
        out = np.flipud(out)
    return np.ascontiguousarray(out)


def random_augmentation(*args, rng: np.random.Generator = None):
    """One random variant of ``data_augmentation`` applied to all inputs
    (transforms.py:131)."""
    rng = rng or np.random.default_rng()
    mode = int(rng.integers(0, 8))
    return [data_augmentation(a, mode) for a in args]
