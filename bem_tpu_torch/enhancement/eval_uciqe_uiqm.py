"""The mean UCIQE and UIQM over a folder of images (counterpart of
bem_tpu/enhancement/eval_uciqe_uiqm.py).

    python -m bem_tpu_torch.enhancement.eval_uciqe_uiqm IMG_DIR [--device cuda]

The images (PNG, 24-bit BMP or baseline JPEG, in sorted order) are read
by the port's ``imread``; both metrics are taken on the full-size image,
on ``--device`` (the card unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..metrics.uciqe_uiqm import uciqe_batch, uiqm_batch
from ..utils.img_util import imread

EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif")


def get_average_UCIQE_and_UIQM(img_dir: str, device="cuda"):
    uciqes, uiqms = [], []
    for name in sorted(os.listdir(img_dir)):
        if not name.lower().endswith(EXTS):
            continue
        rgb = torch.from_numpy(imread(os.path.join(img_dir, name), float32=False))
        rgb = rgb[None].to(device)
        uciqes.append(float(uciqe_batch(rgb)[0]))
        uiqms.append(float(uiqm_batch(rgb)[0]))
    return float(np.mean(uciqes)), float(np.mean(uiqms))


def main(args_list=None):
    p = argparse.ArgumentParser(
        description="Calculate average UCIQE and UIQM for a directory of images.")
    p.add_argument("img_dir", type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default) or cpu")
    args = p.parse_args(args_list)
    uciqe, uiqm = get_average_UCIQE_and_UIQM(args.img_dir, torch.device(args.device))
    print(f"Average UCIQE: {uciqe:.4f}")
    print(f"Average UIQM: {uiqm:.4f}")
    return uciqe, uiqm


if __name__ == "__main__":
    main()
