"""PSNR / SSIM (/ LPIPS) between two folders of images (counterpart of
bem_tpu/enhancement/cal_metrics_with_imgs.py).

    python -m bem_tpu_torch.enhancement.cal_metrics_with_imgs --pred_dir P --gt_dir G \\
        [--lpips] [--GT_mean] [--device cuda]

The files pair in sorted order (the counts must agree) and are read by
the port's ``imread``. ``--GT_mean`` rescales each prediction by the
target's channel means over its own plus 1e-8, then clips, as bem_tpu
does. LPIPS runs on ``--device`` (the card unless ``cpu`` is asked for)
and needs ``BEM_LPIPS_WEIGHTS``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..metrics.psnr_ssim import calculate_psnr, calculate_ssim
from ..utils.img_util import imread
from .eval_uciqe_uiqm import EXTS


def main(args_list=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--lpips", action="store_true")
    p.add_argument("--GT_mean", action="store_true")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default) or cpu")
    args = p.parse_args(args_list)

    preds = sorted(f for f in os.listdir(args.pred_dir) if f.lower().endswith(EXTS))
    gts = sorted(f for f in os.listdir(args.gt_dir) if f.lower().endswith(EXTS))
    if len(preds) != len(gts):
        raise ValueError(f"{len(preds)} preds vs {len(gts)} gts")

    lpips_fn = None
    if args.lpips:
        from .lpips import LPIPS

        lpips_fn = LPIPS(device=args.device)

    psnrs, ssims, lpipss = [], [], []
    for pf, gf in zip(preds, gts):
        pred = imread(os.path.join(args.pred_dir, pf))
        gt = imread(os.path.join(args.gt_dir, gf))
        if args.GT_mean:
            pred = np.clip(pred * (gt.mean((0, 1), keepdims=True)
                                   / (pred.mean((0, 1), keepdims=True) + 1e-8)), 0, 1)
        psnrs.append(calculate_psnr(gt * 255, pred * 255, 0))
        ssims.append(calculate_ssim((gt * 255).round().astype(np.uint8),
                                    (pred * 255).round().astype(np.uint8), 0))
        if lpips_fn is not None:
            lpipss.append(float(lpips_fn(gt, pred)))

    print(f"PSNR: {np.mean(psnrs):.4f} dB")
    print(f"SSIM: {np.mean(ssims):.4f}")
    if lpipss:
        print(f"LPIPS: {np.mean(lpipss):.4f}")
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
    if lpipss:
        out["lpips"] = float(np.mean(lpipss))
    return out


if __name__ == "__main__":
    main()
