"""QD decomposition evaluation (counterpart of bem_tpu/qd/evaluate.py):

    python -m bem_tpu_torch.qd.evaluate --model_type model4 [--weights ckpt.msgpack] \\
        --low_dir ... --high_dir ... [--out_dir results/qd_eval] [--lpips]
        [--save_components] [--device cuda|cpu]

Each pair is cropped to even sizes; the low image's reconstruction (the
clipped Hamilton product of the decomposition) is scored by PSNR on float
x 255 and SSIM on uint8, LPIPS with ``--lpips`` (``BEM_LPIPS_WEIGHTS``), and
the RCI over the low -> high blends. Without ``--weights`` the shipped
checkpoint of ``--model_type`` is used. ``--save_components`` writes Q1, Q2
and the reconstruction as RGB PNGs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..convert import load_flax_params
from ..metrics import calculate_psnr, calculate_ssim
from ..ops.quaternion import hamilton_product
from ..utils.checkpoint import msgpack_restore
from ..utils.img_util import imread, imwrite
from .convert import load_decomp_params
from .models import Decomp
from .rci import compute_rci


def load_qd_net(model_type: str, weights: str = "", device="cuda") -> Decomp:
    """A ``Decomp`` with the params of ``weights`` (a flax msgpack, its params
    at the top or under "params"), else the shipped checkpoint."""
    if weights:
        with open(weights, "rb") as f:
            params = msgpack_restore(f.read())
        if "params" in params:
            params = params["params"]
    else:
        params = load_decomp_params(model_type)
    return load_flax_params(Decomp(model_type), params).to(device).eval()


def main(args_list=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_type", default="model4")
    p.add_argument("--weights", default="",
                   help="msgpack params; default: shipped converted checkpoint")
    p.add_argument("--low_dir", required=True)
    p.add_argument("--high_dir", required=True)
    p.add_argument("--out_dir", default="results/qd_eval")
    p.add_argument("--lpips", action="store_true")
    p.add_argument("--save_components", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(args_list)

    net = load_qd_net(args.model_type, args.weights, args.device)
    lpips_fn = None
    if args.lpips:
        from ..enhancement.lpips import LPIPS

        lpips_fn = LPIPS(device=args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    lows = sorted(os.listdir(args.low_dir))
    highs = sorted(os.listdir(args.high_dir))
    psnrs, ssims, lpipss, rcis = [], [], [], []
    with torch.no_grad():
        for lname, hname in zip(lows, highs):
            low = imread(os.path.join(args.low_dir, lname))
            high = imread(os.path.join(args.high_dir, hname))
            h, w = low.shape[0] // 2 * 2, low.shape[1] // 2 * 2
            low, high = low[:h, :w], high[:h, :w]

            x = torch.from_numpy(np.ascontiguousarray(low)).to(args.device).permute(2, 0, 1)[None]
            q1, q2 = net(x)
            recon = np.clip(hamilton_product(q1, q2)[0, 1:].permute(1, 2, 0).cpu().numpy(), 0, 1)
            psnrs.append(calculate_psnr(low * 255, recon * 255, 0))
            ssims.append(calculate_ssim((low * 255).round().astype(np.uint8),
                                        (recon * 255).round().astype(np.uint8), 0))
            if lpips_fn is not None:
                lpipss.append(float(lpips_fn(low, recon)))
            rcis.append(float(compute_rci(net, low, high, device=args.device)))

            if args.save_components:
                base = os.path.splitext(lname)[0]
                comps = (("Q1", q1[0, 1:].permute(1, 2, 0).cpu().numpy()),
                         ("Q2", q2[0, 1:].permute(1, 2, 0).cpu().numpy()), ("recon", recon))
                for tag, arr in comps:
                    imwrite((np.clip(arr, 0, 1) * 255).round().astype(np.uint8),
                            os.path.join(args.out_dir, f"{base}_{tag}.png"))

    print(f"recon PSNR: {np.mean(psnrs):.3f} dB")
    print(f"recon SSIM: {np.mean(ssims):.4f}")
    if lpipss:
        print(f"LPIPS: {np.mean(lpipss):.4f}")
    print(f"RCI: {np.mean(rcis):.4f}")
    with open(os.path.join(args.out_dir, "result.txt"), "w") as f:
        f.write(f"PSNR: {np.mean(psnrs):.3f}\nSSIM: {np.mean(ssims):.4f}\n"
                f"RCI: {np.mean(rcis):.4f}\n")
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
           "rci": float(np.mean(rcis))}
    if lpipss:
        out["lpips"] = float(np.mean(lpipss))
    return out


if __name__ == "__main__":
    main()
