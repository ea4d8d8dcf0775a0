"""Two-stage Bayesian enhancement evaluation (counterpart of
bem_tpu/enhancement/eval.py; reference: Enhancement/eval.py).

    python -m bem_tpu_torch.enhancement.eval --opt CG.yml --weights cg.msgpack \\
        --cond_opt IE.yml --cond_weights ie.msgpack --input_dir ... --target_dir ... \\
        [--num_samples 200] [--no_ref niqe|clip|uiqm_uciqe [--uiqm_weight 1.0]] [--GT_mean]
        [--Monte_Carlo] [--device cuda]

The protocol of bem_tpu's CLI, flag for flag: reflect-pad to a multiple
of 4 * scale, the /16 bilinear (or KDE-histogram) condition input, K
Stage-I forwards each with its own Bayesian weight sample (or on mu under
``--deterministic``), clamp, the optional GT-mean rescale and condition
noise, the x16 bilinear upsample and Stage II on cat(input, condition)
in ``parallel_num`` chunks, candidate scoring (NIQE, CLIP-IQA, weighted
UIQM + UCIQE or weighted PSNR + SSIM), argmax selection, the optional
Monte-Carlo mean, ranked candidate dumps and result.txt. Checkpoints are
bem_tpu's ``.msgpack`` files; inputs are PNG, 24-bit BMP or baseline
JPEG. One difference: the GT-mean rescales divide by a mean floored at
float32's smallest normal, so a channel that is black everywhere stays
black; bem_tpu's 0 / 0 turns it, and everything after it, into NaN.

It runs on the card (``--device cuda``, the default) through the port's
kernels, or on the CPU through their plain versions when asked. Not
ported: ``--shard_samples on`` raises NotImplementedError (ROADMAP §1).
"""

from __future__ import annotations

import argparse
import os
import re
import time
from glob import glob

import numpy as np
import torch
from torch.func import functional_call
from torch.profiler import record_function

from ..archs import build_network
from ..convert import load_flax_params
from ..metrics.niqe import BLOCK, niqe_batch_rgb
from ..metrics.psnr_ssim import calculate_psnr, calculate_ssim
from ..metrics.uciqe_uiqm import uiqm_uciqe_batch
from ..nn.layers import sample_bayes
from ..ops.resize import resize_bilinear
from ..utils.checkpoint import load_params
from ..utils.histogram import histogram_condition
from ..utils.img_util import downsample, imread, imwrite
from ..utils.options import parse

IMAGE_EXTS = ("png", "jpg", "bmp", "tif")  # bem_tpu's glob
RGB2GRAY = np.array([0.299, 0.587, 0.114], np.float32)  # cv2.COLOR_RGB2GRAY
# floor of the means the GT-mean rescales divide by: an all-black channel
# (mean 0) stays black where bem_tpu's 0 / 0 makes it NaN
TINY = float(np.finfo(np.float32).tiny)


def natsorted(paths):
    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]

    return sorted(paths, key=key)


def pad_img(inp: np.ndarray, factor: int) -> np.ndarray:
    """Reflect-pad H, W up to multiples of factor (eval.py:146-153)."""
    h, w = inp.shape[0], inp.shape[1]
    padh = (factor - h % factor) % factor
    padw = (factor - w % factor) % factor
    if padh or padw:
        inp = np.pad(inp, ((0, padh), (0, padw), (0, 0)), "reflect")
    return inp


def build_parser():
    p = argparse.ArgumentParser(description="Bayesian two-stage enhancement eval")
    p.add_argument("--result_dir", default="./results/", type=str)
    p.add_argument("--input_dir", default="", type=str)
    p.add_argument("--target_dir", default="", type=str)
    p.add_argument("--opt", type=str, required=True, help="Stage-I (CG) YAML")
    p.add_argument("--cond_opt", type=str, required=True, help="Stage-II (IE) YAML")
    p.add_argument("--weights", default="", type=str)
    p.add_argument("--cond_weights", default="", type=str)
    p.add_argument("--dataset", default="dataset", type=str)
    p.add_argument("--GT_mean", action="store_true")
    p.add_argument("--num_samples", default=200, type=int)
    p.add_argument("--Monte_Carlo", action="store_true")
    p.add_argument("--psnr_weight", default=1.0, type=float)
    p.add_argument("--no_ref", default="", type=str,
                   choices=["", "clip", "niqe", "uiqm_uciqe"])
    p.add_argument("--uiqm_weight", default=1.0, type=float)
    p.add_argument("--lpips", action="store_true")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--parallel_num", default=8, type=int)
    p.add_argument("--seed", default=287128, type=int)
    p.add_argument("--clip_prompts", nargs="+",
                   default=["brightness", "noisiness", "quality"])
    p.add_argument("--save_candidates", action="store_true",
                   help="dump all K candidates ranked by score")
    p.add_argument("--shard_samples", default="auto", choices=["auto", "on", "off"],
                   help="auto / off: one device; on (K sharded over GPUs) is not ported")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the port's kernels) or cpu (their plain versions)")
    return p


def _build_net(opt_path, weights, bayesian, device):
    opt = parse(opt_path, is_train=False)
    network_opt = dict(opt["network_g"])
    if bayesian:
        network_opt["bayesian"] = True
        network_opt.setdefault("sigma_init", opt.get("sigma_init", 0.05))
    seed = int(opt.get("manual_seed", 0) or 0)
    net = build_network(network_opt, torch.Generator().manual_seed(seed))
    if weights:
        load_flax_params(net, load_params(weights, "params"))
    else:
        print(f"[eval] WARNING: no weights for {opt_path}; using seeded "
              "random init — outputs are NOT meaningful enhancement")
    return opt, net.to(device).eval()


def make_k_pipeline(net, cond_net, *, K, P, cond_type, noise_level):
    """The K-candidate pipeline ``k_candidates(gen, inp, cond_in,
    target_mean, use_gt_mean, stochastic) -> (K, Hp, Wp, 3)``.

    inp (1, Hp, Wp, 3) is the padded input, cond_in (1, hc, wc, C) the
    condition input, target_mean (1, 1, 1, 3), all on the nets' device;
    ``gen``, a generator on that device, draws the K weight samples and the
    condition noise. The CG runs K times (bem_tpu vmaps them), the IE on
    chunks of P candidates. ``eps`` (K dicts of weight noise, see
    ``sample_bayes``) and ``noise`` (K, hc, wc, C) replace the draws. The
    two stages are the profiler ranges ``eval.cg`` and ``eval.ie``."""

    @torch.inference_mode()
    def k_candidates(gen, inp, cond_in, target_mean, use_gt_mean: bool, stochastic: bool,
                     eps=None, noise=None):
        with record_function("eval.cg"):
            if stochastic:
                conds = torch.cat([
                    functional_call(net, sample_bayes(net, gen, None if eps is None else eps[k]),
                                    (cond_in,))[-1] for k in range(K)])
            else:  # every sample runs on mu
                conds = net(cond_in)[-1].expand(K, -1, -1, -1)
            conds = conds.clamp(0.0, 1.0)
            if use_gt_mean and cond_type != "histogram":
                mean_pred = conds.mean(dim=(1, 2), keepdim=True).clamp_min(TINY)
                conds = (conds * (target_mean / mean_pred)).clamp(0.0, 1.0)
            if noise_level:
                if noise is None:
                    noise = torch.randn(conds.shape, generator=gen, device=gen.device)
                conds = conds + noise_level * noise.to(conds.device)
        with record_function("eval.ie"):
            hp, wp = inp.shape[1], inp.shape[2]
            preds = []
            for i in range(0, K, P):
                chunk = conds[i:i + P]
                up = resize_bilinear(chunk, size=(hp, wp))
                x = torch.cat([inp.expand(chunk.shape[0], -1, -1, -1), up], dim=-1)
                preds.append(cond_net(x)[-1])
            return torch.cat(preds, dim=0)

    return k_candidates


def _gray_mean(img: np.ndarray) -> np.float32:
    """Mean of cv2.cvtColor(img, COLOR_RGB2GRAY) on float32."""
    return (img[..., 0] * RGB2GRAY[0] + img[..., 1] * RGB2GRAY[1]
            + img[..., 2] * RGB2GRAY[2]).mean()


def _images(directory):
    return natsorted(sum((glob(os.path.join(directory, f"*.{e}")) for e in IMAGE_EXTS), []))


def _ssim_u8(target, img):
    return calculate_ssim((target * 255).round().astype(np.uint8),
                          (img * 255).round().astype(np.uint8), 0)


def main(args_list=None):
    args = build_parser().parse_args(args_list)
    if args.shard_samples == "on":
        raise NotImplementedError("--shard_samples on (the K samples over several GPUs) is "
                                  "not ported (ROADMAP §1, multi-GPU)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (use --device cpu for the plain "
                           "versions)")
    np.random.seed(args.seed)

    opt, net = _build_net(args.opt, args.weights, True, device)
    cond_opt, cond_net = _build_net(args.cond_opt, args.cond_weights, False, device)
    scale_factor = opt["condition"].get("scale_down", 0) + opt["condition"].get(
        "hist_patch_size", 0)
    cond_type = opt["condition"]["type"]
    noise_level = cond_opt["condition"].get("noise_level", 0)

    result_dir = os.path.join(args.result_dir, args.dataset)
    os.makedirs(result_dir, exist_ok=True)
    input_paths = _images(args.input_dir)
    target_paths = _images(args.target_dir) if args.target_dir else []
    if not input_paths:
        raise ValueError("No input images found")

    K = args.num_samples
    P = max(1, min(args.parallel_num, K))

    clip_scorer = None
    if args.no_ref == "clip":
        from .clip_iqa import ClipIQA

        clip_scorer = ClipIQA(tuple(args.clip_prompts), device=device)
    lpips_fn = None
    if args.lpips:
        from .lpips import LPIPS

        lpips_fn = LPIPS(device=device)

    k_candidates = make_k_pipeline(net, cond_net, K=K, P=P, cond_type=cond_type,
                                   noise_level=noise_level)

    psnr_l, ssim_l, lpips_l, niqe_l, uiqm_l, uciqe_l = [], [], [], [], [], []
    mc_psnr, mc_ssim = [], []
    selected, all_scores = [], []  # per image: the chosen candidate and the K scores
    niqe_dev = {}  # NIQE scorer per candidate size
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)

    per_img_s = []  # wall seconds per image; [0] pays the kernel builds
    for p_idx, inp_path in enumerate(input_paths):
        t_img = time.perf_counter()
        img = imread(inp_path)
        h, w = img.shape[:2]
        target = imread(target_paths[p_idx]) if target_paths else None
        img_pad = pad_img(img, 4 * scale_factor)
        if cond_type == "mean":
            cond_in = downsample(img_pad, scale_factor)
        else:
            cond_in = histogram_condition(img_pad, opt["condition"]["hist_patch_size"],
                                          opt["condition"]["num_bins"])
        tmean = torch.from_numpy(np.asarray(
            np.mean(target, axis=(0, 1), keepdims=True)[None] if target is not None
            else np.ones((1, 1, 1, 3)), np.float32)).to(device)
        use_gt_mean = args.GT_mean and target is not None

        cands = k_candidates(
            gen, torch.from_numpy(img_pad[None]).to(device),
            torch.from_numpy(np.ascontiguousarray(cond_in[None])).to(device), tmean,
            use_gt_mean=use_gt_mean, stochastic=not args.deterministic)
        cands = cands[:, :h, :w, :].clamp(0.0, 1.0)  # (K, h, w, 3)
        if use_gt_mean:
            mp = cands.mean(dim=(1, 2), keepdim=True).clamp_min(TINY)
            cands = (cands * (tmean / mp)).clamp(0.0, 1.0)

        # ---- scoring + selection on all K candidates -------------------------
        # NIQE, CLIP and UIQM + UCIQE score on the device (UCIQE's 256 counts
        # of L an image come to the host); all K candidates come to the host
        # only for PSNR / SSIM, the Monte-Carlo mean or --save_candidates
        scores, _idx = None, 0
        if args.no_ref == "niqe":
            if h < BLOCK or w < BLOCK:
                raise ValueError(f"NIQE needs one {BLOCK}x{BLOCK} block; the candidates are "
                                 f"{h}x{w}")
            if (h, w) not in niqe_dev:
                niqe_dev[(h, w)] = niqe_batch_rgb(h, w)
            vals = niqe_dev[(h, w)](cands).tolist()
            _idx = int(np.argmin(vals))
            niqe_l.append(vals[_idx])
            scores = [-v for v in vals]
        elif args.no_ref == "clip":
            scores = clip_scorer.score(cands).tolist()
            _idx = int(np.argmax(scores))
        elif args.no_ref == "uiqm_uciqe":
            uiqms, uciqes = (v.tolist() for v in uiqm_uciqe_batch(cands))
            combined = (args.uiqm_weight * np.array(uiqms) / max(uiqms)
                        + (1 - args.uiqm_weight) * np.array(uciqes) / max(uciqes))
            _idx = int(np.argmax(combined))
            uiqm_l.append(uiqms[_idx])
            uciqe_l.append(uciqes[_idx])
            scores = combined.tolist()
        need_all = args.save_candidates or (target is not None
                                            and (not args.no_ref or args.Monte_Carlo))
        preds = cands.cpu().numpy() if need_all else None
        if not args.no_ref and target is not None:
            psnrs = [calculate_psnr(target * 255, p * 255, 0) for p in preds]
            ssims = [_ssim_u8(target, p) for p in preds]
            combined = (args.psnr_weight * np.array(psnrs) / max(psnrs)
                        + (1 - args.psnr_weight) * np.array(ssims) / max(ssims))
            _idx = int(np.argmax(combined))
            scores = combined.tolist()
        best = preds[_idx] if need_all else cands[_idx].cpu().numpy()
        selected.append(_idx)
        all_scores.append(None if scores is None else [float(v) for v in scores])

        if target is not None:
            psnr_l.append(calculate_psnr(target * 255, best * 255, 0))
            ssim_l.append(_ssim_u8(target, best))
            if lpips_fn is not None:
                lpips_l.append(float(lpips_fn(target, best)))
            if args.Monte_Carlo:
                mc = np.clip(preds.mean(axis=0), 0, 1)
                if args.GT_mean:
                    mc = np.clip(mc * (_gray_mean(target) / max(_gray_mean(mc), TINY)), 0, 1)
                mc_psnr.append(calculate_psnr(target * 255, mc * 255, 0))
                mc_ssim.append(_ssim_u8(target, mc))

        name = os.path.splitext(os.path.basename(inp_path))[0]
        imwrite((best * 255).round().astype(np.uint8), os.path.join(result_dir, f"{name}.png"))
        if args.save_candidates and scores is not None:
            for rank in np.argsort(scores)[::-1]:
                imwrite((preds[rank] * 255).round().astype(np.uint8),
                        os.path.join(result_dir, f"{float(scores[rank]):.2f}.png"))
        per_img_s.append(time.perf_counter() - t_img)
        print(f"[{p_idx + 1}/{len(input_paths)}] {name} ({per_img_s[-1]:.3f} s)", flush=True)

    print(f"running time: {time.perf_counter() - t0:.4f} sec")
    if len(per_img_s) > 1:
        # the first image pays the kernel builds; the median over the rest
        # is the steady state
        steady = per_img_s[1:]
        print(f"steady-state: {float(np.median(steady)):.4f} sec/img "
              f"(n={len(steady)}, first {per_img_s[0]:.1f} s)")

    with open(os.path.join(result_dir, "result.txt"), "w") as f:
        def emit(label, values, fmt="{:.4f}"):
            if values:
                line = f"{label}: {fmt.format(float(np.mean(values)))}"
                print(line)
                f.write(line + " \n")

        emit("Best_PSNR", psnr_l, "{:.4f} dB")
        emit("Best_SSIM", ssim_l)
        emit("Best_lpips", lpips_l)
        emit("Best_NIQE", niqe_l)
        emit("Best_UIQM", uiqm_l)
        emit("Best_UCIQE", uciqe_l)
        emit("MC_PSNR", mc_psnr, "{:.4f} dB")
        emit("MC_SSIM", mc_ssim)
    return {
        "psnr": float(np.mean(psnr_l)) if psnr_l else None,
        "ssim": float(np.mean(ssim_l)) if ssim_l else None,
        "niqe": float(np.mean(niqe_l)) if niqe_l else None,
        "uiqm": float(np.mean(uiqm_l)) if uiqm_l else None,
        "uciqe": float(np.mean(uciqe_l)) if uciqe_l else None,
        "steady_s_per_img": float(np.median(per_img_s[1:])) if len(per_img_s) > 1 else None,
        "per_image_s": per_img_s,
        "selected": selected,
        "scores": all_scores,
    }


if __name__ == "__main__":
    main()
