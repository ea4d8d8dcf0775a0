"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the repository root with one card and no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
result line):
  1. card name and power limit (nvidia-smi); TF32 off for matmul and cuDNN
     (every phase but 9);
  2. build the CUDA kernels from bem_tpu_torch/csrc with nvcc (sm_90a, one
     nvcc per source, all started together) and load them;
  3. each of the seven kernels vs its plain PyTorch version on the card,
     at the serving path's and the training path's shapes, fp32 and bf16
     (the scans also on clamp-hitting inputs, the column pair's with its
     clamp probe, which must fail against the unclamped function;
     linear_scan also at the scan pairs' backward shapes), and the stem,
     the row pair, the gdMlp and the column pair's two passes at the
     serving batch (B=32, IE-L0 and IE-L1, the stem also IE-L2, bf16, the
     plain versions on slices of 4 images): max abs error beside its
     tolerance, and both versions' times; the tail in its path form
     (merged, with the residual, bf16) at the serving batch B=32 at
     IE-L0 / L1 / L2, and linear_scan at the serving path's carries (the
     IE-L0 row / column carry at B=32 and the CG's), forward and reverse,
     each with its bound; rows 1-7 at the eval CLI's shapes on the fp32
     stream (the IE levels at B=8, the CG's at B=1, the plain versions on
     slices of 4 images, no column probe at the CG's 7 rows; the stem's
     and the gdMlp's lines name the form that ran) and
     linear_scan at its carries (IE-L0 B=8, CG-L0 B=1), each with its
     bound; every linear_scan, stem and gdMlp case launched twice, its
     outputs bit-identical; then the stem, the row pair, the gdMlp, the
     column pair, the fused core's backward, selective_scan_fused,
     linear_scan and the tail at the edges of their tiles (smoke.edge_cases:
     chunk, super-chunk and tile remainders, K padding, C = 288 where the
     column chunk halves and the backward takes many channel blocks, the
     stem's and the gdMlp's CUDA-core forms above C = 256, a
     case each that only the bf16 lo halves of the stem's LN output and
     of the gdMlp's split weights carry, their fp32 tensor-core forms on a
     case each where every one of the three bf16 products carries a share of
     the output far above the fp32 tolerance, and on the eval CG's B = 1
     levels, where the gdMlp splits its hidden width over blocks and the
     stem deals its hidden chunks, each stem and gdMlp case launched twice,
     its output bit-identical, each line naming the form that ran
     (tensor-core or CUDA-core), linear_scan at L = 1, around its
     walk limit and chunk, over several anchor groups, at L = 2^20 and D =
     1 and 3072, the tail at C = 40, C_out != C, L = 1, a tile + 1 and off
     the vector width), checked only;
  4. gradients: each autograd wrapper of the VSSBlock (stem, gdMlp, tail,
     row pair, column pair) and linear_scan on the card vs its plain
     composition, at the training shapes, fp32;
  5. reference checks on small inputs: the fp32 serving pipeline at
     flagship widths on the card vs the same pipeline on the CPU; one IE
     and one CG train step at flagship widths (B=2, 32x32, fp32) on the
     card vs the CPU, same weights and injected noise;
  6. training: the IE (batch 8, 128x128) and the CG (batch 8, 8x8) trainers
     of the LOLv1 options at full width, 1 warm-up + 5 timed steps each;
     every kernel's launch count over the phase must be > 0;
  6b. the train and test CLIs at full width (bem_tpu_torch.train /
     bem_tpu_torch.test): 24 seeded 400x600 PNG pairs to train on (three
     batches of 8 an epoch: steps 2-3 show the loader's prefetch, step 4
     an epoch's first batch), two to validate on, the LOLv1 option files as
     they are, --force_yml only for the dataroots, the name, total_iter 4,
     print_freq 1, save_checkpoint_freq 2, val_freq 2, no tensorboard or
     wandb, 2 loader threads and an SSIM metric; for the IE and the CG:
     finite losses, the net_g / state / best_psnr files, finite PSNR / SSIM,
     then --auto_resume to total_iter 6 (it must start at iter 5 from
     net_g_4's exact params, at the 5th update's learning rate), then the
     test CLI on the last net_g (the last validation's PSNR), then a saved
     checkpoint's validation on the card against the CPU (the IE's on two
     120x180 images, the CG's on the val set: PSNR within 0.01 dB, SSIM
     within 1e-4); the device prefetcher's batches against the host's;
     each trainer's CLI ms/step and data_time, validation s/img; every
     kernel of the training path must launch over the phase;
  7. the flagship serving pipeline (n_feat 40, blocks (2,2,2), K=16, two
     400x600 images padded to 448x640, bf16 stream, seeded weights)
     answering 3 requests; every kernel of phases 6-7 must launch;
  8. the eval CLI (bem_tpu_torch.enhancement.eval) on the card and on the
     CPU: the LOLv1 option files (read by the port's parse) copied with
     noise_level 0, seeded weights, --deterministic, two seeded 112x176 PNG
     inputs with targets, K=2, in three modes (full reference with
     --GT_mean --Monte_Carlo, --no_ref niqe, --no_ref clip on a seeded
     ViT-B/32 bundle): the same candidate per image, the written PNGs
     within 1 LSB, PSNR within 0.01 dB, SSIM within 1e-4, NIQE within 0.05,
     CLIP scores within 1e-4;
  9. the eval CLI at full width on the card: three seeded 400x600 PNG
     inputs with targets, the LOLv1 option files as they are, seeded
     weights, K=16, parallel_num 8, the fp32 stream, in the same three
     modes; each mode's steady-state s/img, with TF32 at PyTorch's
     defaults (cuDNN convolutions in TF32, matmuls not), as a user runs
     the CLI; every kernel of phases 6-7 must launch;
 10. the VMamba classifier (VSSM, forward_type v2) at narrow width (embed
     16, depths (1,1), d_state 16, 32x32), fp32: logits and one train step
     on the card vs the CPU at B=1 (the fused core) and B=2 (its clamped
     form, as pick_group(2, d_inner) > 1 selects it), clamp-hitting biases;
 11. VMamba-T training (the harness defaults: depths (2,2,9,2), embed 96,
     d_state 16, batch 128, 224x224, fp32), 1 warm-up + 5 timed steps;
 12. VMamba-T throughput (bf16 images, fp32 params, batch 128), through the
     harness's throughput() (1 warm-up + 5 timed batches), and one
     forward's logits checked; the fused core and its backward must launch;
 13. the scan-pattern forward types: a narrow VSSM with forward_type v052d
     (logits and two train steps at B=2) and v051d (logits) on the card vs
     the CPU; VMamba-T v052d training at batch 8 (1 warm-up + 3 timed
     steps: the backward recomputes through the unfolded composition,
     whose (4 B, d_inner, L, d_state) fp32 tensors take 19.7 GB each at
     batch 128) and its bf16 throughput at batch 128; selective_scan_fused
     must launch 15 times per forward;
 14. the microbenchmarks (bem_tpu_torch.tools.microbench_vpu): the lanes /
     npass sweep and the four modes, each line as the tool prints it.
The kernels' phase also holds the three classifier kernels (the fused core,
its clamped form, its backward) and selective_scan_fused (scans 1 and 2
inputs) against their plain versions at the four VMamba-T stage shapes
(batch 2; the backward also at stage 0 and the training batch 128, the
fused core, its clamped form and selective_scan_fused at stages 0 and 2
and batch 128 bf16, the plain versions on slices of 4 images; every
backward case launched twice,
its outputs bit-identical), each output row against its own largest entry, with a clamp
probe (x zero at every other position of the clamped channels, where the
clamp changes y by a factor of e or more) held apart; each fused forward
must also fail that check against the plain version with the other clamp
setting (selective_scan_fused has no clamp: it must fail against the
clamped function). The fused forward's checkpoints (the state entering
every 32-position chunk, which the backward reads) are held against
``fused_checkpoints_plain`` at the four stage shapes, fp32 and bf16
streams, clamped and not, each (image, stream, direction, channel) row
over its chunks and states against its own largest entry, and must fail
against the other clamp setting. The two microbenchmark kernels are held
against their plain versions at every point of the tool's sweeps. The gradients' phase
holds the autograd wrappers. The line before the last is the per-kernel
JSON summary, the one before it the card's name and power limit; the last
line is {"ok": true, ...}. Imports nothing of JAX or of bem_tpu.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from bem_tpu_torch import _build, smoke
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.classification import build_model_from_config, get_config, make_trainer
from bem_tpu_torch.classification import synthetic_batch as cls_batch
from bem_tpu_torch.classification import throughput
from bem_tpu_torch.data import CPUPrefetcher, DevicePrefetcher, build_dataloader, build_dataset
from bem_tpu_torch.nn.ss2d import SS2D
from bem_tpu_torch.enhancement.eval import main as eval_main
from bem_tpu_torch.enhancement.pipeline import build_pipeline, padded_size
from bem_tpu_torch.models import build_model
from bem_tpu_torch.options import lolv1_options
from bem_tpu_torch.tools import microbench_vpu
from bem_tpu_torch.models.base_model import BaseModel
from bem_tpu_torch.test import test_pipeline
from bem_tpu_torch.train import synthetic_batch, train_pipeline
from bem_tpu_torch.utils.checkpoint import load_params
from bem_tpu_torch.utils.img_util import imread
from bem_tpu_torch.utils.options import parse

K = 16
NIMG = 2
H, W = 400, 600
N_REQUESTS = 3
N_TRAIN_STEPS = 5
CLS_BATCH = 128
# v052d trains at batch 8: its backward's unfolded composition would hold
# several 19.7 GB tensors per stage-0 SS2D at batch 128
SCAN_TRAIN_BATCH = 8
SCAN_TRAIN_STEPS = 3
T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
EVAL_DIR = os.path.join(REPO, "results", "chip_smoke_eval")  # gitignored, removed at the end
EVAL_OPTIONS = ("CG_UNet_LOLv1.yml", "IE_UNet_LOLv1.yml")
CLI_DIR = os.path.join(REPO, "results", "chip_smoke_cli")  # gitignored, removed at the end
CLI_TRAINERS = (("ImageEnhancer", "IE_UNet_LOLv1.yml"), ("ConditionGenerator", "CG_UNet_LOLv1.yml"))
CLI_TRAIN_IMAGES = 24  # three batches of 8 an epoch
SSIM = ["val:metrics:ssim:type=calculate_ssim", "val:metrics:ssim:crop_border=0"]
EVAL_MODES = {"full reference": ["--GT_mean", "--Monte_Carlo"], "niqe": ["--no_ref", "niqe"],
              "clip": ["--no_ref", "clip"]}
IMAGENET_TRAIN = 1281167  # images per epoch of the harness's schedule


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.0f} s)", flush=True)


def card_info() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def build_kernels():
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    print(f"built {so.name} in {time.perf_counter() - t0:.1f} s")
    for log in sorted(_build.BUILD_DIR.glob("nvcc*.log")):
        fn = ""
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:  # the kernel the next lines describe
                fn = line.split("'")[1] if "'" in line else ""
            spills = "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
            if "Used" in line or spills:
                print(f"  ptxas {fn[:72]}:", line.split("ptxas info    :")[-1].strip())


def compare_kernels():
    summary = {}
    for case in smoke.kernel_cases():
        err, tol = smoke.compare(case)
        ms = smoke.time_ms(case.fn, case.args)
        plain_ms = smoke.time_ms(case.plain, case.args)
        dt = str(case.dtype).replace("torch.", "")
        ok = err <= tol
        print(f"{case.name:15s} {case.label:34s} {dt:8s} max_abs_err {err:.3e} "
              f"tol {tol:.3e} {'ok' if ok else 'FAIL'}  kernel {ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms{_notes(case)}", flush=True)
        if not ok:
            raise AssertionError(f"{case.name} {case.label} {dt}: {err} > {tol}")
        if (case.label, dt) == smoke.HEADLINE[case.name] and case.name not in summary:
            bound, by = smoke.bound_ms(case)
            summary[case.name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound, bound_by=by, library_ms=None)
            print(f"  headline {case.name}: bound {bound:.4f} ms ({by})")
        elif case.plain_slice or case.report:  # a path shape: its bound beside its time
            bound, by = smoke.bound_ms(case)
            form = smoke.kernel_form(case)
            print(f"  path shape {case.name} {case.label}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})"
                  + (f", {form}" if form else ""))
        torch.cuda.empty_cache()
    missing = set(smoke.KERNELS) - set(summary)
    if missing:
        raise AssertionError(f"no headline case for {sorted(missing)}")
    return summary


def _notes(case):
    """The clamp check's and the repeat check's results, and the stem's and
    the gdMlp's form, where a case has them."""
    out = f"  {smoke.kernel_form(case)}" if smoke.kernel_form(case) else ""
    if case.other_clamp is not None:
        out += f"  vs other clamp err/tol {case.other_clamp:.3g}"
    if case.repeatable is not None:
        out += "  bit-identical over 2 launches" if case.repeatable else "  NOT repeatable"
    return out


def compare_edges():
    for case in smoke.edge_cases():
        err, tol = smoke.compare(case)
        dt = str(case.dtype).replace("torch.", "")
        ok = err <= tol
        print(f"{case.name:15s} {case.label:34s} {dt:8s} max_abs_err {err:.3e} "
              f"tol {tol:.3e} {'ok' if ok else 'FAIL'}{_notes(case)}", flush=True)
        if not ok:
            raise AssertionError(f"{case.name} {case.label} {dt}: {err} > {tol}")


def compare_checkpoints():
    for case in smoke.checkpoint_cases():
        err, tol, other = smoke.compare_checkpoints(case)
        dt = str(case.dtype).replace("torch.", "")
        ok = err <= tol
        print(f"checkpoints     {case.label:34s} {dt:8s} clamp {int(case.clamp)} max_abs_err "
              f"{err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}  vs other clamp err/tol "
              f"{other:.3g}", flush=True)
        if not ok:
            raise AssertionError(f"checkpoints {case.label} {dt} clamp {case.clamp}: {err} > {tol}")
        torch.cuda.empty_cache()


def compare_gradients():
    for case in smoke.grad_cases():
        err, tol = smoke.compare_grads(case)
        ok = err <= tol
        print(f"grad {case.name:15s} {case.label:28s} max_abs_err {err:.3e} tol {tol:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"gradient of {case.name} {case.label}: {err} > {tol}")
        torch.cuda.empty_cache()


def _inputs(nimg, Hp, Wp, dtype, device, seed):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.random((nimg, Hp, Wp, 3), np.float32))
    cond = torch.from_numpy(rng.random((nimg, Hp // 16, Wp // 16, 3), np.float32))
    return img.to(device, dtype), cond.to(device, dtype)


def reference_check():
    """Kernels (card) vs plain versions (CPU) through the whole pipeline."""
    h, w, k = 112, 176, 2
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = build_pipeline(nimg=NIMG, K=k, device=dev, dtype=torch.float32, seed=7,
                              H=h, W=w)
        img, cond = _inputs(NIMG, *padded_size(h, w), torch.float32, dev, seed=7)
        sel, best, scores = pipe(torch.Generator().manual_seed(11), img, cond)
        out[dev] = (sel.float().cpu(), best.cpu(), scores.float().cpu())
    (sg, bg, cg), (sc, bc, cc) = out["cuda"], out["cpu"]
    img_err = (sg - sc).abs().max().item()
    score_err = (cg - cc).abs().max().item()
    print(f"reference {h}x{w} K={k} fp32: selected-image max_abs_err {img_err:.3e} "
          f"(tol 1e-3), NIQE max_abs_err {score_err:.3e} (tol 0.05), "
          f"index card {bg.tolist()} cpu {bc.tolist()}")
    if not (img_err <= 1e-3 and score_err <= 0.05 and torch.equal(bg, bc)):
        raise AssertionError("pipeline on the card disagrees with the plain CPU run")


def _train_opt(model_type):
    return dict(lolv1_options(model_type), is_train=True)


def train_reference_check(devices=("cuda", "cpu")):
    """One IE and one CG step at flagship widths (B=2, 32x32, fp32) on the
    card vs the CPU from the same weights, noise and weight sample. Loss
    within 1e-4 relative; every gradient leaf within 1e-3 of its largest
    entry; the updated params within 1e-6 where |g| > 1e-2 max|g| of the
    leaf (Adam's first step is lr * sign(g) there), within 2 lr elsewhere."""
    rng = np.random.default_rng(3)
    img = lambda *s: torch.from_numpy(rng.random(s, np.float32))  # noqa: E731
    for mt in ("ImageEnhancer", "ConditionGenerator"):
        opt = _train_opt(mt)
        net_opt = dict(opt["network_g"])
        if mt == "ConditionGenerator":
            net_opt.update(bayesian=True, sigma_init=opt["sigma_init"])
            batch = {"lq_down": img(2, 32, 32, 3), "gt_down": img(2, 32, 32, 3)}
        else:
            batch = {"lq": img(2, 32, 32, 3), "gt": img(2, 32, 32, 3),
                     "gt_down": img(2, 8, 8, 3)}
        net = build_network(net_opt, torch.Generator().manual_seed(5))
        res = {}
        for dev in devices:
            m = build_model(opt, device=dev, net=copy.deepcopy(net))
            grads = {}
            apply = m._apply_updates
            m._apply_updates = lambda g, aux, apply=apply, grads=grads: (
                grads.update(g), apply(g, aux))[1]
            if mt == "ConditionGenerator":
                erng = np.random.default_rng(9)
                eps = {k: torch.from_numpy(erng.standard_normal(tuple(p.shape))
                                           .astype(np.float32))
                       for k, p in net.named_parameters()
                       if k.rpartition(".")[2].startswith("mu_")}
                logs = m.train_step(batch, eps=eps)
            else:
                noise = torch.from_numpy(np.random.default_rng(9).standard_normal(
                    batch["gt_down"].shape).astype(np.float32))
                logs = m.train_step(batch, noise=noise)
            res[dev] = (float(logs["l_total"]), {k: g.cpu() for k, g in grads.items()},
                        {k: p.detach().cpu() for k, p in m.params.items()})
        (lg, gg, pg), (lc, gc, pc) = (res[d] for d in devices)
        p0 = dict(net.named_parameters())
        lr = opt["train"]["optim_g"]["lr"]
        loss_rel = abs(lg - lc) / abs(lc)
        grad_err = max((gg[k] - gc[k]).abs().max().item() / max(gc[k].abs().max().item(), 1e-30)
                       for k in gc)
        param_err, param_far = 0.0, 0.0
        for k in pc:
            moved = (pg[k] - pc[k]).abs()
            clear = gc[k].abs() > 1e-2 * gc[k].abs().max()
            if clear.any():
                param_err = max(param_err, (moved[clear] / (1 + pc[k][clear].abs())).max().item())
            param_far = max(param_far, (moved - 2 * lr * (1 + 1e-4 * p0[k].detach().abs())
                                        ).max().item())
        print(f"train reference {mt} B=2 32x32 fp32: loss card {lg:.7f} cpu {lc:.7f} "
              f"(rel {loss_rel:.2e}, tol 1e-4); grads max err / leaf max {grad_err:.2e} "
              f"(tol 1e-3) over {len(gc)} leaves; params max rel err {param_err:.2e} "
              f"(tol 1e-6), beyond one step {max(param_far, 0.0):.2e} (tol 1e-6)", flush=True)
        if not (loss_rel <= 1e-4 and grad_err <= 1e-3 and param_err <= 1e-6
                and param_far <= 1e-6):
            raise AssertionError(f"{mt} train step on the card disagrees with the CPU")


def train_phase(card: str):
    """1 warm-up + N timed steps of each trainer at the LOLv1 shapes."""
    smoke.reset_launch_counts()
    counts = {}
    for mt, key in (("ImageEnhancer", "lq"), ("ConditionGenerator", "lq_down")):
        opt = _train_opt(mt)
        torch.cuda.reset_peak_memory_stats()
        model = build_model(opt, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        before = {k: p.detach().clone() for k, p in model.params.items()}
        times = []
        before_counts = smoke.launch_counts()
        for i in range(1 + N_TRAIN_STEPS):
            batch = synthetic_batch(opt, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = model.train_step(batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            loss, gn, lr = float(logs["l_total"]), float(logs["grad_norm"]), logs["lr"]
            print(f"{mt} step {i} ({'warm-up' if i == 0 else 'timed'}) "
                  f"{tuple(batch[key].shape)}: loss {loss:.6f} grad_norm {gn:.5f} "
                  f"lr {lr:.6e} {1e3 * dt:.1f} ms", flush=True)
            if not (np.isfinite(loss) and np.isfinite(gn)):
                raise AssertionError(f"{mt} step {i}: non-finite loss or grad norm")
            if i == 0:
                step_counts = {k: v - before_counts[k] for k, v in smoke.launch_counts().items()}
            else:
                times.append(dt)
        moved = sum(not torch.equal(before[k], p) for k, p in model.params.items())
        if moved == 0:
            raise AssertionError(f"{mt}: no parameter changed")
        med = statistics.median(times)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{mt} train B={opt['datasets']['train']['batch_size_per_gpu']} "
              f"{tuple(batch[key].shape[1:3])} fp32: median {1e3 * med:.1f} ms/step, "
              f"{1 / med:.3f} steps/s, peak memory {mem:.2f} GiB, "
              f"{moved}/{len(before)} params moved ({card})")
        print(f"{mt} launches per train step: {step_counts}")
        counts[mt] = step_counts
        del model
        torch.cuda.empty_cache()
    total = smoke.launch_counts()
    print(f"launches over the training phase: {total}")
    if min(total[k] for k in smoke.BEM_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the training path never launched: {total}")
    return total


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _test_options(name, root):
    """The option file with its train set removed: the test CLI validates
    on every dataset it is given."""
    with open(os.path.join(REPO, "Options", name)) as f:
        text = f.read()
    cut = re.sub(r"  train:\n(    .*\n)+", "", text)
    if cut == text:
        raise AssertionError(f"{name}: no train dataset block to remove")
    path = os.path.join(root, "test_" + name)
    with open(path, "w") as f:
        f.write(cut)
    return path


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _cli_run(name, args, root, lines):
    """train_pipeline on the option file ``name``; returns the trainer, its
    log lines, and the step, the params and the learning rate of its first
    update."""
    first = {}
    orig = BaseModel._apply_updates

    def record(self, grads, aux):
        if not first:
            first.update(step=self.step, params={k: p.detach().cpu().clone()
                                                 for k, p in self.params.items()})
        out = orig(self, grads, aux)
        first.setdefault("lr", out["lr"])
        return out

    del lines.lines[:]
    BaseModel._apply_updates = record
    try:
        model = train_pipeline(root, ["--opt", os.path.join(REPO, "Options", name), *args])
    finally:
        BaseModel._apply_updates = orig
    return model, list(lines.lines), first


def _check_validation(tag, res):
    psnr, ssim = res.get("psnr"), res.get("ssim")
    if not (np.isfinite(psnr) and np.isfinite(ssim) and -1 <= ssim <= 1):
        raise AssertionError(f"{tag}: bad validation PSNR / SSIM {res}")


def cli_phase(card: str):
    """The train and test CLIs at full width (phase 6b)."""
    root = CLI_DIR
    for sub, n, h, w, seed in (("train", CLI_TRAIN_IMAGES, H, W, 31), ("val", 2, H, W, 32),
                               ("small", 2, 120, 180, 33)):
        smoke.write_eval_images(os.path.join(root, sub), n, h, w, seed)
    data = lambda sub, phase: [  # noqa: E731
        f"datasets:{phase}:dataroot_gt={os.path.join(root, sub, 'target')}",
        f"datasets:{phase}:dataroot_lq={os.path.join(root, sub, 'input')}"]
    lines = _Lines()
    logging.getLogger("bem_tpu_torch").addHandler(lines)
    smoke.reset_launch_counts()
    try:
        for mt, opt_name in CLI_TRAINERS:
            short = opt_name.split("_")[0]
            exp = os.path.join(root, "experiments", f"smoke_{short}")
            common = ["--device", "cuda", "--force_yml", *data("train", "train"), *data("val", "val"),
                      f"name=smoke_{short}", "logger:print_freq=1", "logger:save_checkpoint_freq=2",
                      "val:val_freq=2", "logger:use_tb_logger=false", "logger:wandb:project=~",
                      "datasets:train:num_worker_per_gpu=2", *SSIM]
            model, log, _ = _cli_run(opt_name, common + ["train:total_iter=4"], root, lines)
            losses = [float(m) for line in log for m in re.findall(r"l_total: (\S+)", line)]
            files = {sub: sorted(os.listdir(os.path.join(exp, sub)))
                     for sub in ("models", "training_states")}
            best = [f for f in os.listdir(exp) if f.startswith("best_psnr_")]
            if not (len(losses) == 4 and np.isfinite(losses).all()):
                raise AssertionError(f"{mt} CLI: losses {losses}")
            want = {"models": [f"net_g_{i}.msgpack" for i in (2, 4, 5)],
                    "training_states": [f"{i}.state" for i in (2, 4, 5)]}
            if files != want or len(best) != 1 or model.step != 4:
                raise AssertionError(f"{mt} CLI: files {files} {best}, step {model.step}")
            _check_validation(f"{mt} CLI", model.metric_results)
            per_iter = ", ".join(f"{i}: {1e3 * wall:.1f} ({1e3 * data:.1f})"
                                 for i, _, data, wall in model.timings)
            in_epoch = model.timings[1:3]  # iter 1 builds and warms up; iter 4 starts epoch 1
            print(f"{mt} train CLI 4 iters B=8 fp32: losses {[f'{x:.5f}' for x in losses]}; "
                  f"validation {H}x{W} PSNR {model.metric_results['psnr']:.4f} SSIM "
                  f"{model.metric_results['ssim']:.4f}; wall ms/step (data_time ms) by iter "
                  f"{per_iter}; iters 2-3 (in an epoch) mean wall "
                  f"{1e3 * statistics.mean(t[3] for t in in_epoch):.1f} ms/step, data_time "
                  f"{1e3 * statistics.mean(t[2] for t in in_epoch):.1f} ms; iter 4 (an epoch's "
                  f"first batch) {1e3 * model.timings[3][3]:.1f} ms/step, data_time "
                  f"{1e3 * model.timings[3][2]:.1f} ms; files {files['models']} "
                  f"{files['training_states']} {best} ({card})", flush=True)

            # take up the last state (5.state, step 4) and go on to 6
            resumed, log, first = _cli_run(
                opt_name, common + ["train:total_iter=6", "--auto_resume"], root, lines)
            step, lr = first["step"], first["lr"]
            net4 = _leaves(load_params(os.path.join(exp, "models", "net_g_4.msgpack")))
            start = _leaves(state_dict_to_flax(resumed.net, first["params"]))
            same = all(np.array_equal(start[k], v) for k, v in net4.items()) and set(start) == set(net4)
            epoch = 4 // (CLI_TRAIN_IMAGES // 8)
            resumed_line = any(f"Resuming training from epoch: {epoch}, iter: 4." in x for x in log)
            lr_want = resumed.lr_schedule(4)
            print(f"{mt} auto-resume: first step iter {step + 1}, params bit-equal to net_g_4 "
                  f"{same}, lr {lr:.9e} (iter 5 of an unbroken run {lr_want:.9e}); ends at "
                  f"iter {resumed.step}, PSNR {resumed.metric_results['psnr']:.4f}", flush=True)
            if not (step == 4 and same and resumed_line and lr == lr_want and resumed.step == 6
                    and resumed.optimizer.count == 6):
                raise AssertionError(f"{mt}: the resumed run did not take up net_g_4 at iter 5")
            _check_validation(f"{mt} resumed CLI", resumed.metric_results)

            # validation s/img on the trainer the CLI returned (warm)
            val_opt = dict(parse(os.path.join(REPO, "Options", opt_name))["datasets"]["val"],
                           dataroot_gt=os.path.join(root, "val", "target"),
                           dataroot_lq=os.path.join(root, "val", "input"))
            loader = build_dataloader(build_dataset(val_opt), val_opt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resumed.validation(loader, 6)
            torch.cuda.synchronize()
            val_s = (time.perf_counter() - t0) / len(loader.dataset)
            print(f"{mt} validation {H}x{W} fp32 on the card: {val_s:.4f} s/img ({card})")

            # the test CLI on the last net_g, then card vs CPU on a saved checkpoint
            last = max(os.listdir(os.path.join(exp, "models")),
                       key=lambda f: int(re.search(r"(\d+)", f).group(1)))
            test_opts = _test_options(opt_name, root)

            def run_test(device, sub, ckpt):
                return test_pipeline(root, ["--opt", test_opts, "--device", device, "--force_yml",
                                            *data(sub, "val"), f"name=smoke_test_{short}_{sub}_{device}",
                                            f"path:pretrain_network_g={ckpt}", *SSIM]).metric_results

            tested = run_test("cuda", "val", os.path.join(exp, "models", last))
            dpsnr = abs(tested["psnr"] - resumed.metric_results["psnr"])
            print(f"{mt} test CLI on {last}: PSNR {tested['psnr']:.6f}, the train CLI's last "
                  f"validation {resumed.metric_results['psnr']:.6f} (diff {dpsnr:.2e}, tol 5e-5)")
            if not dpsnr <= 5e-5:
                raise AssertionError(f"{mt}: the test CLI does not give the last validation's PSNR")
            sub = "small" if mt == "ImageEnhancer" else "val"
            ckpt = os.path.join(exp, "models", "net_g_4.msgpack")
            g, c = run_test("cuda", sub, ckpt), run_test("cpu", sub, ckpt)
            dp, ds = abs(g["psnr"] - c["psnr"]), abs(g["ssim"] - c["ssim"])
            size = "120x180" if sub == "small" else f"{H}x{W}"
            print(f"{mt} validation of net_g_4 at {size}, card vs CPU: PSNR {g['psnr']:.6f} / "
                  f"{c['psnr']:.6f} (diff {dp:.2e}, tol 0.01 dB), SSIM {g['ssim']:.6f} / "
                  f"{c['ssim']:.6f} (diff {ds:.2e}, tol 1e-4)", flush=True)
            if not (dp <= 0.01 and ds <= 1e-4):  # NaN fails
                raise AssertionError(f"{mt}: validation on the card disagrees with the CPU")
            torch.cuda.empty_cache()

        # the device prefetcher: the host loader's batches, on the card
        host, dev = CPUPrefetcher(loader), DevicePrefetcher(loader)
        n = 0
        while (hb := host.next()) is not None:
            db = dev.next()
            for k, v in hb.items():
                if isinstance(v, np.ndarray) and not (db[k].is_cuda and np.array_equal(
                        db[k].cpu().numpy(), v)):
                    raise AssertionError(f"DevicePrefetcher batch {n} {k} differs")
            n += 1
        if n != len(loader) or dev.next() is not None:
            raise AssertionError("DevicePrefetcher yields another number of batches")
        print(f"DevicePrefetcher: {n} batches equal to the host loader's, on the card")
    finally:
        logging.getLogger("bem_tpu_torch").removeHandler(lines)
    counts = smoke.launch_counts()
    print(f"launches over the CLI phase: {counts}")
    if min(counts[k] for k in smoke.BEM_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the training path never launched in the CLIs: {counts}")
    return counts


def serve(card: str):
    pipe = build_pipeline(nimg=NIMG, K=K, device="cuda", dtype=torch.bfloat16, seed=0,
                          H=H, W=W)
    img, cond = _inputs(NIMG, *padded_size(H, W), torch.bfloat16, "cuda", seed=0)
    torch.cuda.synchronize()
    smoke.reset_launch_counts()
    times = []
    for i in range(N_REQUESTS):
        t0 = time.perf_counter()
        sel, best, scores = pipe(torch.Generator(device="cuda").manual_seed(100 + i),
                                 img, cond)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if sel.shape != (NIMG, H, W, 3) or not torch.isfinite(sel.float()).all():
            raise AssertionError(f"request {i}: bad output {tuple(sel.shape)}")
        if not ((best >= 0) & (best < K)).all() or not torch.isfinite(scores).all():
            raise AssertionError(f"request {i}: bad selection {best.tolist()}")
        print(f"request {i}: {1e3 * times[-1]:.1f} ms, chosen {best.tolist()}, "
              f"NIQE min {scores.min(0).values.tolist()}", flush=True)
    counts = smoke.launch_counts()
    print(f"launches over {N_REQUESTS} requests: {counts}")
    if min(counts[k] for k in smoke.BEM_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the serving path never launched: {counts}")
    med = statistics.median(times)
    print(f"pipeline K={K} NIMG={NIMG} {H}x{W} bf16: median {1e3 * med:.1f} ms/request, "
          f"{NIMG / med:.4f} images/s ({card})")
    return counts


def _eval_files(root, n, h, w, seed, noise_level=None):
    """n seeded low-light inputs with their targets (``smoke.write_eval_images``)
    and the LOLv1 option files, copied with ``noise_level`` where given.
    Returns the two option paths."""
    smoke.write_eval_images(root, n, h, w, seed)
    if noise_level is None:
        return [os.path.join(REPO, "Options", name) for name in EVAL_OPTIONS]
    paths = []
    for name in EVAL_OPTIONS:
        with open(os.path.join(REPO, "Options", name)) as f:
            text = f.read()
        if "noise_level: 0.1" not in text:
            raise AssertionError(f"{name}: no noise_level line to change")
        paths.append(os.path.join(root, name))
        with open(paths[-1], "w") as f:
            f.write(text.replace("noise_level: 0.1", f"noise_level: {noise_level}"))
    return paths


def _eval_args(opts, root, out, mode, device, K, P, extra=()):
    args = ["--opt", opts[0], "--cond_opt", opts[1], "--input_dir", os.path.join(root, "input"),
            "--result_dir", os.path.join(root, out), "--num_samples", str(K),
            "--parallel_num", str(P), "--seed", "5", "--device", device, *EVAL_MODES[mode],
            *extra]
    if mode == "full reference":
        args += ["--target_dir", os.path.join(root, "target")]
    return args


def eval_reference_check():
    """The eval CLI at flagship widths on the card vs the CPU (phase 8)."""
    root = os.path.join(EVAL_DIR, "reference")
    opts = _eval_files(root, 2, 112, 176, seed=21, noise_level=0)
    for mode in EVAL_MODES:
        out = {dev: f"{mode}_{dev}".replace(" ", "_") for dev in ("cuda", "cpu")}
        res = {dev: eval_main(_eval_args(opts, root, out[dev], mode, dev, 2, 8,
                                         ["--deterministic"])) for dev in out}
        g, c = res["cuda"], res["cpu"]
        written = {dev: [imread(os.path.join(root, out[dev], "dataset", f"{i}.png"),
                                float32=False).astype(int) for i in range(2)] for dev in out}
        lsb = max(int(np.abs(a - b).max()) for a, b in zip(written["cuda"], written["cpu"]))
        score_err = max(abs(a - b) for sg, sc in zip(g["scores"], c["scores"])
                        for a, b in zip(sg, sc))
        checks = [("written images max LSB", lsb, 1), ("selected", int(g["selected"] !=
                                                                    c["selected"]), 0)]
        if mode == "full reference":
            checks += [("PSNR dB", abs(g["psnr"] - c["psnr"]), 0.01),
                       ("SSIM", abs(g["ssim"] - c["ssim"]), 1e-4)]
        elif mode == "niqe":
            checks += [("NIQE", score_err, 0.05), ("mean NIQE", abs(g["niqe"] - c["niqe"]), 0.05)]
        else:
            checks += [("CLIP score", score_err, 1e-4)]
        print(f"eval reference {mode} 112x176 K=2 fp32: selected card {g['selected']} cpu "
              f"{c['selected']}; " + "; ".join(f"{n} {e:.3g} (tol {t:g})" for n, e, t in checks),
              flush=True)
        if not all(e <= t for _, e, t in checks):  # NaN fails
            raise AssertionError(f"eval {mode} on the card disagrees with the CPU")
        torch.cuda.empty_cache()


@contextlib.contextmanager
def torch_tf32_defaults():
    """PyTorch's own TF32 settings (cuDNN on, matmul off), restored after."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def eval_phase(card: str):
    """The eval CLI at full width on the card (phase 9): every BEM kernel
    must launch; each mode's steady-state s/img."""
    root = os.path.join(EVAL_DIR, "full")
    opts = _eval_files(root, 3, H, W, seed=22)
    smoke.reset_launch_counts()
    for mode in EVAL_MODES:
        before = smoke.launch_counts()
        res = eval_main(_eval_args(opts, root, mode.replace(" ", "_"), mode, "cuda", K, 8))
        scores = [v for s in res["scores"] for v in s]
        if not (all(0 <= i < K for i in res["selected"]) and len(scores) == 3 * K
                and np.isfinite(scores).all() and res["steady_s_per_img"]):
            raise AssertionError(f"eval {mode}: bad result {res}")
        if mode == "full reference" and not (np.isfinite(res["psnr"]) and 0 < res["ssim"] <= 1):
            raise AssertionError(f"eval {mode}: bad PSNR / SSIM {res}")
        for i in range(3):
            out = imread(os.path.join(root, mode.replace(" ", "_"), "dataset", f"{i}.png"))
            if out.shape != (H, W, 3):
                raise AssertionError(f"eval {mode}: output {i} has shape {out.shape}")
        counts = smoke.launch_counts()
        print(f"eval {mode} K={K} parallel_num 8 {H}x{W} fp32, TF32 defaults: steady-state "
              f"{res['steady_s_per_img']:.4f} s/img (median of images 2-3), selected "
              f"{res['selected']}; launches {[counts[k] - before[k] for k in smoke.BEM_KERNELS]}"
              f" ({card})", flush=True)
        torch.cuda.empty_cache()
    counts = smoke.launch_counts()
    print(f"launches over the eval phase: {counts}")
    if min(counts[k] for k in smoke.BEM_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the eval path never launched: {counts}")
    return counts


def _narrow_cls_config(forward_type="v2"):
    c = get_config()
    v = c.MODEL.VSSM
    v.EMBED_DIM, v.DEPTHS, v.SSM_D_STATE = 16, [1, 1], 16
    v.SSM_FORWARDTYPE = forward_type
    c.DATA.IMG_SIZE, c.MODEL.NUM_CLASSES, c.MODEL.DROP_PATH_RATE = 32, 10, 0.0
    return c


CLS_CORE = ("ss2d_dir_fused", "ss2d_dir_fused_g", "ss2d_dir_fused_bwd")


def cls_reference_check(forward_type="v2", batches=(1, 2), kernels=CLS_CORE):
    """The narrow VSSM on the card vs the CPU, same weights and batch, at
    each batch size (v2: B=1 the fused core, B=2 its clamped form): logits
    within 1e-4 of their largest; two train steps (the warmup schedule's
    first lr is 0): each loss within 1e-4 relative, every gradient leaf
    within 1e-3 of the leaf's max, the params after the second within 1e-5
    where both steps' |g| > 1e-2 max|g| of the leaf, and elsewhere within
    2 lr (1 + wd |p|), the most two AdamW steps can differ by. Each of
    ``kernels`` must launch."""
    c = _narrow_cls_config(forward_type)
    smoke.reset_launch_counts()
    for B in batches:
        model = build_model_from_config(c, torch.Generator().manual_seed(5))
        with torch.no_grad():  # every third channel's dt bias +12: dt*A < -10
            for m in model.modules():
                if isinstance(m, SS2D):
                    m.dt_projs_bias[:, ::3] = 12.0
        rng = np.random.default_rng(B)
        images = torch.from_numpy(rng.random((B, 32, 32, 3), np.float32))
        labels = torch.from_numpy(rng.integers(0, 10, B))
        res = {}
        for dev in ("cuda", "cpu"):
            m = copy.deepcopy(model).to(dev)
            with torch.no_grad():
                logits = m(images.to(dev)).cpu()
            state, train_step, _ = make_trainer(m, total_steps=10, base_lr=1e-3, device=dev)
            grads, losses = [], []
            step = state.optimizer.step
            state.optimizer.step = lambda p, g, step=step: (
                grads.append({k: v.cpu() for k, v in g.items()}), step(p, g))[1]
            for _ in range(2):
                state, loss = train_step(state, images, labels)
                losses.append(float(loss))
            res[dev] = (logits, losses, grads, state.logs["lr"],
                        {k: p.detach().cpu() for k, p in m.named_parameters()})
        (lg, sg, gg, lr, pg), (lc, sc, gc, _, pc) = res["cuda"], res["cpu"]
        logit_err = (lg - lc).abs().max().item() / lc.abs().max().item()
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(sg, sc))
        grad_err = max((g1[k] - g2[k]).abs().max().item() / max(g2[k].abs().max().item(), 1e-30)
                       for g1, g2 in zip(gg, gc) for k in g2)
        p0 = dict(model.named_parameters())
        param_err, param_far = 0.0, 0.0
        for k in pc:
            moved = (pg[k] - pc[k]).abs()
            clear = torch.ones_like(moved, dtype=torch.bool)
            for g in gc:
                clear &= g[k].abs() > 1e-2 * g[k].abs().max()
            if clear.any():
                param_err = max(param_err, (moved[clear] / (1 + pc[k][clear].abs())).max().item())
            param_far = max(param_far, (moved - 2 * lr * (1 + 0.05 * p0[k].detach().abs())
                                        ).max().item())
        print(f"classifier {forward_type} reference B={B} 32x32 fp32: logits err / max "
              f"{logit_err:.2e} "
              f"(tol 1e-4); losses card {sg} cpu {sc} (rel {loss_rel:.2e}, tol 1e-4); "
              f"grads max err / leaf max {grad_err:.2e} (tol 1e-3) over 2 x {len(gc[0])} "
              f"leaves; params after lr {lr:.1e}: max rel err {param_err:.2e} (tol 1e-5), "
              f"beyond two steps {max(param_far, 0.0):.2e} (tol 1e-6)", flush=True)
        if not (logit_err <= 1e-4 and loss_rel <= 1e-4 and grad_err <= 1e-3
                and param_err <= 1e-5 and param_far <= 1e-6 and lr > 0):
            raise AssertionError(f"classifier {forward_type} B={B} on the card disagrees "
                                 f"with the CPU")
    counts = smoke.launch_counts()
    print(f"launches over the classifier {forward_type} reference checks: {counts}")
    if min(counts[k] for k in kernels) <= 0:
        raise AssertionError(f"a classifier kernel never launched: {counts}")
    return counts


def cls_logits_check(forward_type, B=2):
    """The narrow VSSM's fp32 logits on the card vs the CPU (1e-4 of their
    largest), every third channel's dt bias +12."""
    model = build_model_from_config(_narrow_cls_config(forward_type),
                                    torch.Generator().manual_seed(6))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SS2D):
                m.dt_projs_bias[:, ::3] = 12.0
    images = torch.from_numpy(np.random.default_rng(8).random((B, 32, 32, 3), np.float32))
    smoke.reset_launch_counts()
    with torch.no_grad():
        lg = copy.deepcopy(model).to("cuda")(images.to("cuda")).cpu()
        lc = model(images)
    counts = smoke.launch_counts()
    err = (lg - lc).abs().max().item() / lc.abs().max().item()
    print(f"classifier {forward_type} reference B={B} 32x32 fp32: logits err / max {err:.2e} "
          f"(tol 1e-4); launches {counts}", flush=True)
    if not err <= 1e-4 or counts["selective_scan_fused"] <= 0:
        raise AssertionError(f"classifier {forward_type} on the card disagrees with the CPU")


def _cls_config(forward_type, batch):
    c = get_config()
    c.MODEL.VSSM.SSM_FORWARDTYPE = forward_type
    c.DATA.BATCH_SIZE = batch or c.DATA.BATCH_SIZE
    return c


def cls_train_phase(card: str, forward_type="v2", batch=None, steps=N_TRAIN_STEPS,
                    kernels=("ss2d_dir_fused", "ss2d_dir_fused_bwd")):
    """VMamba-T (the harness defaults, ``forward_type``) trained 1 + steps
    at ``batch`` (the config's 128 when None) on seeded synthetic batches,
    with the 300-epoch schedule of an ImageNet epoch at this batch. Each of
    ``kernels`` must launch."""
    c = _cls_config(forward_type, batch)
    steps_per_epoch = -(-IMAGENET_TRAIN // c.DATA.BATCH_SIZE)
    torch.cuda.reset_peak_memory_stats()
    model = build_model_from_config(c, torch.Generator().manual_seed(c.SEED))
    state, train_step, _ = make_trainer(
        model, total_steps=c.TRAIN.EPOCHS * steps_per_epoch, base_lr=c.TRAIN.BASE_LR,
        warmup_steps=c.TRAIN.WARMUP_EPOCHS * steps_per_epoch,
        weight_decay=c.TRAIN.WEIGHT_DECAY, label_smoothing=c.MODEL.LABEL_SMOOTHING,
        seed=c.SEED, device="cuda")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    smoke.reset_launch_counts()
    times = []
    for i in range(1 + steps):
        images, labels = cls_batch(c, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = train_step(state, images, labels)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss, gn, lr = float(loss), float(state.logs["grad_norm"]), state.logs["lr"]
        print(f"VMamba-T {forward_type} step {i} ({'warm-up' if i == 0 else 'timed'}) "
              f"{tuple(images.shape)}: "
              f"loss {loss:.6f} grad_norm {gn:.5f} lr {lr:.6e} {1e3 * dt:.1f} ms", flush=True)
        if not (np.isfinite(loss) and np.isfinite(gn)):
            raise AssertionError(f"VMamba-T step {i}: non-finite loss or grad norm")
        if i == 0:
            step_counts = smoke.launch_counts()
        else:
            times.append(dt)
    moved = sum(not torch.equal(before[k], p) for k, p in model.named_parameters())
    if moved == 0:
        raise AssertionError("VMamba-T: no parameter changed")
    med = statistics.median(times)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    B, S = c.DATA.BATCH_SIZE, c.DATA.IMG_SIZE
    print(f"VMamba-T {forward_type} train B={B} {S}x{S} fp32: median {1e3 * med:.1f} ms/step, "
          f"{B / med:.1f} images/s, peak memory {mem:.2f} GiB, "
          f"{moved}/{len(before)} params moved ({card})")
    counts = smoke.launch_counts()
    print(f"VMamba-T {forward_type} launches per train step: {step_counts}; "
          f"over the phase: {counts}")
    if min(counts[k] for k in kernels) <= 0:
        raise AssertionError(f"a kernel of the classifier's training path never launched: {counts}")
    del model, state
    torch.cuda.empty_cache()
    return counts


def cls_throughput_phase(card: str, forward_type="v2", kernels=("ss2d_dir_fused",)):
    """bf16 forward throughput of VMamba-T (``forward_type``) at batch 128
    (the harness's throughput(): 1 warm-up + 5 timed batches) and one more
    forward's logits, whose launches are those of one batch."""
    c = _cls_config(forward_type, None)
    model = build_model_from_config(c, torch.Generator().manual_seed(c.SEED)).to("cuda")
    smoke.reset_launch_counts()
    ips = throughput(model, batch=CLS_BATCH, size=c.DATA.IMG_SIZE, iters=N_TRAIN_STEPS)
    before = smoke.launch_counts()
    x = cls_batch(c, torch.Generator(device="cuda").manual_seed(2))[0].to(torch.bfloat16)
    with torch.no_grad():
        logits = model(x)
    torch.cuda.synchronize()
    if logits.shape != (CLS_BATCH, c.MODEL.NUM_CLASSES) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"VMamba-T throughput: bad logits {tuple(logits.shape)}")
    counts = smoke.launch_counts()
    per_batch = {k: v - before[k] for k, v in counts.items() if v - before[k]}
    print(f"VMamba-T {forward_type} throughput B={CLS_BATCH} "
          f"{c.DATA.IMG_SIZE}x{c.DATA.IMG_SIZE} bf16: {ips:.1f} images/s, "
          f"{1e3 * CLS_BATCH / ips:.1f} ms/batch ({card}); logits {logits.dtype} finite, "
          f"|max| {logits.float().abs().max().item():.4f}")
    print(f"VMamba-T {forward_type} launches per batch: {per_batch}; over the throughput "
          f"phase: {counts}")
    if min(counts[k] for k in kernels) <= 0:
        raise AssertionError(f"a kernel never launched in the throughput phase: {counts}")
    del model
    torch.cuda.empty_cache()
    return counts


def microbench_phase():
    """The tool's two sweeps, each line as it prints it; both kernels must launch."""
    smoke.reset_launch_counts()
    microbench_vpu.sweep()
    microbench_vpu.sweep_modes()
    counts = smoke.launch_counts()
    print(f"launches over the microbenchmark sweeps: "
          f"{ {k: counts[k] for k in smoke.MICROBENCH_KERNELS} }")
    if min(counts[k] for k in smoke.MICROBENCH_KERNELS) <= 0:
        raise AssertionError(f"a microbenchmark kernel never launched: {counts}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase("card")
    card = card_info()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    phase("build")
    build_kernels()
    phase("kernels vs plain versions")
    summary = compare_kernels()
    phase("kernel edge cases vs plain versions")
    compare_edges()
    phase("fused forward checkpoints vs plain")
    compare_checkpoints()
    phase("gradients vs plain compositions")
    compare_gradients()
    phase("reference checks")
    reference_check()
    train_reference_check()
    phase("training")
    train_counts = train_phase(card)
    phase("train and test CLIs at full width")
    try:
        cli_counts = cli_phase(card)
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    phase("serving pipeline")
    serve_counts = serve(card)
    os.makedirs(EVAL_DIR, exist_ok=True)
    try:
        os.environ["BEM_CLIP_NPZ"] = smoke.write_clip_bundle(
            os.path.join(EVAL_DIR, "clip_vitb32.npz"), seed=0)
        phase("eval CLI reference checks")
        eval_reference_check()
        phase("eval CLI at full width")
        with torch_tf32_defaults():
            eval_counts = eval_phase(card)
    finally:
        shutil.rmtree(EVAL_DIR, ignore_errors=True)
    phase("classifier reference checks")
    cls_ref_counts = cls_reference_check()
    phase("classifier training")
    cls_train_counts = cls_train_phase(card)
    phase("classifier throughput")
    cls_tp_counts = cls_throughput_phase(card)
    phase("scan-pattern classifier reference checks")
    cls_reference_check("v052d", (2,), ("selective_scan_fused", "linear_scan"))
    cls_logits_check("v051d")
    phase("scan-pattern classifier training")
    scan_train_counts = cls_train_phase(card, "v052d", SCAN_TRAIN_BATCH, SCAN_TRAIN_STEPS,
                                        ("selective_scan_fused", "linear_scan"))
    phase("scan-pattern classifier throughput")
    scan_tp_counts = cls_throughput_phase(card, "v052d", ("selective_scan_fused",))
    phase("microbenchmarks")
    mb_counts = microbench_phase()
    # each kernel's launches over the runs of its own paths: the BEM kernels
    # over the training, train / test CLI, serving and eval runs, the fused core and its backward
    # over VMamba-T's, the clamped form over the narrow reference runs,
    # selective_scan_fused over VMamba-T v052d's, the microbenchmarks over
    # their sweeps
    paths = {name: (train_counts, cli_counts, serve_counts, eval_counts)
             for name in smoke.BEM_KERNELS}
    paths.update(ss2d_dir_fused=(cls_train_counts, cls_tp_counts),
                 ss2d_dir_fused_bwd=(cls_train_counts, cls_tp_counts),
                 ss2d_dir_fused_g=(cls_ref_counts,),
                 selective_scan_fused=(scan_train_counts, scan_tp_counts),
                 vpu_scan_step=(mb_counts,), vpu_op_rounds=(mb_counts,))
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=sum(c[name] for c in paths[name]), **summary[name])
               for name, (_, _, src, rep) in smoke.KERNELS.items()]
    print(f"chip_smoke: {time.perf_counter() - t_start:.0f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
