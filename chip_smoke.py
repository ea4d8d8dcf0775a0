"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the repository root with one card and no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
result line):
  1. card name and power limit (nvidia-smi); TF32 off for matmul and cuDNN;
  2. build the CUDA kernels from bem_tpu_torch/csrc with nvcc (sm_90a, one
     nvcc per source, all started together) and load them;
  3. each of the seven kernels vs its plain PyTorch version on the card,
     at the serving path's and the training path's shapes, fp32 and bf16
     (the scans also on clamp-hitting inputs, the column pair's with its
     clamp probe, which must fail against the unclamped function;
     linear_scan also at the scan pairs' backward shapes), and the row
     pair, the gdMlp and the column pair's two passes at the serving
     batch (B=32, IE-L0 and IE-L1, bf16, the plain versions on slices of
     4 images): max abs error beside its tolerance, and both versions'
     times; then the row pair, the gdMlp, the column pair and the fused
     core's backward at the edges of their tiles (smoke.edge_cases: chunk
     and tile remainders, C = 288 where the column chunk halves and the
     backward takes many channel blocks, the gdMlp's CUDA-core form on
     bf16 above C = 256, and a case that only the bf16 lo halves of its
     split weights carry), checked only;
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
  7. the flagship serving pipeline (n_feat 40, blocks (2,2,2), K=16, two
     400x600 images padded to 448x640, bf16 stream, seeded weights)
     answering 3 requests; every kernel of phases 6-7 must launch;
  8. the VMamba classifier (VSSM, forward_type v2) at narrow width (embed
     16, depths (1,1), d_state 16, 32x32), fp32: logits and one train step
     on the card vs the CPU at B=1 (the fused core) and B=2 (its clamped
     form, as pick_group(2, d_inner) > 1 selects it), clamp-hitting biases;
  9. VMamba-T training (the harness defaults: depths (2,2,9,2), embed 96,
     d_state 16, batch 128, 224x224, fp32), 1 warm-up + 5 timed steps;
 10. VMamba-T throughput (bf16 images, fp32 params, batch 128), through the
     harness's throughput() (1 warm-up + 5 timed batches), and one
     forward's logits checked; the fused core and its backward must launch;
 11. the scan-pattern forward types: a narrow VSSM with forward_type v052d
     (logits and two train steps at B=2) and v051d (logits) on the card vs
     the CPU; VMamba-T v052d training at batch 8 (1 warm-up + 3 timed
     steps: the backward recomputes through the unfolded composition,
     whose (4 B, d_inner, L, d_state) fp32 tensors take 19.7 GB each at
     batch 128) and its bf16 throughput at batch 128; selective_scan_fused
     must launch 15 times per forward;
 12. the microbenchmarks (bem_tpu_torch.tools.microbench_vpu): the lanes /
     npass sweep and the four modes, each line as the tool prints it.
The kernels' phase also holds the three classifier kernels (the fused core,
its clamped form, its backward) and selective_scan_fused (scans 1 and 2
inputs) against their plain versions at the four VMamba-T stage shapes
(batch 2; the backward also at stage 0 and the training batch 128, its
plain version on slices of 4 images; every backward case launched twice,
its outputs bit-identical), each output row against its own largest entry, with a clamp
probe (x zero at every other position of the clamped channels, where the
clamp changes y by a factor of e or more) held apart; each fused forward
must also fail that check against the plain version with the other clamp
setting (selective_scan_fused has no clamp: it must fail against the
clamped function). The two microbenchmark kernels are held against their
plain versions at every point of the tool's sweeps. The gradients' phase
holds the autograd wrappers. The line before the last is the per-kernel
JSON summary, the one before it the card's name and power limit; the last
line is {"ok": true, ...}. Imports nothing of JAX or of bem_tpu.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from bem_tpu_torch import _build, smoke
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.classification import build_model_from_config, get_config, make_trainer
from bem_tpu_torch.classification import synthetic_batch as cls_batch
from bem_tpu_torch.classification import throughput
from bem_tpu_torch.nn.ss2d import SS2D
from bem_tpu_torch.enhancement.pipeline import build_pipeline, padded_size
from bem_tpu_torch.models import build_model
from bem_tpu_torch.options import lolv1_options
from bem_tpu_torch.tools import microbench_vpu
from bem_tpu_torch.train import synthetic_batch

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
        elif case.plain_slice:  # the serving / training batch: its bound beside its time
            bound, by = smoke.bound_ms(case)
            print(f"  large batch {case.name} {case.label}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
        torch.cuda.empty_cache()
    missing = set(smoke.KERNELS) - set(summary)
    if missing:
        raise AssertionError(f"no headline case for {sorted(missing)}")
    return summary


def _notes(case):
    """The clamp check's and the repeat check's results, where a case has them."""
    out = ""
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
    phase("gradients vs plain compositions")
    compare_gradients()
    phase("reference checks")
    reference_check()
    train_reference_check()
    phase("training")
    train_counts = train_phase(card)
    phase("serving pipeline")
    serve_counts = serve(card)
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
    # over the serving and training runs, the fused core and its backward
    # over VMamba-T's, the clamped form over the narrow reference runs,
    # selective_scan_fused over VMamba-T v052d's, the microbenchmarks over
    # their sweeps
    paths = {name: (train_counts, serve_counts) for name in smoke.BEM_KERNELS}
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
