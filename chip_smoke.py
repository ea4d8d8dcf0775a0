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
     (the scans also on clamp-hitting inputs; linear_scan also at the
     scan pairs' backward shapes): max abs error beside its tolerance,
     and both versions' times;
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
     answering 3 requests; every kernel's launch count must be > 0.
The line before the last is the per-kernel JSON summary, the one before it
the card's name and power limit; the last line is {"ok": true, ...}.
Imports nothing of JAX or of bem_tpu.
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
from bem_tpu_torch.enhancement.pipeline import build_pipeline, padded_size
from bem_tpu_torch.models import build_model
from bem_tpu_torch.options import lolv1_options
from bem_tpu_torch.train import synthetic_batch

K = 16
NIMG = 2
H, W = 400, 600
N_REQUESTS = 3
N_TRAIN_STEPS = 5


def phase(name):
    print(f"== {name}", flush=True)


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
        for line in log.read_text().splitlines():
            spills = "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
            if "Used" in line or spills:
                print("  ptxas:", line.split("ptxas info    :")[-1].strip())


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
              f"plain {plain_ms:.3f} ms", flush=True)
        if not ok:
            raise AssertionError(f"{case.name} {case.label} {dt}: {err} > {tol}")
        if (case.label, dt) == smoke.HEADLINE[case.name] and case.name not in summary:
            bound, by = smoke.bound_ms(case)
            summary[case.name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound, bound_by=by, library_ms=None)
            print(f"  headline {case.name}: bound {bound:.4f} ms ({by})")
        torch.cuda.empty_cache()
    missing = set(smoke.KERNELS) - set(summary)
    if missing:
        raise AssertionError(f"no headline case for {sorted(missing)}")
    return summary


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
    if min(total.values()) <= 0:
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
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the serving path never launched: {counts}")
    med = statistics.median(times)
    print(f"pipeline K={K} NIMG={NIMG} {H}x{W} bf16: median {1e3 * med:.1f} ms/request, "
          f"{NIMG / med:.4f} images/s ({card})")
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
    phase("gradients vs plain compositions")
    compare_gradients()
    phase("reference checks")
    reference_check()
    train_reference_check()
    phase("training")
    train_counts = train_phase(card)
    phase("serving pipeline")
    serve_counts = serve(card)
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=train_counts[name] + serve_counts[name], **summary[name])
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
