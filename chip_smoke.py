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
     each with its bound; rows 1-7 at the eval CLI's and the flagship's
     shapes on the fp32 stream (the IE levels at B=8, the flagship's
     branch levels 224x320 / 112x160 / 56x80 at B=8, the CG's at B=1,
     the plain versions on
     slices of 4 images, no column probe at the CG's 7 rows; the stem's
     and the gdMlp's lines name the form that ran) and
     linear_scan at its carries (IE-L0 B=8, CG-L0 B=1, flagship L0 B=8), each with its
     bound; rows 1-7 the same at the flagship's training shapes (its
     branch levels 64x64 / 32x32 / 16x16 at B=8, linear_scan at their row
     and column carries and their backward recompute shape) and at the
     speed test's (smoke.SPEED_SHAPES: the IE's 2048x2048 / 1024x1024 /
     512x512 and the CG's 128x128 / 64x64 / 32x32 levels at B=1, fp32 and
     bf16, linear_scan at the IE-L0 row and column carries), and
     linear_scan at the cascade SS2D's shapes (smoke.CASCADE_SHAPES:
     VMamba-T v052dc's four stages, (B*H, W, 2*d_inner) at B = 2 and 128,
     forward and reverse, each with its bound); every linear_scan, stem and gdMlp case launched twice, its
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
     1 and 3072, at the cascade's few short walks (L = 7 at D = 3072, L =
     56 at D = 384, D = 770), the tail at C = 40, C_out != C, L = 1, a tile + 1 and off
     the vector width), checked only;
  4. gradients: each autograd wrapper of the VSSBlock (stem, gdMlp, tail,
     row pair, column pair) and linear_scan on the card vs its plain
     composition, at the training shapes, fp32, and linear_scan also at the
     cascade's stage-0 row scan for two images, forward and reverse;
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
  9b. the flagship, DecompDualBranchDDWavelet, from its option file as it
     is (n_feat 40, blocks (2,2,2), gdMlp, QD model4): a net_g written by
     the port (seeded init, then load_frozen of model4); its forward on a
     2x128x192 input on the card vs the CPU (TF32 off, 2e-4 of max(1,
     |plain|)); the eval CLI with it as the IE (--cond_weights) on one
     112x176 image, card vs CPU (noise 0, --deterministic, K=2, niqe: the
     same pick, the PNG within 1 LSB); the eval CLI at 400x600, K=16,
     parallel_num 8, niqe on three seeded PNGs with TF32 at PyTorch's
     defaults (s/img) and the IE's forward at batch 8 on 448x640 (ms);
     the test CLI on two 400x600 validation images (PSNR / SSIM); every
     kernel of rows 1-7 must launch over the phase;
  9c. the flagship's and the QD decomposition's training at full width
     (random VGG19 features, BEM_ALLOW_RANDOM_VGG=1): one flagship
     ImageEnhancer step (B=2, 32x32, fp32, TF32 off) with the perceptual
     loss, a MaskGenerator mask and mixup at an injected lam, on the card vs
     the CPU from the same weights and noise, the CPU on the card's VGG
     ReLU and max-pool decisions (loss and perceptual term within 1e-4
     relative, every gradient leaf within 1e-3 of its largest entry,
     decomp unchanged on both, at most 1e-4 of the CPU's own VGG
     decisions differing from the card's); the train CLI on the flagship's
     option file as it is (perceptual_opt and mim on; --force_yml for the
     dataroots, the name, total_iter 6, the frequencies, and no
     tensorboard or wandb) on 48 + 2 seeded 400x600 PNG pairs (six
     batches an epoch): finite l_pix / l_percep, the net_g and .state
     files (the .state in multi_transform's layout), finite validation
     PSNR / SSIM, then --auto_resume to 8 from net_g_6's exact params at
     iter 7; ms/step and data_time (median of iters 2-6), peak memory;
     train_qd (model4, patch 256, batch 8, 2 epochs, recon_only_epochs 1)
     on the same pairs: finite losses and validation, ms/step of each
     objective (median of its epoch's steps after the first),
     model4_1.msgpack loaded by the port's Decomp;
     qd.evaluate on the two validation pairs with the shipped model4 and
     with that checkpoint (PSNR, SSIM, RCI), the shipped model4 also on the
     CPU (RCI within 1e-4, PSNR within 0.01 dB); every kernel of rows 1-7
     must launch over the CLI runs;
  9d. the VMUNet family, the UIQM + UCIQE eval and reference checkpoints at
     full width (random VGG19 features): the JPEG decoder on the committed
     fixtures (bem_tpu_torch/testdata) against the PNGs of cv2's decodes
     beside them, with its host ms at 400x600; one ImageEnhancer step of
     TwoBranch_1 (TunedModel) and TwoBranch_3 (FusedTunedModel) from their
     option files (B=2, 32x32, fp32, TF32 off, perceptual loss and mask)
     on the card vs the CPU, the CPU on the card's VGG decisions (as 9c);
     the train CLI on both option files as they are (B=8, 128x128, mim,
     perceptual) on 48 + 2 seeded 400x600 PNG pairs, 6 iters and the one
     validation at the end (ms/step and data_time, median of iters 2-6;
     peak memory), then the test CLI on net_g_6 (the validation's PSNR);
     the eval CLI with the LOLv1 CG and each TwoBranch IE at 400x600, K=16,
     parallel_num 8, on two committed JPEG fixtures, --no_ref uiqm_uciqe
     (--uiqm_weight 0.5) and --no_ref niqe, TF32 defaults (s/img), the
     CPU's scorer on the card's K=16 candidates of one image (within 1e-5
     relative for UIQM and 1e-8 for UCIQE), the scorer alone at K=16 (ms),
     the CLI again on the card and the CPU on a 112x176 crop of a fixture
     (K=4, noise 0, the same injected weight noise: the same pick, the
     written PNGs within 1 LSB, the scorer as above); eval_uciqe_uiqm
     (card vs CPU) and cal_metrics_with_imgs on an output folder; every
     kernel of rows 1-7 must launch over the CLI runs; then
     reference-layout ckpt.pth files of the LOLv1 CG (Bayesian mu / rho)
     and IE, seeded, through convert_network_checkpoint: the forward
     equals the source net's on the CPU and agrees card vs CPU (2e-4);
  9e. image formats at full width: a folder of 400x600 files, one of each
     of progressive 4:2:0 JPEG and CMYK JPEG (committed beside the PNGs of
     cv2's decodes), LZW TIFF, 16-bit Deflate TIFF, 8-bit palette BMP, RLE8
     BMP and interlaced 16-bit PNG (the lossless ones written here by
     utils/image_writers.py over seeded arrays); each decode equal to its
     truth (the PNG, or the array under the rule the CPU tests pinned) and
     its host ms (median of 3); the eval CLI (LOLv1 CG and IE, --no_ref
     niqe, K=16, fp32) over the folder, s/img per file; card vs CPU on
     112x176 crops of two of the files (a TIFF and an RLE8 BMP, K=4, noise
     0, the same injected weight noise: the same picks, the written PNGs
     within 1 LSB); the train CLI for 4 iters on 8 pairs of progressive
     JPEG inputs (the committed file) and LZW TIFF targets
     (Dataset_PairedImage_Mask): data_time and ms/step; rows 1-7 must launch
     over the phase's CLI runs;
 10. the speed-test CLI (bem_tpu_torch.enhancement.speed_test) from the
     LOLv1 option files (n_feat 40, blocks (2,2,2), seeded): both bodies on
     the card vs the CPU at 256x256, fp32, four injected CG weight samples
     (the same pick, the scores and IE outputs within 2e-4 of max(1,
     |cpu|)); then ``main`` at 2048x2048, --repeat 3 in sequence and
     --speedup --repeat 16, bf16 and fp32: each mode's running time and peak
     memory; rows 1-7 must launch over the runs (the kernels' phase holds
     them at the speed test's shapes, smoke.SPEED_SHAPES);
 10b. the Network and training options at full width: two option files
     written from the LOLv1 ones, (a) the IE with ConvDown / DeconvUp,
     drop_path 0.1, relu last, Adam, MultiStepRestartLR after a 2-step
     warm-up and CombinedLoss (random VGG19 features), (b) the Bayesian CG
     with FFNv02, SAM, TrueCosineAnnealingLR, PSNRLoss and 256 crops (its
     blocks unfolded: no stem or gdMlp kernel); for each, one train step
     card vs CPU (train_step_check, every gradient leaf within 1e-5 of its
     largest entry) and the train CLI for 6 iters on 48 + 2 seeded 400x600
     PNG pairs (losses, validation, ms/step and data_time, median of iters
     2-6, peak memory); rows 1-7 (rows 2, 3, 5, 6, 7 for (b)) must launch;
 11. the VMamba classifier (VSSM, forward_type v2) at narrow width (embed
     16, depths (1,1), d_state 16, 32x32), fp32: logits and one train step
     on the card vs the CPU at B=1 (the fused core) and B=2 (its clamped
     form, as pick_group(2, d_inner) > 1 selects it), clamp-hitting biases;
 12. VMamba-T training (the harness defaults: depths (2,2,9,2), embed 96,
     d_state 16, batch 128, 224x224, fp32), 1 warm-up + 5 timed steps;
 13. VMamba-T throughput (bf16 images, fp32 params, batch 128), through the
     harness's throughput() (1 warm-up + 5 timed batches), and one
     forward's logits checked; the fused core and its backward must launch;
 14. the scan-pattern forward types: a narrow VSSM with forward_type v052d
     (logits and two train steps at B=2) and v051d (logits) on the card vs
     the CPU; VMamba-T v052d training at batch 8 (1 warm-up + 3 timed
     steps: the backward recomputes through the unfolded composition,
     whose (4 B, d_inner, L, d_state) fp32 tensors take 19.7 GB each at
     batch 128) and its bf16 throughput at batch 128; selective_scan_fused
     must launch 15 times per forward;
 14b. every SS2D mode and VSSM option: (a) at narrow width (embed 16,
     depths (1,1), d_state 16, 32x32, fp32, TF32 off) on the card vs the
     CPU from the same weights, the logits (1e-4 of their largest) and one
     train step's gradients (cross-entropy; each leaf within 1e-5 of its
     largest) of VSSMs with forward_type v052dc and v052dc_noz (the
     cascade: linear_scan), m0_noz and m0 with its gate and act_layer gelu
     (the SSD scan, plain tensor code), v05 with each of the five other
     out-norms (none, dwconv3, cnorm, softmax, sigmoid: the clamped fused
     core at B=2 and its backward), v05_noz_oact at B=1 (the unclamped
     core), and posembed with SSM dropout 0.2 (the keep masks drawn once
     and given to both) and init v2; BackboneVSSM's four outputs (depths
     (1,1,1,1)); a windowed VSSBlock (grid_size 8 on 28x28, so it pads,
     with SSM dropout and drop-path masks given) with and without
     use_checkpoint, whose gradients on the card must agree (1e-6);
     linear_scan and rows 8-10 must launch; (b) VMamba-T (bem_tpu's
     vmamba_tiny fields: depths (2,2,5,2), embed 96, d_state 1, ssm_ratio 2,
     v3 downsampling, v2 patch embedding) at 224x224 with forward_type
     v052dc_noz, then m0_noz: bf16 throughput at batch 128 through
     throughput() (1 warm-up + 5 timed batches), then training at the
     largest power-of-two batch up to 128 whose peak memory, extrapolated
     from one step at batch 8, stays under 60 GB (1 warm-up + 3 timed
     steps): ms/step and peak memory beside the card's name and power
     limit; linear_scan must launch in the v052dc_noz runs, and the m0_noz
     runs launch no kernel of the port (printed);
 15. the microbenchmarks (bem_tpu_torch.tools.microbench_vpu): the lanes /
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
against their plain versions at every point of the tool's sweeps, and
vpu_scan_step must give the same bits over two launches. The gradients' phase
holds the autograd wrappers. The line before the last is the per-kernel
JSON summary, the one before it the card's name and power limit; the last
line is {"ok": true, ...}. Imports nothing of JAX or of bem_tpu.
"""

from __future__ import annotations

import contextlib
import copy
import io
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
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.classification import build_model_from_config, get_config, make_trainer
from bem_tpu_torch.classification import synthetic_batch as cls_batch
from bem_tpu_torch.classification import cross_entropy, throughput, vmamba_tiny
from bem_tpu_torch.data import CPUPrefetcher, DevicePrefetcher, build_dataloader, build_dataset
from bem_tpu_torch.nn import BackboneVSSM, VSSBlock, init
from bem_tpu_torch.nn.ss2d import SS2D
from bem_tpu_torch.qd.evaluate import load_qd_net
from bem_tpu_torch.qd.evaluate import main as qd_evaluate
from bem_tpu_torch.qd.train import train_qd
import bem_tpu_torch.enhancement.eval as eval_module
from bem_tpu_torch.enhancement import speed_test
from bem_tpu_torch.archs.convert_network import convert_network_checkpoint
from bem_tpu_torch.enhancement.cal_metrics_with_imgs import main as cal_metrics
from bem_tpu_torch.enhancement.eval import main as eval_main
from bem_tpu_torch.enhancement.eval_uciqe_uiqm import main as folder_uciqe_uiqm
from bem_tpu_torch.metrics.uciqe_uiqm import uiqm_uciqe_batch
from bem_tpu_torch.enhancement.pipeline import build_pipeline, padded_size
from bem_tpu_torch.models import build_model
from bem_tpu_torch.options import lolv1_options
from bem_tpu_torch.tools import microbench_vpu
from bem_tpu_torch.models.base_model import BaseModel
from bem_tpu_torch.test import test_pipeline
from bem_tpu_torch.train import synthetic_batch, train_pipeline
from bem_tpu_torch.utils.checkpoint import load_params, load_state
from bem_tpu_torch.utils.image_writers import (encode_bmp_palette, encode_png_samples,
                                               encode_tiff)
from bem_tpu_torch.utils.img_util import imdecode, imread, imwrite
from bem_tpu_torch.utils.mask import MaskGenerator
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
FLAGSHIP_OPTION = "DecompDualBranch2DDWavelet_4.yml"
FLAGSHIP_DIR = os.path.join(REPO, "results", "chip_smoke_flagship")  # gitignored, removed at the end
FLAGSHIP_TIMED = 3  # IE forwards timed at batch 8, after one warm-up
FLAGSHIP_TRAIN_DIR = os.path.join(REPO, "results", "chip_smoke_flagship_train")  # removed at the end
# six batches of 8 an epoch: five timed in-epoch steps after the first
FLAGSHIP_TRAIN_IMAGES = 48
VMUNET_DIR = os.path.join(REPO, "results", "chip_smoke_vmunet")  # gitignored, removed at the end
VMUNET_OPTIONS = ("TwoBranch_1.yml", "TwoBranch_3.yml")  # TunedModel, FusedTunedModel
VMUNET_TRAIN_IMAGES = 48
SPEED_SIZE = 2048  # the speed test's input (speed_test.py's default)
SPEED_REPEAT, SPEED_SPEEDUP_REPEAT = 3, 16
SPEED_CHECK_SIZE, SPEED_CHECK_K = 256, 4  # its card-vs-CPU check
FORMATS_DIR = os.path.join(REPO, "results", "chip_smoke_formats")  # gitignored, removed at the end
OPTIONS_DIR = os.path.join(REPO, "results", "chip_smoke_options")  # gitignored, removed at the end
OPTIONS_TRAIN_IMAGES = 48
JPEG_FIXTURES = os.path.join(REPO, "bem_tpu_torch", "testdata")
VMUNET_EVAL_IMAGES = ("a_420_q95.jpg", "b_444_dri.jpg")
# the card-vs-CPU eval run: K and the crop of a fixture it takes (the CPU
# forwards a full-width IE: at 400x600 that takes minutes on the card's host)
VMUNET_CPU_K = 4
CPU_CROP = (112, 176)


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


def _grad_capture(model):
    """Record the gradients of the model's next update into the returned dict."""
    grads = {}
    apply = model._apply_updates
    model._apply_updates = lambda g, aux: (grads.update(g), apply(g, aux))[1]
    return grads


def train_reference_check(devices=("cuda", "cpu")):
    """One IE and one CG step at flagship widths (B=2, 32x32, fp32) on the
    card vs the CPU from the same weights, noise and weight sample, and one
    IE step with a MaskGenerator mask (the Network's mask token). Loss
    within 1e-4 relative; every gradient leaf within 1e-3 of its largest
    entry; the updated params within 1e-6 where |g| > 1e-2 max|g| of the
    leaf (Adam's first step is lr * sign(g) there), within 2 lr elsewhere."""
    rng = np.random.default_rng(3)
    img = lambda *s: torch.from_numpy(rng.random(s, np.float32))  # noqa: E731
    for mt, masked in (("ImageEnhancer", False), ("ConditionGenerator", False),
                       ("ImageEnhancer", True)):
        opt = _train_opt(mt)
        net_opt = dict(opt["network_g"])
        if mt == "ConditionGenerator":
            net_opt.update(bayesian=True, sigma_init=opt["sigma_init"])
            batch = {"lq_down": img(2, 32, 32, 3), "gt_down": img(2, 32, 32, 3)}
        else:
            batch = {"lq": img(2, 32, 32, 3), "gt": img(2, 32, 32, 3),
                     "gt_down": img(2, 8, 8, 3)}
        if masked:
            masks = MaskGenerator(32, 1, 1, 0.75, rng)
            batch["mask"] = torch.from_numpy(np.stack([masks(), masks()]))
        net = build_network(net_opt, torch.Generator().manual_seed(5))
        res = {}
        for dev in devices:
            m = build_model(opt, device=dev, net=copy.deepcopy(net))
            grads = _grad_capture(m)
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
        print(f"train reference {mt}{' with a mask' if masked else ''} B=2 32x32 fp32: loss "
              f"card {lg:.7f} cpu {lc:.7f} "
              f"(rel {loss_rel:.2e}, tol 1e-4); grads max err / leaf max {grad_err:.2e} "
              f"(tol 1e-3) over {len(gc)} leaves; params max rel err {param_err:.2e} "
              f"(tol 1e-6), beyond one step {max(param_far, 0.0):.2e} (tol 1e-6)", flush=True)
        token = gc["mask_token"].abs().max().item()  # 0 unless the mask reached the net
        if masked:
            print(f"train reference with a mask: the mask token's largest gradient {token:.3e}")
        if not (loss_rel <= 1e-4 and grad_err <= 1e-3 and param_err <= 1e-6
                and param_far <= 1e-6 and (token > 0) == masked):
            raise AssertionError(f"{mt} train step (mask {masked}) on the card disagrees with "
                                 f"the CPU")


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
    cut = re.sub(r"  train:\n(?:(?:    .*)?\n)+", "", text)  # its lines, blank ones too
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


def _eval_files(root, n, h, w, seed, noise_level=None, options=EVAL_OPTIONS):
    """n seeded low-light inputs with their targets (``smoke.write_eval_images``)
    and the option files (the CG's, the IE's; LOLv1's by default), copied
    with ``noise_level`` where given. Returns the two option paths."""
    smoke.write_eval_images(root, n, h, w, seed)
    if noise_level is None:
        return [os.path.join(REPO, "Options", name) for name in options]
    return _copy_options(root, options, **{"noise_level: 0.1": f"noise_level: {noise_level}"})


def _copy_options(root, names, **replace):
    """The option files ``names`` copied under ``root`` with each key of
    ``replace`` replaced by its value. Returns the copies' paths."""
    os.makedirs(root, exist_ok=True)
    paths = []
    for name in names:
        with open(os.path.join(REPO, "Options", name)) as f:
            text = f.read()
        for old, new in replace.items():
            if old not in text:
                raise AssertionError(f"{name}: no '{old}' to change")
            text = text.replace(old, new)
        paths.append(os.path.join(root, name))
        with open(paths[-1], "w") as f:
            f.write(text)
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


def flagship_phase(card: str):
    """The flagship, DecompDualBranchDDWavelet (its option file as it is),
    through the eval and test CLIs at full width (phase 9b)."""
    root = FLAGSHIP_DIR
    opt_path = os.path.join(REPO, "Options", FLAGSHIP_OPTION)
    os.makedirs(root, exist_ok=True)
    ckpt = smoke.write_flagship_checkpoint(os.path.join(root, "net_g_flagship.msgpack"), opt_path)
    net_opt = parse(opt_path, is_train=False)["network_g"]
    smoke.reset_launch_counts()

    # card vs CPU (TF32 off): the forward on a small padded image, then the eval CLI
    x = torch.from_numpy(np.random.default_rng(41).random((2, 128, 192, 6), np.float32))
    outs = {}
    for dev in ("cuda", "cpu"):
        net = load_flax_params(build_network(net_opt), load_params(ckpt)).to(dev).eval()
        with torch.inference_mode():
            outs[dev] = net(x.to(dev))[-1].float().cpu()
        del net
    ref = outs["cpu"]
    err = (outs["cuda"] - ref).abs().max().item()
    tol = 2e-4 * max(1.0, ref.abs().max().item())
    print(f"flagship forward 2x128x192 fp32, card vs CPU: max_abs_err {err:.3e} (tol "
          f"{tol:.3e}), output {tuple(outs['cuda'].shape)}", flush=True)
    if not (outs["cuda"].shape == (2, 128, 192, 3) and err <= tol):  # NaN fails
        raise AssertionError("the flagship forward on the card disagrees with the CPU")
    small = os.path.join(root, "eval_small")
    opts = _eval_files(small, 1, 112, 176, seed=42, noise_level=0,
                       options=(EVAL_OPTIONS[0], FLAGSHIP_OPTION))
    res = {dev: eval_main(_eval_args(opts, small, f"niqe_{dev}", "niqe", dev, 2, 2,
                                     ["--deterministic", "--cond_weights", ckpt]))
           for dev in ("cuda", "cpu")}
    written = {dev: imread(os.path.join(small, f"niqe_{dev}", "dataset", "0.png"),
                           float32=False).astype(int) for dev in res}
    lsb = int(np.abs(written["cuda"] - written["cpu"]).max())
    print(f"flagship eval CLI 112x176 K=2 niqe, card vs CPU: selected card "
          f"{res['cuda']['selected']} cpu {res['cpu']['selected']}; written image max LSB "
          f"{lsb} (tol 1); NIQE card {res['cuda']['niqe']:.4f} cpu {res['cpu']['niqe']:.4f}",
          flush=True)
    if not (res["cuda"]["selected"] == res["cpu"]["selected"] and lsb <= 1):
        raise AssertionError("the flagship eval CLI on the card disagrees with the CPU")
    torch.cuda.empty_cache()

    # the eval CLI at full width, and the IE's forward at batch 8, TF32 at PyTorch's defaults
    with torch_tf32_defaults():
        full = os.path.join(root, "eval_full")
        opts = _eval_files(full, 3, H, W, seed=43, options=(EVAL_OPTIONS[0], FLAGSHIP_OPTION))
        res = eval_main(_eval_args(opts, full, "niqe", "niqe", "cuda", K, 8,
                                   ["--cond_weights", ckpt]))
        scores = [v for s in res["scores"] for v in s]
        if not (all(0 <= i < K for i in res["selected"]) and len(scores) == 3 * K
                and np.isfinite(scores).all() and res["steady_s_per_img"]):
            raise AssertionError(f"flagship eval: bad result {res}")
        for i in range(3):
            out = imread(os.path.join(full, "niqe", "dataset", f"{i}.png"))
            if out.shape != (H, W, 3):
                raise AssertionError(f"flagship eval: output {i} has shape {out.shape}")
        net = load_flax_params(build_network(net_opt), load_params(ckpt)).to("cuda").eval()
        hp, wp = padded_size(H, W)
        xb = torch.rand((8, hp, wp, 6), generator=torch.Generator().manual_seed(45)).cuda()
        times = []
        with torch.inference_mode():
            for i in range(1 + FLAGSHIP_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = net(xb)[-1]
                torch.cuda.synchronize()
                if i:
                    times.append(time.perf_counter() - t0)
        if not (y.shape == (8, hp, wp, 3) and torch.isfinite(y).all()):
            raise AssertionError(f"flagship IE forward: bad output {tuple(y.shape)}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del net, xb, y
    print(f"flagship eval CLI K={K} parallel_num 8 {H}x{W} -> {hp}x{wp} niqe fp32, TF32 "
          f"defaults: steady-state {res['steady_s_per_img']:.4f} s/img (median of images "
          f"2-3), selected {res['selected']}, mean NIQE {res['niqe']:.4f}; IE forward B=8 "
          f"{hp}x{wp}: median {1e3 * statistics.median(times):.1f} ms over {FLAGSHIP_TIMED} "
          f"({[round(1e3 * t, 1) for t in times]}), peak memory {peak:.2f} GiB ({card})",
          flush=True)
    torch.cuda.empty_cache()

    # the test CLI on two validation images at 400x600
    smoke.write_eval_images(os.path.join(root, "val"), 2, H, W, seed=44)
    tested = test_pipeline(root, [
        "--opt", _test_options(FLAGSHIP_OPTION, root), "--device", "cuda", "--force_yml",
        f"datasets:val:dataroot_gt={os.path.join(root, 'val', 'target')}",
        f"datasets:val:dataroot_lq={os.path.join(root, 'val', 'input')}",
        "name=smoke_flagship_test", f"path:pretrain_network_g={ckpt}"]).metric_results
    _check_validation("flagship test CLI", tested)
    print(f"flagship test CLI on 2 images {H}x{W}: PSNR {tested['psnr']:.4f} SSIM "
          f"{tested['ssim']:.4f} ({card})", flush=True)
    counts = smoke.launch_counts()
    print(f"launches over the flagship phase: {counts}")
    if min(counts[k] for k in smoke.BEM_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the flagship path never launched: {counts}")
    return counts


class _VGGBranch:
    """Stands in for ``torch.nn.functional`` inside the perceptual loss: on
    the card's run it records each ReLU's mask and each max-pool's indices;
    on the CPU's run it applies the recorded ones (ReLU as x * mask, the pool
    as a gather), so that both runs differentiate the same linear piece of
    the VGG. Without it a max-pool tie or a ReLU input near 0 that the two
    devices break differently moves a whole window's gradient, which no
    tolerance on the gradients can allow for. ``flips`` counts the CPU's
    own decisions that differ from the card's."""

    conv2d = staticmethod(torch.nn.functional.conv2d)

    def __init__(self):
        self.decisions, self.replay, self.at, self.flips = [], False, 0, 0

    def _next(self, own):
        if not self.replay:
            self.decisions.append(own.cpu())
            return own
        kept = self.decisions[self.at].to(own.device)
        self.at += 1
        self.flips += int((kept != own).sum())
        return kept

    def relu(self, x):
        return x * self._next(x > 0)

    def max_pool2d(self, x, kernel, stride):
        _, own = torch.nn.functional.max_pool2d(x, kernel, stride, return_indices=True)
        idx = self._next(own)
        return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)


def train_step_check(opt_path, label="flagship", grad_tol=1e-3):
    """One train step of the option file's trainer (B=2, fp32, TF32 off) on
    the card vs the CPU: an ImageEnhancer at 32x32 with its pixel and
    perceptual losses, the MIM mask and (where the file turns it on) mixup;
    a ConditionGenerator at 16x16 with its weight noise injected. The VGG19
    features of a perceptual or combined loss take the card's ReLU and
    max-pool decisions on the CPU. A net with a frozen decomposition must
    leave it unchanged on both. Every gradient leaf within ``grad_tol`` of its
    largest entry."""
    from bem_tpu_torch.losses import my_loss, perceptual

    opt = parse(opt_path, is_train=True)
    cg = opt["model_type"] == "ConditionGenerator"
    mixup = opt["train"].get("mixing_augs", {}).get("mixup", False)
    net_opt = dict(opt["network_g"])
    if cg:
        net_opt.update(bayesian=True, sigma_init=opt["sigma_init"])
    net = build_network(net_opt, torch.Generator().manual_seed(6))
    rng = np.random.default_rng(4)
    img = lambda *s: rng.random(s, np.float32)  # noqa: E731
    if cg:
        batch = {"lq_down": img(2, 16, 16, 3), "gt_down": img(2, 16, 16, 3)}
        erng = np.random.default_rng(9)
        step = dict(eps={k: torch.from_numpy(erng.standard_normal(tuple(p.shape))
                                             .astype(np.float32))
                         for k, p in net.named_parameters()
                         if k.rpartition(".")[2].startswith("mu_")})
    else:
        masks = MaskGenerator(32, 1, 1, 0.75, rng)
        batch = {"lq": img(2, 32, 32, 3), "gt": img(2, 32, 32, 3), "gt_down": img(2, 2, 2, 3),
                 "mask": np.stack([masks(), masks()])}
        step = dict(noise=torch.from_numpy(rng.standard_normal((2, 2, 2, 3)).astype(np.float32)))
    branch, res = _VGGBranch(), {}
    functional = perceptual.F
    perceptual.F = my_loss.F = branch
    try:
        for dev in ("cuda", "cpu"):
            branch.replay = dev == "cpu"
            m = build_model(opt, device=dev, net=copy.deepcopy(net))
            decomp = {k: p.detach().cpu().clone() for k, p in m.params.items()
                      if k in m.optimizer.frozen}
            grads = _grad_capture(m)
            logs = m.train_step(batch, lam=0.7, **step)
            kept = all(torch.equal(m.params[k].detach().cpu(), v) for k, v in decomp.items())
            frozen = hasattr(m.net, "frozen_subtrees")
            res[dev] = (float(logs["l_total"]), float(logs.get("l_percep", logs["l_pix"])),
                        {k: g.cpu() for k, g in grads.items()}, kept and bool(decomp) == frozen)
            del m
    finally:
        perceptual.F = my_loss.F = functional
    (lg, pg, gg, kg), (lc, pc, gc, kc) = res["cuda"], res["cpu"]
    term = "l_percep" if "perceptual_opt" in opt["train"] else "l_pix"
    loss_rel, term_rel = abs(lg - lc) / abs(lc), abs(pg - pc) / abs(pc)
    grad_err = max((gg[k] - gc[k]).abs().max().item() / max(gc[k].abs().max().item(), 1e-30)
                   for k in gc)
    n = sum(d.numel() for d in branch.decisions)
    what = ("weight noise injected" if cg else
            f"mask{', mixup lam 0.7' if mixup else ', mixup off'}")
    print(f"{label} {opt['model_type']} train step B=2 {'16x16' if cg else '32x32'} fp32 "
          f"({opt['train']['pixel_opt']['type']}, {what}), card vs CPU: "
          f"loss {lg:.7f} / {lc:.7f} (rel {loss_rel:.2e}, tol 1e-4), {term} {pg:.7f} / "
          f"{pc:.7f} (rel {term_rel:.2e}, tol 1e-4); grads max err / leaf max {grad_err:.2e} "
          f"(tol {grad_tol:g}) over {len(gc)} leaves; the CPU on the card's {n} VGG ReLU / "
          f"max-pool "
          f"decisions ({branch.flips} of its own differ, tol {1e-4 * n:.0f}); frozen parts "
          f"unchanged card {kg} cpu {kc}",
          flush=True)
    if not (loss_rel <= 1e-4 and term_rel <= 1e-4 and grad_err <= grad_tol and kg and kc
            and branch.at == len(branch.decisions) and branch.flips <= 1e-4 * n):
        raise AssertionError(f"the {label} train step on the card disagrees with the CPU")


def flagship_train_phase(card: str):
    """The flagship's and the QD decomposition's training at full width (phase 9c)."""
    root = FLAGSHIP_TRAIN_DIR
    opt_path = os.path.join(REPO, "Options", FLAGSHIP_OPTION)
    prev = os.environ.get("BEM_ALLOW_RANDOM_VGG")
    os.environ["BEM_ALLOW_RANDOM_VGG"] = "1"
    try:
        train_step_check(opt_path)
        torch.cuda.empty_cache()
        for sub, n, seed in (("train", FLAGSHIP_TRAIN_IMAGES, 51), ("val", 2, 52)):
            smoke.write_eval_images(os.path.join(root, sub), n, H, W, seed)
        dirs = {f"{sub}_{kind}": os.path.join(root, sub, folder) for sub in ("train", "val")
                for kind, folder in (("low", "input"), ("high", "target"))}
        smoke.reset_launch_counts()
        counts = _flagship_cli(card, root, dirs)
        _qd_train_and_evaluate(card, root, dirs)
    finally:
        if prev is None:
            os.environ.pop("BEM_ALLOW_RANDOM_VGG", None)
        else:
            os.environ["BEM_ALLOW_RANDOM_VGG"] = prev
    print(f"launches over the flagship train CLI: {counts}")
    if min(counts[k] for k in smoke.BEM_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the flagship's training never launched: {counts}")
    return counts


def _flagship_cli(card, root, dirs):
    exp = os.path.join(root, "experiments", "smoke_flagship_train")
    common = ["--device", "cuda", "--force_yml",
              f"datasets:train:dataroot_gt={dirs['train_high']}",
              f"datasets:train:dataroot_lq={dirs['train_low']}",
              f"datasets:val:dataroot_gt={dirs['val_high']}",
              f"datasets:val:dataroot_lq={dirs['val_low']}",
              "name=smoke_flagship_train", "logger:print_freq=1",
              "logger:save_checkpoint_freq=2", "val:val_freq=2",
              "logger:use_tb_logger=false", "logger:wandb:project=~"]
    lines = _Lines()
    logging.getLogger("bem_tpu_torch").addHandler(lines)
    try:
        torch.cuda.reset_peak_memory_stats()
        model, log, _ = _cli_run(FLAGSHIP_OPTION, common + ["train:total_iter=6"], root, lines)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        found = {k: [float(m) for line in log for m in re.findall(rf"{k}: (\S+)", line)]
                 for k in ("l_pix", "l_percep")}
        files = {sub: sorted(os.listdir(os.path.join(exp, sub)))
                 for sub in ("models", "training_states")}
        want = {"models": [f"net_g_{i}.msgpack" for i in (2, 4, 6, 7)],
                "training_states": [f"{i}.state" for i in (2, 4, 6, 7)]}
        if not all(len(v) == 6 and np.isfinite(v).all() for v in found.values()):
            raise AssertionError(f"flagship train CLI: losses {found}")
        if files != want or model.step != 6:
            raise AssertionError(f"flagship train CLI: files {files}, step {model.step}")
        state = load_state(os.path.join(exp, "training_states", "6.state"))
        if set(state["opt_state"]) != {"inner_states"}:
            raise AssertionError("flagship .state: not in multi_transform's layout")
        _check_validation("flagship train CLI", model.metric_results)
        mask = model.opt["datasets"]["train"].get("mim")
        in_epoch = model.timings[1:]  # iter 1 builds and warms up
        print(f"flagship train CLI ({FLAGSHIP_OPTION}, mim {mask}, perceptual_opt conv5_4 x "
              f"{model.opt['train']['perceptual_opt']['perceptual_weight']}) 6 iters B=8 128x128 "
              f"fp32: l_pix {[f'{x:.5f}' for x in found['l_pix']]}, l_percep "
              f"{[f'{x:.5f}' for x in found['l_percep']]}; validation {H}x{W} PSNR "
              f"{model.metric_results['psnr']:.4f} SSIM {model.metric_results['ssim']:.4f}; wall "
              f"ms/step (data_time ms) by iter "
              + ", ".join(f"{i}: {1e3 * wall:.1f} ({1e3 * data:.1f})"
                          for i, _, data, wall in model.timings)
              + f"; median of iters 2-6: wall {1e3 * statistics.median(t[3] for t in in_epoch):.1f} "
              f"ms/step, data_time {1e3 * statistics.median(t[2] for t in in_epoch):.1f} ms; "
              f"peak memory {peak:.2f} GiB; files {files['models']} {files['training_states']} "
              f"({card})", flush=True)
        del model
        torch.cuda.empty_cache()
        resumed, log, first = _cli_run(FLAGSHIP_OPTION,
                                       common + ["train:total_iter=8", "--auto_resume"], root, lines)
        net6 = _leaves(load_params(os.path.join(exp, "models", "net_g_6.msgpack")))
        start = _leaves(state_dict_to_flax(resumed.net, first["params"]))
        same = set(start) == set(net6) and all(np.array_equal(start[k], v) for k, v in net6.items())
        lr_want = resumed.lr_schedule(6)
        print(f"flagship auto-resume: first step iter {first['step'] + 1}, params bit-equal to "
              f"net_g_6 {same}, lr {first['lr']:.9e} (iter 7 of an unbroken run {lr_want:.9e}); "
              f"ends at iter {resumed.step}, PSNR {resumed.metric_results['psnr']:.4f}", flush=True)
        if not (first["step"] == 6 and same and first["lr"] == lr_want and resumed.step == 8
                and resumed.optimizer.count == 8):
            raise AssertionError("flagship: the resumed run did not take up net_g_6 at iter 7")
        _check_validation("flagship resumed CLI", resumed.metric_results)
        del resumed
        torch.cuda.empty_cache()
    finally:
        logging.getLogger("bem_tpu_torch").removeHandler(lines)
    return smoke.launch_counts()


def _qd_train_and_evaluate(card, root, dirs):
    out = os.path.join(root, "qd")
    torch.cuda.reset_peak_memory_stats()
    trainer, history = train_qd("model4", dirs["train_low"], dirs["train_high"], dirs["val_low"],
                                dirs["val_high"], epochs=2, recon_only_epochs=1, out_dir=out,
                                device="cuda")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vals = [v for rec in history for v in rec.values()]
    ckpt = os.path.join(out, "model4_1.msgpack")
    per_epoch = FLAGSHIP_TRAIN_IMAGES // 8
    if not (len(history) == 2 and np.isfinite(vals).all() and trainer.step == 2 * per_epoch
            and os.path.exists(ckpt)):
        raise AssertionError(f"qd.train: history {history}, step {trainer.step}")
    with torch.no_grad():
        q1, q2 = load_qd_net("model4", ckpt, "cuda")(torch.rand(1, 3, 64, 64, device="cuda"))
    if not (torch.isfinite(q1).all() and torch.isfinite(q2).all()):
        raise AssertionError("qd.train: its checkpoint gives non-finite output")
    steps = trainer.timings
    recon, retinex = steps[1:per_epoch], steps[per_epoch + 1:]  # each objective's first warms up
    print(f"qd.train model4 patch 256 B=8, 2 epochs of {per_epoch} steps (recon-only, then "
          f"Retinex): history {history}; ms/step {[round(1e3 * t, 1) for t in steps]}; median "
          f"of steps 2-{per_epoch} (recon-only) {1e3 * statistics.median(recon):.1f} ms, of steps "
          f"{per_epoch + 2}-{2 * per_epoch} (Retinex) {1e3 * statistics.median(retinex):.1f} ms; "
          f"peak memory {peak:.2f} GiB ({card})", flush=True)
    del trainer
    torch.cuda.empty_cache()
    args = ["--model_type", "model4", "--low_dir", dirs["val_low"], "--high_dir", dirs["val_high"]]
    res, secs = {}, {}
    for tag, dev, extra in (("shipped cuda", "cuda", []), ("shipped cpu", "cpu", []),
                            ("trained cuda", "cuda", ["--weights", ckpt])):
        t0 = time.perf_counter()
        res[tag] = qd_evaluate(args + ["--out_dir", os.path.join(root, "qd_eval", tag.replace(" ", "_")),
                                       "--device", dev] + extra)
        secs[tag] = (time.perf_counter() - t0) / 2
        print(f"qd.evaluate {tag} on 2 pairs {H}x{W}: PSNR {res[tag]['psnr']:.6f} SSIM "
              f"{res[tag]['ssim']:.6f} RCI {res[tag]['rci']:.6f}, {secs[tag]:.3f} s/img ({card})",
              flush=True)
        if not all(np.isfinite(v) for v in res[tag].values()):
            raise AssertionError(f"qd.evaluate {tag}: {res[tag]}")
    g, c = res["shipped cuda"], res["shipped cpu"]
    drci, dpsnr = abs(g["rci"] - c["rci"]), abs(g["psnr"] - c["psnr"])
    print(f"qd.evaluate shipped model4, card vs CPU: RCI diff {drci:.2e} (tol 1e-4), PSNR diff "
          f"{dpsnr:.2e} dB (tol 0.01)", flush=True)
    if not (drci <= 1e-4 and dpsnr <= 0.01):
        raise AssertionError("qd.evaluate on the card disagrees with the CPU")


def jpeg_fixture_check(card):
    """The JPEG decoder on the committed fixtures against the PNGs of cv2's
    decodes committed beside them (the card's machine has no cv2), and its
    host time at 400x600."""
    for name in sorted(f for f in os.listdir(JPEG_FIXTURES) if f.endswith(".jpg")):
        path = os.path.join(JPEG_FIXTURES, name)
        with open(path, "rb") as f:
            data = f.read()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = imdecode(data, path)
            times.append(time.perf_counter() - t0)
        want = imread(path[:-4] + ".png", float32=False)
        same = got.shape == want.shape == (H, W, 3) and np.array_equal(got, want)
        print(f"JPEG {name} ({len(data)} bytes): decode {1e3 * statistics.median(times):.1f} ms "
              f"(median of 3, host), equal to cv2's decode {same} ({card})", flush=True)
        if not same:
            raise AssertionError(f"{name}: the JPEG decoder disagrees with cv2's decode")


def _vmunet_cli(card, root, name, dirs):
    """The train CLI on a TwoBranch option file as it is (6 iters; its
    val_freq of 1000 leaves the one validation at the end), then the test
    CLI on its net_g."""
    tag = name[:-4]
    exp = os.path.join(root, "experiments", f"smoke_{tag}")
    common = ["--device", "cuda", "--force_yml",
              f"datasets:train:dataroot_gt={dirs['train_high']}",
              f"datasets:train:dataroot_lq={dirs['train_low']}",
              f"datasets:val:dataroot_gt={dirs['val_high']}",
              f"datasets:val:dataroot_lq={dirs['val_low']}",
              f"name=smoke_{tag}", "logger:print_freq=1", "logger:save_checkpoint_freq=6",
              "logger:use_tb_logger=false", "logger:wandb:project=~", "train:total_iter=6"]
    lines = _Lines()
    logging.getLogger("bem_tpu_torch").addHandler(lines)
    try:
        torch.cuda.reset_peak_memory_stats()
        model, log, _ = _cli_run(name, common, root, lines)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        logging.getLogger("bem_tpu_torch").removeHandler(lines)
    found = {k: [float(m) for line in log for m in re.findall(rf"{k}: (\S+)", line)]
             for k in ("l_pix", "l_percep")}
    models = sorted(os.listdir(os.path.join(exp, "models")))
    if not all(len(v) == 6 and np.isfinite(v).all() for v in found.values()):
        raise AssertionError(f"{tag} train CLI: losses {found}")
    if models != ["net_g_6.msgpack", "net_g_7.msgpack"] or model.step != 6:
        raise AssertionError(f"{tag} train CLI: models {models}, step {model.step}")
    _check_validation(f"{tag} train CLI", model.metric_results)
    in_epoch = model.timings[1:]  # iter 1 builds and warms up
    print(f"{tag} train CLI ({model.opt['network_g']['type']}, n_feat "
          f"{model.opt['network_g']['n_feat']}, mim {model.opt['datasets']['train'].get('mim')}, "
          f"perceptual conv5_4 x {model.opt['train']['perceptual_opt']['perceptual_weight']}) "
          f"6 iters B=8 128x128 fp32: l_pix {[f'{x:.5f}' for x in found['l_pix']]}, l_percep "
          f"{[f'{x:.5f}' for x in found['l_percep']]}; validation {H}x{W} PSNR "
          f"{model.metric_results['psnr']:.4f} SSIM {model.metric_results['ssim']:.4f}; wall "
          f"ms/step (data_time ms) by iter "
          + ", ".join(f"{i}: {1e3 * wall:.1f} ({1e3 * data:.1f})"
                      for i, _, data, wall in model.timings)
          + f"; median of iters 2-6: wall {1e3 * statistics.median(t[3] for t in in_epoch):.1f} "
          f"ms/step, data_time {1e3 * statistics.median(t[2] for t in in_epoch):.1f} ms; "
          f"peak memory {peak:.2f} GiB ({card})", flush=True)
    last_psnr = model.metric_results["psnr"]
    del model
    torch.cuda.empty_cache()
    tested = test_pipeline(root, [
        "--opt", _test_options(name, root), "--device", "cuda", "--force_yml",
        f"datasets:val:dataroot_gt={dirs['val_high']}",
        f"datasets:val:dataroot_lq={dirs['val_low']}", f"name=smoke_{tag}_test",
        f"path:pretrain_network_g={os.path.join(exp, 'models', 'net_g_6.msgpack')}"]).metric_results
    _check_validation(f"{tag} test CLI", tested)
    dpsnr = abs(tested["psnr"] - last_psnr)
    print(f"{tag} test CLI on net_g_6, 2 images {H}x{W}: PSNR {tested['psnr']:.6f} SSIM "
          f"{tested['ssim']:.6f}; the train CLI's validation {last_psnr:.6f} (diff {dpsnr:.2e}, "
          f"tol 5e-5)", flush=True)
    if not dpsnr <= 5e-5:
        raise AssertionError(f"{tag}: the test CLI does not give the last validation's PSNR")


def _inject_cg_eps(opt_path, n, seed):
    """n seeded weight-noise draws of the CG of ``opt_path``, handed out in
    call order to the eval CLI's ``sample_bayes``; returns the restore."""
    from bem_tpu_torch.nn.layers import sample_bayes

    opt = parse(opt_path, is_train=False)
    cg = build_network(dict(opt["network_g"], bayesian=True, sigma_init=0.05))
    rng = np.random.default_rng(seed)
    draws = iter([{k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
                   for k, p in cg.named_parameters() if k.rpartition(".")[2].startswith("mu_")}
                  for _ in range(n)])
    eval_module.sample_bayes = lambda net, gen=None, e=None: sample_bayes(net, gen, next(draws))
    return lambda: setattr(eval_module, "sample_bayes", sample_bayes)


def _recording_scorer(seen):
    """The eval CLI's UIQM + UCIQE scorer, recording each call's candidates
    (on the host) and scores in ``seen``."""
    scorer = eval_module.uiqm_uciqe_batch

    def record(cands):
        seen.append((cands.detach().cpu(), scorer(cands)))
        return seen[-1][1]

    return record


def _scorer_card_vs_cpu(cands, scores):
    """The CPU's scorer on the card's candidates: (UIQM max relative diff,
    UCIQE max abs diff)."""
    uiqm_g, uciqe_g = scores
    uiqm_c, uciqe_c = uiqm_uciqe_batch(cands)
    return (float(np.max(np.abs(uiqm_g - uiqm_c) / np.abs(uiqm_c))),
            float(np.max(np.abs(uciqe_g - uciqe_c))))


def _vmunet_eval(card, root):
    """The eval CLI with the seeded LOLv1 Network CG and each TwoBranch IE at
    400x600, K=16, on two committed JPEG fixtures, --no_ref uiqm_uciqe
    (--uiqm_weight 0.5) and niqe; the CPU's scorer on the card's K=16
    candidates; the scorer's own time at K=16; the CLI again card vs CPU on
    one image (a 112x176 crop: the CPU forwards a full-width IE); both
    folder CLIs on an output folder."""
    inp = os.path.join(root, "eval_input")
    os.makedirs(inp, exist_ok=True)
    for name in VMUNET_EVAL_IMAGES:
        shutil.copy(os.path.join(JPEG_FIXTURES, name), inp)
    cg = os.path.join(REPO, "Options", EVAL_OPTIONS[0])
    modes = {"uiqm_uciqe": ["--no_ref", "uiqm_uciqe", "--uiqm_weight", "0.5"],
             "niqe": ["--no_ref", "niqe"]}
    outs, seen = {}, []
    scorer = eval_module.uiqm_uciqe_batch
    for ie in VMUNET_OPTIONS:
        for mode, extra in modes.items():
            out = os.path.join(root, f"eval_{ie[:-4]}_{mode}")
            eval_module.uiqm_uciqe_batch = _recording_scorer(seen) if not seen else scorer
            try:
                res = eval_main(["--opt", cg, "--cond_opt", os.path.join(REPO, "Options", ie),
                                 "--input_dir", inp, "--result_dir", out, "--num_samples",
                                 str(K), "--parallel_num", "8", "--seed", "5", "--device",
                                 "cuda", *extra])
            finally:
                eval_module.uiqm_uciqe_batch = scorer
            scores = [v for s in res["scores"] for v in s]
            if not (all(0 <= i < K for i in res["selected"]) and len(scores) == NIMG * K
                    and np.isfinite(scores).all() and res["steady_s_per_img"]):
                raise AssertionError(f"eval {ie} {mode}: bad result {res}")
            for name in VMUNET_EVAL_IMAGES:
                got = imread(os.path.join(out, "dataset", name[:-4] + ".png"))
                if got.shape != (H, W, 3):
                    raise AssertionError(f"eval {ie} {mode}: output {name} is {got.shape}")
            got = (f"UIQM {res['uiqm']:.4f} UCIQE {res['uciqe']:.4f}" if mode == "uiqm_uciqe"
                   else f"NIQE {res['niqe']:.4f}")
            print(f"eval CG {EVAL_OPTIONS[0]} + IE {ie} --no_ref {mode} K={K} parallel_num 8 "
                  f"{H}x{W} JPEG inputs, fp32, TF32 defaults: {res['steady_s_per_img']:.4f} s/img "
                  f"(image 2; image 1 {res['per_image_s'][0]:.2f} s), selected {res['selected']}, "
                  f"{got} ({card})", flush=True)
            outs[(ie, mode)] = os.path.join(out, "dataset")
            torch.cuda.empty_cache()
    uiqm_rel, uciqe_err = _scorer_card_vs_cpu(*seen[0])
    print(f"UIQM + UCIQE scorer on the card's {K} candidates {H}x{W} (the first image of IE "
          f"{VMUNET_OPTIONS[0]}), card vs CPU: UIQM max rel diff {uiqm_rel:.2e} (tol 1e-5), "
          f"UCIQE max diff {uciqe_err:.2e} (tol 1e-8)", flush=True)
    if not (uiqm_rel <= 1e-5 and uciqe_err <= 1e-8):
        raise AssertionError("the UIQM + UCIQE scorer on the card disagrees with the CPU")

    # the scorer alone on K candidates of the runs' size
    cands = torch.rand(K, H, W, 3, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(3))
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        uiqm_uciqe_batch(cands)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"uiqm_uciqe_batch K={K} {H}x{W} on the card: {1e3 * statistics.median(times[1:]):.2f} "
          f"ms (median of 5 after a warm-up, host clock, the 256-count histograms to the host "
          f"included) ({card})", flush=True)
    del cands

    # the CLI again, card vs CPU, on a crop of one fixture: noise 0, the same
    # injected weight noise
    opts = _copy_options(os.path.join(root, "noise0"), (EVAL_OPTIONS[0], VMUNET_OPTIONS[0]),
                         **{"noise_level: 0.1": "noise_level: 0"})
    one = os.path.join(root, "one")
    y0, x0 = (H - CPU_CROP[0]) // 2, (W - CPU_CROP[1]) // 2
    crop = imread(os.path.join(JPEG_FIXTURES, VMUNET_EVAL_IMAGES[0]), float32=False)
    imwrite(crop[y0:y0 + CPU_CROP[0], x0:x0 + CPU_CROP[1]], os.path.join(one, "0.png"))
    runs, res = {}, {}
    for dev in ("cuda", "cpu"):
        restore = _inject_cg_eps(opts[0], VMUNET_CPU_K, seed=61)
        runs[dev] = []
        eval_module.uiqm_uciqe_batch = _recording_scorer(runs[dev])
        try:
            res[dev] = eval_main(["--opt", opts[0], "--cond_opt", opts[1], "--input_dir", one,
                                  "--result_dir", os.path.join(root, f"one_{dev}"),
                                  "--num_samples", str(VMUNET_CPU_K), "--parallel_num", "4",
                                  "--seed", "5", "--device", dev, *modes["uiqm_uciqe"]])
        finally:
            eval_module.uiqm_uciqe_batch = scorer
            restore()
    uiqm_rel, uciqe_err = _scorer_card_vs_cpu(*runs["cuda"][0])
    g, c = res["cuda"], res["cpu"]
    lsb = int(np.abs(imread(os.path.join(root, "one_cuda", "dataset", "0.png"),
                            float32=False).astype(int)
                     - imread(os.path.join(root, "one_cpu", "dataset", "0.png"),
                              float32=False).astype(int)).max())
    print(f"eval uiqm_uciqe card vs CPU, IE {VMUNET_OPTIONS[0]}, one {CPU_CROP[0]}x{CPU_CROP[1]} "
          f"crop of {VMUNET_EVAL_IMAGES[0]}, K={VMUNET_CPU_K}, noise 0, the same weight noise: "
          f"selected card {g['selected']} cpu {c['selected']}, written image max diff {lsb} LSB "
          f"(tol 1); the CPU's scorer on the card's candidates: UIQM max rel diff "
          f"{uiqm_rel:.2e} (tol 1e-5), UCIQE max diff {uciqe_err:.2e} (tol 1e-8); the picks' "
          f"UIQM {g['uiqm']:.6f} / {c['uiqm']:.6f}, UCIQE {g['uciqe']:.8f} / {c['uciqe']:.8f}",
          flush=True)
    if not (g["selected"] == c["selected"] and lsb <= 1 and uiqm_rel <= 1e-5
            and uciqe_err <= 1e-8):
        raise AssertionError("eval uiqm_uciqe on the card disagrees with the CPU")

    # the folder CLIs on an output folder of the uiqm_uciqe run
    folder = outs[(VMUNET_OPTIONS[0], "uiqm_uciqe")]
    folder_res = {dev: folder_uciqe_uiqm([folder, "--device", dev]) for dev in ("cuda", "cpu")}
    (ug, qg), (uc, qc) = folder_res["cuda"], folder_res["cpu"]
    cal = cal_metrics(["--pred_dir", folder, "--gt_dir", inp, "--device", "cuda"])
    print(f"eval_uciqe_uiqm on {NIMG} outputs {H}x{W} (full size): UCIQE {ug:.6f} / CPU {uc:.6f}, "
          f"UIQM {qg:.6f} / CPU {qc:.6f}; cal_metrics_with_imgs outputs vs inputs: PSNR "
          f"{cal['psnr']:.4f} SSIM {cal['ssim']:.4f}", flush=True)
    if not (abs(ug - uc) <= 1e-8 and abs(qg - qc) <= 1e-5 * abs(qc)
            and np.isfinite(cal["psnr"]) and -1 <= cal["ssim"] <= 1):
        raise AssertionError("the folder CLIs: bad or disagreeing results")


def _reference_checkpoint_check(card, root):
    """Reference-layout ckpt.pth files of the LOLv1 CG (Bayesian mu / rho) and
    IE at full width, drawn from a seed, through the port's converter: the
    forward equals the source net's on the CPU and agrees card vs CPU."""
    for name, bayes, shape in ((EVAL_OPTIONS[0], True, (1, 28, 40, 3)),
                               (EVAL_OPTIONS[1], False, (2, 128, 192, 6))):
        opt = parse(os.path.join(REPO, "Options", name), is_train=False)
        net_opt = dict(opt["network_g"], **({"bayesian": True, "sigma_init": 0.05}
                                             if bayes else {}))
        src = build_network(net_opt, torch.Generator().manual_seed(71)).eval()
        path = smoke.write_reference_checkpoint(os.path.join(root, f"ckpt_{name[:-4]}.pth"), src)
        tree = convert_network_checkpoint(
            path, num_blocks=tuple(net_opt["num_blocks"]), stage=net_opt.get("stage", 1),
            use_pixelshuffle=net_opt.get("use_pixelshuffle", True))
        net = load_flax_params(build_network(net_opt, torch.Generator().manual_seed(72)),
                               tree).eval()
        x = torch.from_numpy(np.random.default_rng(73).random(shape, np.float32))
        with torch.no_grad():
            want = src(x)[-1]
            cpu = net(x)[-1]
            gpu = copy.deepcopy(net).cuda()(x.cuda())[-1].cpu()
        err = float((gpu - cpu).abs().max()) / max(1.0, float(cpu.abs().max()))
        print(f"reference ckpt.pth {name[:-4]} ({'Bayesian mu / rho, ' if bayes else ''}n_feat "
              f"{net_opt['n_feat']}, blocks {tuple(net_opt['num_blocks'])}, "
              f"{os.path.getsize(path) / 2 ** 20:.2f} MiB): converted forward on {tuple(shape)} "
              f"equals the source net's on the CPU {torch.equal(cpu, want)}; card vs CPU "
              f"{err:.2e} (tol 2e-4 of max(1, |cpu|))", flush=True)
        if not (torch.equal(cpu, want) and err <= 2e-4):
            raise AssertionError(f"{name}: the converted reference checkpoint disagrees")


def vmunet_phase(card: str):
    """The VMUNet family, the UIQM + UCIQE eval and reference checkpoints at
    full width (phase 9d)."""
    root = VMUNET_DIR
    prev = os.environ.get("BEM_ALLOW_RANDOM_VGG")
    os.environ["BEM_ALLOW_RANDOM_VGG"] = "1"
    try:
        jpeg_fixture_check(card)
        for name in VMUNET_OPTIONS:
            train_step_check(os.path.join(REPO, "Options", name), name[:-4])
            torch.cuda.empty_cache()
        for sub, n, seed in (("train", VMUNET_TRAIN_IMAGES, 81), ("val", 2, 82)):
            smoke.write_eval_images(os.path.join(root, sub), n, H, W, seed)
        dirs = {f"{sub}_{kind}": os.path.join(root, sub, folder) for sub in ("train", "val")
                for kind, folder in (("low", "input"), ("high", "target"))}
        smoke.reset_launch_counts()
        for name in VMUNET_OPTIONS:
            _vmunet_cli(card, root, name, dirs)
        with torch_tf32_defaults():
            _vmunet_eval(card, root)
        counts = smoke.launch_counts()
    finally:
        if prev is None:
            os.environ.pop("BEM_ALLOW_RANDOM_VGG", None)
        else:
            os.environ["BEM_ALLOW_RANDOM_VGG"] = prev
    print(f"launches over the VMUNet family's CLI runs: {counts}")
    if min(counts[k] for k in smoke.BEM_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the VMUNet family's paths never launched: {counts}")
    _reference_checkpoint_check(card, root)
    return counts


FORMAT_JPEGS = ("e_420_prog.jpg", "f_cmyk.jpg")


def _format_files(root, seed):
    """The phase's files: name -> (bytes, the RGB uint8 truth of a colour
    read). The lossless ones from seeded arrays, each truth the array under
    the rule the CPU tests pin; the JPEGs committed, each truth the PNG of
    cv2's decode beside it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / 37.0
    base = [0.2 + 0.15 * np.sin(yy * (1 + c) + xx * (2 - c))[..., None] for c in range(3)]
    smooth = np.clip(np.concatenate(base, -1) + 0.02 * rng.standard_normal((H, W, 3)), 0, 1)
    rgb8 = (smooth * 255).round().astype(np.int64)
    rgb16 = (smooth * 65535).round().astype(np.int64)
    pal = rng.integers(0, 140, (256, 3))
    idx = (rgb8.sum(-1) * 255 // (3 * 255)).clip(0, 255)
    runs = np.repeat(idx[:, ::8], 8, axis=1)[:, :W]
    bgr_pal = [tuple(int(v) for v in p[::-1]) for p in pal]
    files = {"c_lzw.tif": (encode_tiff(rgb8, 2, 8, 5, 2, rows_per_strip=16), rgb8),
             "d_deflate16.tif": (encode_tiff(rgb16, 2, 16, 8, 2, rows_per_strip=16),
                                 (rgb16 * 255 + 32767) // 65535),
             "e_palette.bmp": (encode_bmp_palette(idx, bgr_pal), pal[idx]),
             "f_rle8.bmp": (encode_bmp_palette(runs, bgr_pal, rle=True), pal[runs]),
             "g_laced16.png": (encode_png_samples(rgb16, 2, 16, interlace=True), rgb16 >> 8)}
    for name in FORMAT_JPEGS:
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            files[name] = (f.read(), imread(os.path.join(JPEG_FIXTURES, name[:-4] + ".png"),
                                            float32=False))
    os.makedirs(root, exist_ok=True)
    for name, (data, _) in files.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(data)
    return {k: (d, np.asarray(t, np.uint8)) for k, (d, t) in files.items()}


def _format_decodes(card, files):
    """Each file's host decode against its truth; its median time of 3."""
    for name, (data, truth) in sorted(files.items()):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = imdecode(data, name)
            times.append(time.perf_counter() - t0)
        same = got.shape == truth.shape == (H, W, 3) and np.array_equal(got, truth)
        print(f"decode {name} ({len(data)} bytes, {H}x{W}): {1e3 * statistics.median(times):.1f} "
              f"ms (median of 3, host), equal to its truth {same} ({card})", flush=True)
        if not same:
            raise AssertionError(f"{name}: the decoder disagrees with the file's truth")


def _format_crops(root, files):
    """112x176 crops of the LZW TIFF and the RLE8 BMP, written in their own
    formats."""
    one = os.path.join(root, "crops")
    os.makedirs(one, exist_ok=True)
    y0, x0 = (H - CPU_CROP[0]) // 2, (W - CPU_CROP[1]) // 2
    win = (slice(y0, y0 + CPU_CROP[0]), slice(x0, x0 + CPU_CROP[1]))
    tiff = files["c_lzw.tif"][1][win].astype(np.int64)
    with open(os.path.join(one, "0.tif"), "wb") as f:
        f.write(encode_tiff(tiff, 2, 8, 5, 2))
    # the BMP crop through its palette: the crop's colours as a palette
    crop = files["f_rle8.bmp"][1][win].astype(np.int64)
    colours, idx = np.unique(crop.reshape(-1, 3), axis=0, return_inverse=True)
    with open(os.path.join(one, "1.bmp"), "wb") as f:
        f.write(encode_bmp_palette(idx.reshape(CPU_CROP), [tuple(int(v) for v in c[::-1])
                                                          for c in colours], rle=True))
    return one


def formats_phase(card: str):
    """Image formats at full width (phase 9e)."""
    root = FORMATS_DIR
    inp = os.path.join(root, "input")
    files = _format_files(inp, seed=91)
    _format_decodes(card, files)
    cg, ie = (os.path.join(REPO, "Options", n) for n in EVAL_OPTIONS)
    names = sorted(files, key=lambda n: [int(t) if t.isdigit() else t
                                         for t in re.split(r"(\d+)", n)])
    smoke.reset_launch_counts()
    with torch_tf32_defaults():
        res = eval_main(["--opt", cg, "--cond_opt", ie, "--input_dir", inp, "--result_dir",
                         os.path.join(root, "eval"), "--num_samples", str(K), "--parallel_num",
                         "8", "--seed", "5", "--device", "cuda", "--no_ref", "niqe"])
    scores = [v for sc in res["scores"] for v in sc]
    if not (len(res["per_image_s"]) == len(files) and len(scores) == len(files) * K
            and np.isfinite(scores).all() and all(0 <= i < K for i in res["selected"])):
        raise AssertionError(f"eval over the formats: bad result {res}")
    for name in names:
        out = imread(os.path.join(root, "eval", "dataset", os.path.splitext(name)[0] + ".png"))
        if out.shape != (H, W, 3):
            raise AssertionError(f"eval over the formats: output of {name} is {out.shape}")
    per = "; ".join(f"{n} {s:.4f}" for n, s in zip(names, res["per_image_s"]))
    print(f"eval CG {EVAL_OPTIONS[0]} + IE {EVAL_OPTIONS[1]} --no_ref niqe K={K} parallel_num 8 "
          f"{H}x{W} fp32, TF32 defaults, {len(files)} formats: s/img {per} (the first pays the "
          f"compiles); steady-state {res['steady_s_per_img']:.4f} s/img; NIQE {res['niqe']:.4f}"
          f" ({card})", flush=True)
    torch.cuda.empty_cache()

    # the CLI again, card vs CPU, on crops of two files: noise 0, the same
    # injected weight noise
    opts = _copy_options(os.path.join(root, "noise0"), EVAL_OPTIONS,
                         **{"noise_level: 0.1": "noise_level: 0"})
    crops = _format_crops(root, files)
    outs = {}
    for dev in ("cuda", "cpu"):
        restore = _inject_cg_eps(opts[0], 2 * VMUNET_CPU_K, seed=62)
        try:
            outs[dev] = eval_main(["--opt", opts[0], "--cond_opt", opts[1], "--input_dir", crops,
                                   "--result_dir", os.path.join(root, f"crops_{dev}"),
                                   "--num_samples", str(VMUNET_CPU_K), "--parallel_num", "4",
                                   "--seed", "5", "--device", dev, "--no_ref", "niqe"])
        finally:
            restore()
    lsb = max(int(np.abs(imread(os.path.join(root, "crops_cuda", "dataset", f"{i}.png"),
                                float32=False).astype(int)
                         - imread(os.path.join(root, "crops_cpu", "dataset", f"{i}.png"),
                                  float32=False).astype(int)).max()) for i in range(2))
    g, c = outs["cuda"], outs["cpu"]
    print(f"eval niqe card vs CPU on {CPU_CROP[0]}x{CPU_CROP[1]} crops (LZW TIFF, RLE8 BMP), "
          f"K={VMUNET_CPU_K}, noise 0, the same weight noise: selected card {g['selected']} cpu "
          f"{c['selected']}, written images max diff {lsb} LSB (tol 1), NIQE {g['niqe']:.6f} / "
          f"{c['niqe']:.6f}", flush=True)
    if not (g["selected"] == c["selected"] and lsb <= 1):
        raise AssertionError("eval over the formats on the card disagrees with the CPU")

    # the train CLI on progressive-JPEG inputs and TIFF targets
    lines = _Lines()
    logging.getLogger("bem_tpu_torch").addHandler(lines)
    try:
        train = os.path.join(root, "train")
        for sub in ("input", "target", "val_input", "val_target"):
            os.makedirs(os.path.join(train, sub), exist_ok=True)
        rng = np.random.default_rng(92)
        prog = files["e_420_prog.jpg"][0]
        for i in range(10):
            sub = "" if i < 8 else "val_"
            with open(os.path.join(train, sub + "input", f"{i:03d}.jpg"), "wb") as f:
                f.write(prog)
            gt = np.clip(files["e_420_prog.jpg"][1].astype(np.int64) * 3
                         + rng.integers(-8, 9, (H, W, 3)), 0, 255)
            with open(os.path.join(train, sub + "target", f"{i:03d}.tif"), "wb") as f:
                f.write(encode_tiff(gt, 2, 8, 5, 2, rows_per_strip=32))
        args = ["--device", "cuda", "--force_yml",
                f"datasets:train:dataroot_lq={os.path.join(train, 'input')}",
                f"datasets:train:dataroot_gt={os.path.join(train, 'target')}",
                f"datasets:val:dataroot_lq={os.path.join(train, 'val_input')}",
                f"datasets:val:dataroot_gt={os.path.join(train, 'val_target')}",
                "name=smoke_formats", "logger:print_freq=1", "logger:save_checkpoint_freq=4",
                "val:val_freq=4", "logger:use_tb_logger=false", "logger:wandb:project=~",
                "datasets:train:num_worker_per_gpu=2", "train:total_iter=4", *SSIM]
        model, log, _ = _cli_run(EVAL_OPTIONS[1], args, root, lines)
    finally:
        logging.getLogger("bem_tpu_torch").removeHandler(lines)
    losses = [float(m) for line in log for m in re.findall(r"l_total: (\S+)", line)]
    if not (len(losses) == 4 and np.isfinite(losses).all() and model.step == 4):
        raise AssertionError(f"train CLI on the formats: losses {losses}, step {model.step}")
    _check_validation("train CLI on the formats", model.metric_results)
    per_iter = ", ".join(f"{i}: {1e3 * wall:.1f} ({1e3 * data:.1f})"
                         for i, _, data, wall in model.timings)
    rest = model.timings[1:]
    print(f"ImageEnhancer train CLI 4 iters B=8 fp32 on 8 progressive-JPEG / LZW-TIFF pairs "
          f"{H}x{W} (Dataset_PairedImage_Mask, 2 loader threads): losses "
          f"{[f'{x:.5f}' for x in losses]}; wall ms/step (data_time ms) by iter {per_iter}; "
          f"iters 2-4 mean {1e3 * statistics.mean(t[3] for t in rest):.1f} ms/step, data_time "
          f"{1e3 * statistics.mean(t[2] for t in rest):.1f} ms; validation PSNR "
          f"{model.metric_results['psnr']:.4f} ({card})", flush=True)
    counts = smoke.launch_counts()
    print(f"launches over the image formats' CLI runs: {counts}")
    if min(counts[k] for k in smoke.BEM_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the image formats' paths never launched: {counts}")
    return counts


def _speed_check(card):
    """Both speed-test bodies on the card and the CPU from the same nets
    (the LOLv1 option files, seeded) on the 256x256 input, fp32, TF32 off,
    with injected CG weight samples: the same pick, the scores and the IE
    outputs within 2e-4 of max(1, |cpu|)."""
    args = speed_test.build_parser().parse_args(
        ["--opt", os.path.join(REPO, "Options", EVAL_OPTIONS[0]),
         "--cond_opt", os.path.join(REPO, "Options", EVAL_OPTIONS[1])])
    res = {}
    for dev in ("cuda", "cpu"):
        net, cond_net, scale = speed_test.build_nets(args, dev)
        if dev == "cuda":
            erng = np.random.default_rng(12)
            eps = [{k: torch.from_numpy(erng.standard_normal(tuple(p.shape)).astype(np.float32))
                    for k, p in net.named_parameters()
                    if k.rpartition(".")[2].startswith("mu_")} for _ in range(SPEED_CHECK_K)]
        x, x_down = speed_test.inputs(SPEED_CHECK_SIZE, scale, torch.float32, dev)
        sums, pred = speed_test.sequential(net, cond_net, x, x_down, scale, 2, eps=eps)
        best, scores, best_pred = speed_test.speedup(net, cond_net, x, x_down, scale,
                                                     SPEED_CHECK_K, eps=eps)
        res[dev] = (sums, pred.cpu(), best, scores.cpu(), best_pred.cpu())
        del net, cond_net
    (sg, pg, bg, scg, bpg), (sc, pc, bc, scc, bpc) = res["cuda"], res["cpu"]
    errs = [(a - b).abs().max().item() / max(1.0, b.abs().max().item())
            for a, b in ((pg, pc), (scg, scc), (bpg, bpc))]
    sum_rel = max(abs(a - b) / abs(b) for a, b in zip(sg, sc))
    print(f"speed test {SPEED_CHECK_SIZE}x{SPEED_CHECK_SIZE} fp32 card vs CPU ({card}): "
          f"sequential IE output err {errs[0]:.2e}, sums rel {sum_rel:.2e}; speedup K="
          f"{SPEED_CHECK_K} pick card {bg} cpu {bc}, scores err {errs[1]:.2e}, IE output err "
          f"{errs[2]:.2e} (tol 2e-4 of max(1, |cpu|))", flush=True)
    if not (bg == bc and max(errs) <= 2e-4 and sum_rel <= 2e-4):
        raise AssertionError("the speed test on the card disagrees with the CPU")


def speed_phase(card: str):
    """The speed-test CLI (phase 10): card vs CPU at 256x256, then its
    timed runs at 2048x2048 in both modes and both dtypes."""
    _speed_check(card)
    torch.cuda.empty_cache()
    common = ["--opt", os.path.join(REPO, "Options", EVAL_OPTIONS[0]),
              "--cond_opt", os.path.join(REPO, "Options", EVAL_OPTIONS[1]),
              "--input_size", str(SPEED_SIZE), "--device", "cuda"]
    smoke.reset_launch_counts()
    for dtype in ("bfloat16", "float32"):
        for mode in (["--repeat", str(SPEED_REPEAT)],
                     ["--speedup", "--repeat", str(SPEED_SPEEDUP_REPEAT)]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                speed_test.main(common + ["--dtype", dtype] + mode)
            lines = out.getvalue().strip().splitlines()
            if not re.fullmatch(r"running time: \d+\.\d{4} sec", lines[0]):
                raise AssertionError(f"speed test {dtype} {mode}: {lines}")
            print(f"speed test {SPEED_SIZE}x{SPEED_SIZE} {dtype} {' '.join(mode)}: "
                  f"{'; '.join(lines)} ({card})", flush=True)
            torch.cuda.empty_cache()
    counts = smoke.launch_counts()
    print(f"launches over the speed test's runs: {counts}")
    if min(counts[k] for k in smoke.BEM_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the speed test's path never launched: {counts}")
    return counts


# the two option sets of phase 10b, each from a shipped option file: the
# options the port used to refuse, replaced in the file's text
_L1 = "    type: L1Loss\n    loss_weight: 1\n    reduction: mean\n"
_CYCLIC = ("    type: CosineAnnealingRestartCyclicLR\n    periods: [150000, 46000, 104000]\n"
           "    restart_weights: [1, 1, 1]\n    eta_mins: [0.0002, 0.0002, 0.000001]\n")
OPTION_SETS = {
    # IE: conv down / up sampling, drop-path, relu last, Adam, MultiStepRestartLR
    # after a warm-up, CombinedLoss; gdMlp kept and no SAM (the folded blocks)
    "a": ("IE_UNet_LOLv1.yml", {
        "  use_pixelshuffle: true\n  drop_path: 0.\n":
            "  use_pixelshuffle: false\n  drop_path: 0.1\n  last_act: relu\n",
        "  warmup_iter: -1\n": "  warmup_iter: 2\n",
        _CYCLIC: ("    type: MultiStepRestartLR\n    milestones: [3, 5]\n    gamma: 0.5\n"
                  "    restarts: [0, 4]\n    restart_weights: [1, 0.5]\n"),
        "    type: AdamW\n": "    type: Adam\n",
        _L1: "    type: CombinedLoss\n    loss_weight: 1\n"}),
    # the Bayesian CG: FFNv02 and SAM (the unfolded blocks), TrueCosineAnnealingLR,
    # PSNRLoss; 256 crops, so the CG's /16 input (16x16) leaves SAM its 4x4
    # bottleneck
    "b": ("CG_UNet_LOLv1.yml", {
        "  mlp_type: gdmlp\n": "  mlp_type: ffnv02\n", "  sam: false\n": "  sam: true\n",
        _CYCLIC: "    type: TrueCosineAnnealingLR\n    T_max: 6\n    eta_min: 0.000001\n",
        "    type: L1Loss\n": "    type: PSNRLoss\n",
        "    gt_size: 128\n    gt_sizes: [128]\n": "    gt_size: 256\n    gt_sizes: [256]\n"}),
}
# the kernels each option set's path must launch: (b) runs its blocks
# unfolded, the SS2D's stem and the FFNv02 as plain ops
OPTION_KERNELS = {"a": smoke.BEM_KERNELS,
                  "b": tuple(k for k in smoke.BEM_KERNELS
                             if k not in ("stem_fused_cf", "gdmlp_fused_cf"))}


def _options_cli(card, root, tag, dirs):
    """The train CLI on option set ``tag`` at full width, 6 iters."""
    name, replace = OPTION_SETS[tag]
    path = _copy_options(root, [name], **replace)[0]
    train_step_check(path, f"option set ({tag})", grad_tol=1e-5)
    torch.cuda.empty_cache()
    common = ["--device", "cuda", "--force_yml",
              f"datasets:train:dataroot_gt={dirs['train_high']}",
              f"datasets:train:dataroot_lq={dirs['train_low']}",
              f"datasets:val:dataroot_gt={dirs['val_high']}",
              f"datasets:val:dataroot_lq={dirs['val_low']}",
              f"name=smoke_set_{tag}", "logger:print_freq=1", "logger:save_checkpoint_freq=6",
              "logger:use_tb_logger=false", "logger:wandb:project=~", "train:total_iter=6",
              "datasets:train:num_worker_per_gpu=2", *SSIM]
    lines = _Lines()
    logging.getLogger("bem_tpu_torch").addHandler(lines)
    before = smoke.launch_counts()
    try:
        torch.cuda.reset_peak_memory_stats()
        model, log, first = _cli_run(path, common, root, lines)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        logging.getLogger("bem_tpu_torch").removeHandler(lines)
    counts = {k: v - before[k] for k, v in smoke.launch_counts().items()}
    losses = [float(m) for line in log for m in re.findall(r"l_pix: (\S+)", line)]
    if not (len(losses) == 6 and np.isfinite(losses).all() and model.step == 6):
        raise AssertionError(f"option set ({tag}) train CLI: l_pix {losses}, step {model.step}")
    _check_validation(f"option set ({tag}) train CLI", model.metric_results)
    net, train = model.opt["network_g"], model.opt["train"]
    in_epoch = model.timings[1:]  # iter 1 builds and warms up
    print(f"option set ({tag}) train CLI ({name}: "
          + ", ".join(f"{k} {net[k]}" for k in ("use_pixelshuffle", "drop_path", "last_act",
                                                 "mlp_type", "sam") if k in net)
          + f"; {train['optim_g']['type']}, {train['scheduler']['type']}, warm-up "
          f"{train['warmup_iter']}, {train['pixel_opt']['type']}) 6 iters B=8 "
          f"{model.opt['datasets']['train']['gt_size']} crops fp32: l_pix "
          f"{[f'{x:.5f}' for x in losses]}; first lr {first['lr']:.4e}; validation {H}x{W} "
          f"PSNR {model.metric_results['psnr']:.4f} SSIM {model.metric_results['ssim']:.4f}; wall "
          f"ms/step (data_time ms) by iter "
          + ", ".join(f"{i}: {1e3 * wall:.1f} ({1e3 * data:.1f})"
                      for i, _, data, wall in model.timings)
          + f"; median of iters 2-6: wall {1e3 * statistics.median(t[3] for t in in_epoch):.1f} "
          f"ms/step, data_time {1e3 * statistics.median(t[2] for t in in_epoch):.1f} ms; "
          f"peak memory {peak:.2f} GiB ({card})", flush=True)
    print(f"option set ({tag}) launches over its train CLI: {counts}")
    if min(counts[k] for k in OPTION_KERNELS[tag]) <= 0:
        raise AssertionError(f"a kernel of option set ({tag})'s path never launched: {counts}")
    if tag == "b" and counts["stem_fused_cf"] + counts["gdmlp_fused_cf"]:
        raise AssertionError(f"option set (b) ran a folded block: {counts}")
    del model
    torch.cuda.empty_cache()
    return counts


def options_phase(card: str):
    """The Network and training options at full width (phase 10b)."""
    root = OPTIONS_DIR
    prev = os.environ.get("BEM_ALLOW_RANDOM_VGG")
    os.environ["BEM_ALLOW_RANDOM_VGG"] = "1"
    try:
        for sub, n, seed in (("train", OPTIONS_TRAIN_IMAGES, 91), ("val", 2, 92)):
            smoke.write_eval_images(os.path.join(root, sub), n, H, W, seed)
        dirs = {f"{sub}_{kind}": os.path.join(root, sub, folder) for sub in ("train", "val")
                for kind, folder in (("low", "input"), ("high", "target"))}
        smoke.reset_launch_counts()
        for tag in OPTION_SETS:
            _options_cli(card, root, tag, dirs)
        counts = smoke.launch_counts()
    finally:
        if prev is None:
            os.environ.pop("BEM_ALLOW_RANDOM_VGG", None)
        else:
            os.environ["BEM_ALLOW_RANDOM_VGG"] = prev
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


# phase 14b: the SS2D modes and VSSM options at narrow width, card vs CPU
# ((label, MODEL.VSSM overrides, batch, post-build edit)), then VMamba-T
# (bem_tpu's vmamba_tiny fields) at full width in two forward types
MODE_TRAIN_MEM_GB = 60.0   # the training batch: the largest power of two under this
MODE_TIMED_STEPS = 3


def _gelu_m0(model):
    for m in model.modules():
        if isinstance(m, SS2D):
            m.act_layer = "gelu"


MODE_CASES = [("v052dc", dict(SSM_FORWARDTYPE="v052dc"), 2, None),
              ("v052dc_noz", dict(SSM_FORWARDTYPE="v052dc_noz"), 2, None),
              ("m0_noz", dict(SSM_FORWARDTYPE="m0_noz"), 2, None),
              ("m0 gelu", dict(SSM_FORWARDTYPE="m0"), 2, _gelu_m0)] + [
    (f"v05_on{n}", dict(SSM_FORWARDTYPE=f"v05_on{n}"), 2, None)
    for n in ("none", "dwconv3", "cnorm", "softmax", "sigmoid")] + [
    ("v05_noz_oact B=1", dict(SSM_FORWARDTYPE="v05_noz_oact"), 1, None),
    ("posembed dropout v2", dict(POSEMBED=True, SSM_DROP_RATE=0.2, SSM_INIT="v2"), 2, None)]
MODE_KERNELS = ("linear_scan", "ss2d_dir_fused", "ss2d_dir_fused_g", "ss2d_dir_fused_bwd")


def _card_vs_cpu(label, model, inputs, loss_fn, masks=None):
    """``model``'s outputs and the gradients of ``loss_fn(outputs)`` with
    respect to every parameter, on the card and on the CPU from the same
    weights and ``inputs`` (and injected ``masks``): outputs within 1e-4 of
    their largest entry, each gradient leaf within 1e-5 of its largest.
    Returns the card's gradients."""
    res = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        out = m(*(t.to(dev) for t in inputs), **({} if masks is None else {"masks": masks}))
        outs = out if isinstance(out, list) else [out]
        names = [k for k, _ in m.named_parameters()]
        grads = torch.autograd.grad(loss_fn(outs, dev), [p for _, p in m.named_parameters()])
        res[dev] = ([o.detach().cpu() for o in outs], dict(zip(names, (g.cpu() for g in grads))))
    (og, gg), (oc, gc) = res["cuda"], res["cpu"]
    out_err = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(og, oc))
    grad_err = max((gg[k] - gc[k]).abs().max().item() / max(gc[k].abs().max().item(), 1e-30)
                   for k in gc)
    ok = out_err <= 1e-4 and grad_err <= 1e-5 and all(torch.isfinite(o).all() for o in og)
    print(f"  {label:28s} outputs err / max {out_err:.2e} (tol 1e-4), gradients err / leaf max "
          f"{grad_err:.2e} (tol 1e-5) over {len(gc)} leaves {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the card disagrees with the CPU")
    return gg


def ss2d_modes_check():
    """Phase 14b (a): every SS2D mode and VSSM option bem_tpu has, on the card
    vs the CPU at narrow width (embed 16, depths (1, 1), d_state 16, 32x32,
    fp32): the logits and one train step's gradients (cross-entropy on
    seeded labels) of each MODE_CASES model, the SSM dropout's masks drawn
    once and given to both; BackboneVSSM's four outputs (depths (1, 1, 1,
    1)); a windowed VSSBlock (grid_size 8 on 28x28, so it pads) and that
    block with use_checkpoint (the same gradients on the card). Each of
    MODE_KERNELS must launch."""
    smoke.reset_launch_counts()
    rng = np.random.default_rng(14)
    for label, overrides, B, edit in MODE_CASES:
        c = _narrow_cls_config()
        for k, v in overrides.items():
            c.MODEL.VSSM[k] = v
        model = build_model_from_config(c, torch.Generator().manual_seed(15))
        if edit:
            edit(model)
        images = torch.from_numpy(rng.random((B, 32, 32, 3), np.float32))
        labels = torch.from_numpy(rng.integers(0, 10, B))
        masks = None
        if c.MODEL.VSSM.SSM_DROP_RATE:  # each block's masks, drawn for its input's shape
            s = 32 // c.MODEL.VSSM.PATCH_SIZE
            masks = {f"layer{i}_block0": getattr(model, f"layer{i}_block0").draw_masks(
                torch.zeros(B, 16 * 2 ** i, s >> i, s >> i), torch.Generator().manual_seed(i))
                for i in range(2)}
        _card_vs_cpu(label, model, (images,),
                     lambda o, dev, y=labels: cross_entropy(o[0], y.to(dev)), masks)
    c = _narrow_cls_config()
    v = c.MODEL.VSSM
    backbone = init.initialize(BackboneVSSM(
        depths=(1, 1, 1, 1), dims=16, ssm_d_state=16, drop_path_rate=0.0, forward_type="v2",
        patchembed_version=v.PATCHEMBED, downsample_version=v.DOWNSAMPLE),
        torch.Generator().manual_seed(16))
    images = torch.from_numpy(rng.random((2, 32, 32, 3), np.float32))
    cots = [torch.from_numpy(rng.standard_normal((2, s, s, 16 * 2 ** i), np.float32))
            for i, s in enumerate((8, 4, 2, 1))]
    _card_vs_cpu("BackboneVSSM 4 outputs", backbone, (images,),
                 lambda o, dev: sum((a * g.to(dev)).sum() for a, g in zip(o, cots)))
    x = torch.from_numpy(rng.standard_normal((2, 16, 28, 28), np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 16, 28, 28), np.float32))
    grads = []
    for ckpt in (False, True):
        block = init.initialize(VSSBlock(16, ssm_d_state=16, ssm_ratio=2.0, mlp_type="mlp",
                                         forward_type="v2", grid_size=8, ssm_drop_rate=0.1,
                                         drop_path=0.2, use_checkpoint=ckpt),
                                torch.Generator().manual_seed(17))
        masks = block.draw_masks(x, torch.Generator().manual_seed(18))
        grads.append(_card_vs_cpu(f"VSSBlock grid 8 28x28 ckpt {int(ckpt)}", block, (x,),
                                  lambda o, dev: (o[0] * cot.to(dev)).sum(), masks))
    same = all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
    err = max((grads[0][k] - grads[1][k]).abs().max().item()
              / max(grads[0][k].abs().max().item(), 1e-30) for k in grads[0])
    print(f"  use_checkpoint vs none on the card: gradients err / leaf max {err:.2e} "
          f"(tol 1e-6){', bit-identical' if same else ''}")
    if not err <= 1e-6:
        raise AssertionError("use_checkpoint changes the gradients on the card")
    counts = smoke.launch_counts()
    print(f"launches over the SS2D modes checks: { {k: v for k, v in counts.items() if v} }")
    if min(counts[k] for k in MODE_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the SS2D modes never launched: {counts}")
    return counts


def _vmamba_t_config(forward_type, batch=None):
    """bem_tpu's vmamba_tiny fields (vssm.py:180-183) in the harness config."""
    c = vmamba_tiny(get_config(), forward_type)
    c.DATA.BATCH_SIZE = batch or c.DATA.BATCH_SIZE
    return c


def vmamba_modes_phase(card: str, forward_type: str, kernels=()):
    """Phase 14b (b): VMamba-T (vmamba_tiny) with ``forward_type`` at 224x224:
    bf16 throughput at batch 128 through throughput() (1 warm-up + 5 timed
    batches); training at the largest power-of-two batch up to 128 whose
    peak memory, extrapolated from a step at batch 8, stays under
    MODE_TRAIN_MEM_GB (1 warm-up + MODE_TIMED_STEPS timed steps): ms/step
    and peak memory. Each of ``kernels`` must launch; with none, no kernel
    may launch."""
    c = _vmamba_t_config(forward_type)
    model = build_model_from_config(c, torch.Generator().manual_seed(c.SEED)).to("cuda")
    smoke.reset_launch_counts()
    ips = throughput(model, batch=CLS_BATCH, size=c.DATA.IMG_SIZE, iters=N_TRAIN_STEPS)
    tp_counts = smoke.launch_counts()
    S = c.DATA.IMG_SIZE
    print(f"VMamba-T {forward_type} throughput B={CLS_BATCH} {S}x{S} bf16: {ips:.1f} images/s, "
          f"{1e3 * CLS_BATCH / ips:.1f} ms/batch ({card})", flush=True)
    del model
    torch.cuda.empty_cache()

    def train(batch, steps):
        cb = _vmamba_t_config(forward_type, batch)
        torch.cuda.reset_peak_memory_stats()
        m = build_model_from_config(cb, torch.Generator().manual_seed(cb.SEED))
        state, train_step, _ = make_trainer(m, total_steps=300 * -(-IMAGENET_TRAIN // batch),
                                            base_lr=cb.TRAIN.BASE_LR, warmup_steps=20,
                                            device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        times = []
        for i in range(1 + steps):
            images, labels = cls_batch(cb, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = train_step(state, images, labels)
            loss = float(loss)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if not np.isfinite(loss):
                raise AssertionError(f"VMamba-T {forward_type} B={batch}: loss {loss}")
        mem = torch.cuda.max_memory_allocated() / 1e9
        del m, state
        torch.cuda.empty_cache()
        return times[1:], mem, loss

    _, probe_mem, _ = train(8, 0)
    batch = CLS_BATCH
    while batch > 8 and probe_mem * batch / 8 > MODE_TRAIN_MEM_GB:
        batch //= 2
    times, mem, loss = train(batch, MODE_TIMED_STEPS)
    med = statistics.median(times)
    print(f"VMamba-T {forward_type} train B={batch} {S}x{S} fp32: median {1e3 * med:.1f} "
          f"ms/step ({', '.join(f'{1e3 * t:.1f}' for t in times)}), {batch / med:.1f} images/s, "
          f"peak memory {mem:.2f} GB (batch 8: {probe_mem:.2f} GB), last loss {loss:.4f} "
          f"({card})", flush=True)
    counts = smoke.launch_counts()
    print(f"VMamba-T {forward_type} launches: throughput "
          f"{ {k: v for k, v in tp_counts.items() if v} }; the phase "
          f"{ {k: v for k, v in counts.items() if v} }")
    if kernels and min(counts[k] for k in kernels) <= 0:
        raise AssertionError(f"VMamba-T {forward_type}: a kernel never launched: {counts}")
    if not kernels:
        if sum(counts.values()):
            raise AssertionError(f"VMamba-T {forward_type} launched a kernel: {counts}")
        print(f"VMamba-T {forward_type} runs no kernel of the port (plain tensor code)")
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
    phase("flagship at full width")
    try:
        flagship_counts = flagship_phase(card)
    finally:
        shutil.rmtree(FLAGSHIP_DIR, ignore_errors=True)
    phase("flagship and QD training at full width")
    try:
        flagship_train_counts = flagship_train_phase(card)
    finally:
        shutil.rmtree(FLAGSHIP_TRAIN_DIR, ignore_errors=True)
    phase("VMUNet family, UIQM+UCIQE eval and reference checkpoints at full width")
    try:
        vmunet_counts = vmunet_phase(card)
    finally:
        shutil.rmtree(VMUNET_DIR, ignore_errors=True)
    phase("image formats at full width")
    try:
        formats_counts = formats_phase(card)
    finally:
        shutil.rmtree(FORMATS_DIR, ignore_errors=True)
    phase("speed test at 2048x2048")
    speed_counts = speed_phase(card)
    phase("Network and training options at full width")
    try:
        options_counts = options_phase(card)
    finally:
        shutil.rmtree(OPTIONS_DIR, ignore_errors=True)
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
    phase("SS2D modes and VSSM options, card vs CPU")
    modes_counts = ss2d_modes_check()
    phase("VMamba-T v052dc_noz and m0_noz at full width")
    cascade_counts = vmamba_modes_phase(card, "v052dc_noz", ("linear_scan",))
    vmamba_modes_phase(card, "m0_noz")
    phase("microbenchmarks")
    mb_counts = microbench_phase()
    # each kernel's launches over the runs of its own paths: the BEM kernels
    # over the training, train / test CLI, serving, eval, flagship, flagship
    # training, VMUNet family, image formats, speed test and option-set runs, the fused core and its backward over VMamba-T's, the
    # clamped form over the narrow reference runs, selective_scan_fused over
    # VMamba-T v052d's, the SS2D modes' over their checks and VMamba-T
    # v052dc_noz's, the microbenchmarks over their sweeps
    paths = {name: (train_counts, cli_counts, serve_counts, eval_counts, flagship_counts,
                    flagship_train_counts, vmunet_counts, formats_counts, speed_counts,
                    options_counts)
             for name in smoke.BEM_KERNELS}
    paths["linear_scan"] += (modes_counts, cascade_counts)
    paths.update(ss2d_dir_fused=(cls_train_counts, cls_tp_counts, modes_counts),
                 ss2d_dir_fused_bwd=(cls_train_counts, cls_tp_counts, modes_counts),
                 ss2d_dir_fused_g=(cls_ref_counts, modes_counts),
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
