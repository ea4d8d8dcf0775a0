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
  7b. the same pipeline's serving module exported with torch.export
     (tools/export_onchip.py: the bem:: operators of rows 1-7 in its
     graph), saved, loaded back and run on 3 requests beside the live
     pipeline, each request's weight noise from the same seeded generator:
     the same chosen candidates, NIQE scores within 1e-6 relative, rows
     1-7 launched inside the artifact; both ms/request, the export and
     load seconds, the artifact's bytes, and the host microseconds of one
     bem::ss2d_tail call against its CUDA implementation called directly;
  7c. the native host library (bem_tpu_torch/native, g++) builds, and its
     KDE histograms equal the numpy route's at 448x640, patch 16, 256 bins
     (1e-4 relative), with both host times;
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
 14c. the classifier's command line at full width: an ImageFolder tree
     (3 classes x 32 train and 8 val images, 180x240 to 375x500, PNG,
     baseline JPEG under .jpg and .JPEG and 24-bit BMP, written by the
     port's writers) and a BASE YAML with the model YAML that names it,
     which together give the harness defaults (VMamba-T v2, 224x224); the
     loader's first training batch on the card bit-identical to the same
     seed's batch on the CPU; the model's logits on its first image card
     vs CPU (1e-4 of their largest, TF32 off; the CPU forward of a
     full-width VMamba-T takes about 12 s an image); then ``python -m
     bem_tpu_torch.classification.train`` in its own process (through
     runpy, which then prints the process's launches) to train (batch 32,
     one epoch of three steps with TRAIN.WARMUP_EPOCHS 0, validation),
     with --eval, and with --throughput at batch 64, at PyTorch's TF32
     defaults: finite loss, top-1 / top-5 in [0, 1], ms/step, data_time,
     peak memory, images/s; rows 8 and 9 must launch;
 14d. the RealESRGAN data at full width: RealESRGANDataset at the published
     x4plus degradation settings (smoke.REALESRGAN_X4PLUS: crop_pad_size
     400, 21-tap kernels) over 8 seeded files of about 480x640 (PNG and
     baseline JPEG), RealESRGANPairedDataset over their x4 pairs (gt_size
     256), each through build_dataloader (batch 4, 2 threads) and
     DevicePrefetcher: NHWC gt (4, 400, 400, 3) on the card, each kernel
     21 x 21 summing to 1, the loader's items/s; on the first prefetched
     batch diff_jpeg at qualities 30 and 90 (1e-4 outside the blocks of
     coefficients within 1e-3 of a rounding tie) and the device USM (1e-5
     away from pixels whose sharpening mask flips), card vs CPU, each with
     its time on the card; no kernel of the port launches;
 14e. the model zoo (bem_tpu_torch.analysis.model_zoo) at full width, the
     nine baselines from their builders (seeded, the reference's comparison
     configs: EDSR, RCAN, HWMNet, LLFormer, RetinexFormer, UVMNet, MambaIR,
     SwinIR, HAT), fp32 with TF32 off: each net's output on the card
     against the port on the CPU at 32x32 (UVMNet's first two levels, inc
     and down1, at its fixed 64x64 working size), within 2e-4 of max(1,
     |CPU|), and count_flops equal on both devices; then at 256x256, B=1, no gradient: the parameters,
     FLOPs, images/s through analysis.throughput (1 warm-up + 5 timed
     forwards) and peak memory, with that run's launches: row 8 must
     launch for MambaIR (its SS2D with scan_backend "xla", never clamped)
     and row 7 for UVMNet (Mamba1D's selective scan); rows 7 and 8 are
     also held against their plain versions at these nets' shapes in the
     kernels' phase (smoke.ZOO_DIR_SHAPES, smoke.ZOO_SCAN_SHAPES);
 14f. video data, flow warp, DCN and WebP: REDSDataset at REDS's published
     sizes (seeded PNG clips, GT 1280x720, LQ 320x180, quantized flows in
     dataroot_flow) with EDVR's REDS options (num_frame 5, gt_size 256,
     scale 4, batch 4) and Vimeo90KDataset (GT 448x256, LQ 112x64, 7
     frames), each through build_dataset / build_dataloader (an
     EnlargedSampler: 64 items, 16 batches) and DevicePrefetcher, items/s
     over the 15 batches after the first (the clock starts once the first
     batch is on the card); on the first REDS batch flow_warp of each
     LQ frame by its flow, card vs CPU; DCNv2Pack at EDVR-L's alignment
     width (128 channels, 8 deform groups, 3x3) on a 5-frame 180x320
     feature stack and flow_warp at BasicVSR's 64 channels, card vs CPU on
     64x64 crops (2e-4 of max(1, |CPU|), fp32, TF32 off), card ms and peak
     memory at full size; upfirdn2d ([1, 3, 3, 1], up 2, pad (2, 1)) and
     fused_leaky_relu at StyleGAN2's (4, 512, 64, 64), card vs CPU; the
     LOLv1 IE with scan_backend "xla" card vs CPU at 64x96, then at 400x600
     (padded 448x640) B=2 on the card, where row 8 must launch unclamped
     (its chunked forward's carry on row 7) and no fused serving row may; count_flops of the default IE equal on
     card and CPU; the committed WebP fixtures (lossy q80 at 400x600, a
     lossless and an alpha 112x144 crop) decoded on the host equal to the
     PNGs beside them, with each decode's ms, then the train CLI (LOLv1 IE
     options) 4 iterations on pairs of the two crops (the alpha crop,
     lossy VP8 with an ALPH plane read in colour, as inputs; the lossless
     crop as targets);
 15. multi-GPU on the one card: 2 ranks through parallel.spawn (the spawn
     start method; the kernels built here first, the ranks load that
     library), gloo since both ranks share the card, every collective
     staged through the host; against one process on the same card (TF32
     off): (a) context_parallel_linear_scan at row 7's (8, 16384, 40) fp32
     against linear_scan_plain of the whole sequence (2e-4 of max(1,
     |plain|)), row 7 launching on each rank, and its ms against row 7 on
     the whole sequence; (b) spatial_apply of the LOLv1 IE on the "xla"
     route at 448x640 B=2 fp32 against the unsharded net (2e-4), row 8 on
     each rank at L = H*W/2 of every level, both ms; then the speed test
     at 2048x2048 under --spatial_shard 2, bf16 and fp32 (--repeat 1, its
     running time); (c) one IE and one CG step of the LOLv1 options at a
     global batch of 8, 4 a rank, against the one-process step from the
     same weights and draws (the params within 1e-4 of 1 + |p| where the
     gradient is clear, within 2 lr elsewhere; ms/step both ways), then the
     train CLI under --launcher pytorch (torchrun's environment) for 4
     iterations on 16 seeded 400x600 PNG pairs: finite losses, and one log
     and the checkpoints, rank 0's alone; (d) the eval CLI on three seeded
     400x600 PNGs, the LOLv1 option files, K=16, niqe, with --shard_samples
     on over the ranks against --shard_samples off in one process: the
     same picks, the PNGs within 1 LSB, s/img both ways. Its launches are
     the ranks' summed;
 16. the microbenchmarks (bem_tpu_torch.tools.microbench_vpu): the lanes /
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
import random
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from bem_tpu_torch import _build, analysis, smoke
from bem_tpu_torch.analysis import model_zoo
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.archs.arch_util import DCNv2Pack, flow_warp
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.classification import build_model_from_config, get_config, make_trainer
from bem_tpu_torch.classification import synthetic_batch as cls_batch
from bem_tpu_torch.classification import cross_entropy, throughput, vmamba_tiny
from bem_tpu_torch.classification.data import build_loader as cls_build_loader
from bem_tpu_torch.classification.train import parse_option as cls_parse_option
from bem_tpu_torch.data import (CPUPrefetcher, DevicePrefetcher, EnlargedSampler,
                                build_dataloader, build_dataset)
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
from bem_tpu_torch.ops import legacy
from bem_tpu_torch.tools import export_onchip, microbench_vpu
from bem_tpu_torch import native
from bem_tpu_torch.utils import histogram
from bem_tpu_torch.models.base_model import BaseModel
from bem_tpu_torch.test import test_pipeline
from bem_tpu_torch.train import synthetic_batch, train_pipeline
from bem_tpu_torch.utils.checkpoint import load_params, load_state
from bem_tpu_torch.utils.cv_ops import resize as cv_resize
from bem_tpu_torch.utils.diffjpeg import diff_jpeg, diff_round
from bem_tpu_torch.utils.flow_util import flowwrite
from bem_tpu_torch.utils.img_process_util import gaussian_blur_torch, usm_sharp_torch
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
EXPORT_DIR = os.path.join(REPO, "results", "chip_smoke_export")  # gitignored, removed at the end
NATIVE_PATCH, NATIVE_BINS = 16, 256
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
# card ms the kernels' phase spends on timing each case's plain version
# (the kernel's own: smoke.time_ms's default 300)
PLAIN_BUDGET_MS = 100.0
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
CLS_CLI_DIR = os.path.join(REPO, "results", "chip_smoke_cls_cli")  # gitignored, removed at the end
# ``python -m bem_tpu_torch.classification.train ARGS`` through runpy, then the
# process's kernel launches on a line of their own
CLS_CLI_RUN = ("import json, runpy; from bem_tpu_torch import smoke; "
               "runpy.run_module('bem_tpu_torch.classification.train', run_name='__main__', "
               "alter_sys=True); print('launches ' + json.dumps(smoke.launch_counts()), "
               "flush=True)")
REALESRGAN_DIR = os.path.join(REPO, "results", "chip_smoke_realesrgan")  # removed at the end
REALESRGAN_FILES = 8  # about 480x640 each
DIFFJPEG_QUALITIES = (30, 90)
DIFFJPEG_TIE = 1e-3  # quantized coefficients this close to a rounding tie may round either way
VIDEO_DIR = os.path.join(REPO, "results", "chip_smoke_video")  # gitignored, removed at the end
REDS_FRAMES = 8  # frames of the one REDS training clip
VIMEO_SEQS = 16  # Vimeo90K septuplets
# dataset_enlarge_ratio of each (EDVR's REDS options use 200): 64 items, 16
# batches of 4, of which the 15 after the first are timed
VIDEO_ENLARGE = {"REDSDataset": 8, "Vimeo90KDataset": 4}
VIDEO_TOL = 2e-4  # card vs CPU, of max(1, |CPU|), fp32, TF32 off
WEBP_FIXTURES = ("g_lossy_q80", "h_lossless", "i_alpha")
# what the IE's "xla" route may launch: row 8 unclamped, whose chunked
# forward carries its super-chunk states on row 7
XLA_ROUTE_KERNELS = ("ss2d_dir_fused", "linear_scan")


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.0f} s)", flush=True)


def process_seconds() -> float | None:
    """Wall seconds since this process started (its start time in
    /proc/self/stat against /proc/uptime), or None where there is no /proc."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


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
        plain_ms = smoke.time_ms(case.plain, case.args, budget_ms=PLAIN_BUDGET_MS)
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


def export_phase(card: str):
    """The full-width serving pipeline exported, saved, loaded and run
    beside the live one (``tools.export_onchip``): its checks, its line, and
    the artifact's launches over its 3 requests."""
    out = export_onchip.main(os.path.join(EXPORT_DIR, "serve.pt2"))
    print(f"serving artifact K={K} NIMG={NIMG} {H}x{W} bf16: {out['iter_ms_exported']:.1f} "
          f"ms/request against {out['iter_ms_live']:.1f} live ({out['exported_vs_live']:.4f}x), "
          f"NIQE rel err {out['value_rel_err']:.3e}, selected crops "
          f"{out['selected_max_abs_err']:.3e} apart, export {out['export_s']:.1f} s, load "
          f"{out['load_s']:.1f} s, {out['artifact_bytes']} bytes, {out['graph_nodes']} nodes; "
          f"bem::ss2d_tail {out['op_call_us']:.2f} us a call, its CUDA implementation "
          f"{out['op_body_us']:.2f} us ({card})")
    return out["launches_in_artifact"]


def native_check(card: str):
    """The native library builds on the card's host, and its KDE histograms
    equal the numpy route's at 400x600 padded to 448x640 (the eval CLI's
    pad, eval.py), patch 16 (the eval's condition grid at the /16
    reduction: its scale factor is hist_patch_size) and 256 bins
    (compute_histograms' default); both host times."""
    if not native.available():
        raise AssertionError("native: the host library did not build")
    rng = np.random.default_rng(0)
    img = np.pad(rng.random((H, W, 3), np.float32),
                 ((0, padded_size(H, W)[0] - H), (0, padded_size(H, W)[1] - W), (0, 0)),
                 mode="reflect")
    t0 = time.perf_counter()
    got = native.kde_histograms(img, NATIVE_PATCH, NATIVE_BINS)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = histogram._compute_histograms_np(img, NATIVE_PATCH, NATIVE_BINS)
    t_np = time.perf_counter() - t0
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"native KDE histograms {img.shape[0]}x{img.shape[1]} patch {NATIVE_PATCH} "
          f"{NATIVE_BINS} bins: max rel err {err:.3e} (tol 1e-4), native {1e3 * t_native:.1f} ms "
          f"(2 threads), numpy {1e3 * t_np:.1f} ms ({card})")
    if got.shape != want.shape or err > 1e-4:
        raise AssertionError(f"native KDE histograms disagree with numpy: {err}")


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


# phase 14c: the classifier's command line at full width

def _cls_cli(args, label):
    """One run of the classifier CLI in its own process: its output lines
    (echoed), its launch counts, its wall seconds."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", CLS_CLI_RUN, *args], capture_output=True,
                       text=True, timeout=900, cwd=REPO)
    wall = time.perf_counter() - t0
    out = r.stdout + r.stderr
    for line in out.splitlines():
        if "INFO" in line or "Error" in line or "error" in line or line.startswith("launches"):
            print(f"  [{label}] {line[-400:]}")
    if r.returncode != 0:
        print(out[-6000:])
        raise AssertionError(f"classifier CLI ({label}) exited with {r.returncode}")
    m = re.search(r"^launches (\{.*\})$", r.stdout, re.M)
    return out, json.loads(m.group(1)), wall


def _grab(pattern, text, label):
    m = re.search(pattern, text)
    if m is None:
        raise AssertionError(f"classifier CLI ({label}): no line matching {pattern!r}")
    return [float("nan") if g is None else float(g) for g in m.groups()]


def _cls_host_split(cfg, card, n=32):
    """The loader's host time a training image over the first ``n`` of the
    tree: the decode by format, then the train transform."""
    ds = cls_build_loader(cfg)[0]
    tf, ds.transform = ds.transform, None
    py_rng, np_rng = random.Random(0), np.random.RandomState(0)
    decode, transform = {}, []
    for i in range(n):
        t0 = time.perf_counter()
        img, _ = ds.get(i)
        t1 = time.perf_counter()
        tf(img, py_rng, np_rng)
        transform.append(time.perf_counter() - t1)
        decode.setdefault(os.path.splitext(ds.samples[i][0])[1], []).append(t1 - t0)
    per = ", ".join(f"{k} {1e3 * statistics.mean(v):.1f}" for k, v in sorted(decode.items()))
    total = sum(map(sum, decode.values())) + sum(transform)
    print(f"classifier loader host time over {n} images: decode {per} ms an image, train "
          f"transform {1e3 * statistics.mean(transform):.1f} ms an image; "
          f"{1e3 * total / n:.1f} ms an image in all ({card})", flush=True)


def cls_cli_phase(card: str):
    """Phase 14c: ``python -m bem_tpu_torch.classification.train`` on an
    ImageFolder tree (3 classes x 32 train / 8 val images, 180x240 to
    375x500, PNG / baseline JPEG (.jpg, .JPEG) / BMP written by the port's
    writers) with a BASE YAML and a model YAML that give the harness
    defaults (VMamba-T v2, 224x224): train (batch 32, one epoch of three
    steps, then validation), --eval, --throughput at batch 64. The loader's
    first batch on the card equal to a second run's on the CPU; the
    model's logits on its first image card vs CPU (1e-4 of their
    largest, TF32 off); finite loss, top-1 / top-5 in [0, 1]; rows 8 and
    9 must launch."""
    root = CLS_CLI_DIR
    tree = os.path.join(root, "imagenet")
    t0 = time.perf_counter()
    files = smoke.write_imagefolder(tree, classes=3, train=32, val=8, seed=19)
    cfg_path = smoke.write_cls_yaml(root)
    kinds = {e: sum(f.endswith(e) for f in files) for e in smoke.IMAGE_EXTS}
    print(f"wrote {len(files)} images {kinds} and two YAML files in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    args = ["--cfg", cfg_path, "--data-path", tree, "--output", os.path.join(root, "output")]
    _, cfg = cls_parse_option(args + ["--batch-size", "32"])
    ref = get_config()
    ref.BASE, ref.OUTPUT, ref.DATA.DATA_PATH, ref.DATA.BATCH_SIZE = cfg.BASE, cfg.OUTPUT, tree, 32
    if cfg != ref:
        raise AssertionError("the two YAML files do not give the harness defaults")
    t0 = time.perf_counter()
    images, labels = next(iter(cls_build_loader(cfg)[2]))
    first_batch_s = time.perf_counter() - t0
    on_card = torch.from_numpy(images).to("cuda")
    again, again_labels = next(iter(cls_build_loader(cfg)[2]))
    same = torch.equal(on_card.cpu(), torch.from_numpy(again)) and np.array_equal(labels,
                                                                                  again_labels)
    print(f"first training batch {tuple(images.shape)} {images.dtype} (host {first_batch_s:.2f} "
          f"s): on the card bit-identical to the same seed's batch on the CPU: {same}",
          flush=True)
    if not same:
        raise AssertionError("the classifier loader's first batch differs between two runs")
    _cls_host_split(cfg, card)
    model = build_model_from_config(cfg, torch.Generator().manual_seed(cfg.SEED)).eval()
    x = torch.from_numpy(images[:1])
    t0 = time.perf_counter()
    with torch.no_grad():
        lc = model(x)
        cpu_s = time.perf_counter() - t0
        lg = copy.deepcopy(model).to("cuda")(x.to("cuda")).cpu()
    err = (lg - lc).abs().max().item() / lc.abs().max().item()
    print(f"VMamba-T v2 logits of the batch's first image, card vs CPU: err / max {err:.2e} "
          f"(tol 1e-4; CPU forward {cpu_s:.1f} s)", flush=True)
    if not err <= 1e-4:
        raise AssertionError("classifier CLI: the card's logits disagree with the CPU's")
    del model
    train_out, train_counts, train_wall = _cls_cli(
        args + ["--batch-size", "32", "--opts", "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0"],
        "train")
    loss, t1, t5 = _grab(r"epoch 0: loss (\S+) top1 (\S+) top5 (\S+)", train_out, "train")
    steps, step_ms, data_ms, mem = _grab(
        r"epoch 0: (\d+) steps, median step (\S+) ms, data_time (\S+) ms(?:, peak memory (\S+) GiB)?",
        train_out, "train")
    eval_out, eval_counts, eval_wall = _cls_cli(args + ["--batch-size", "32", "--eval"], "eval")
    e1, e5 = _grab(r"eval top1 (\S+) top5 (\S+)", eval_out, "eval")
    tp_out, tp_counts, tp_wall = _cls_cli(args + ["--batch-size", "64", "--throughput"],
                                          "throughput")
    (ips,) = _grab(r"throughput: (\S+) images/s", tp_out, "throughput")
    print(f"classifier CLI VMamba-T v2 224x224: train batch 32 {int(steps)} steps, loss {loss}, "
          f"top1 {t1} top5 {t5}, median {step_ms} ms/step, data_time {data_ms} ms, peak memory "
          f"{mem} GiB ({train_wall:.1f} s the process); eval top1 {e1} top5 {e5} "
          f"({eval_wall:.1f} s); throughput batch 64 bf16 {ips} images/s ({tp_wall:.1f} s) "
          f"({card})", flush=True)
    ok = (np.isfinite(loss) and int(steps) == 3
          and all(0.0 <= v <= 1.0 for v in (t1, t5, e1, e5)) and ips > 0)
    if not ok:
        raise AssertionError("classifier CLI: a non-finite loss or an accuracy outside [0, 1]")
    for label, c, need in (("train", train_counts, ("ss2d_dir_fused", "ss2d_dir_fused_bwd")),
                           ("eval", eval_counts, ("ss2d_dir_fused",)),
                           ("throughput", tp_counts, ("ss2d_dir_fused",))):
        print(f"classifier CLI {label} launches: { {k: v for k, v in c.items() if v} }")
        if min(c[k] for k in need) <= 0:
            raise AssertionError(f"classifier CLI {label}: a kernel never launched: {c}")
    return {k: train_counts[k] + eval_counts[k] + tp_counts[k] for k in train_counts}


# phase 14d: the RealESRGAN data path at full width

def _tie_blocks(ycc_vals, shape):
    """(B, H, W, 1) mask of the 8 x 8 luma (16 x 16 chroma) blocks with a
    quantized coefficient within DIFFJPEG_TIE of a rounding tie."""
    B, H, W = shape[:3]
    mask = torch.zeros((B, H, W), dtype=torch.bool)
    for ci, v in enumerate(ycc_vals):
        s = 1 if ci == 0 else 2
        near = ((v - v.floor()).sub(0.5).abs() < DIFFJPEG_TIE).flatten(2).any(-1)
        nbw = W // (8 * s)
        for b, n in zip(*torch.nonzero(near, as_tuple=True)):
            r, c = divmod(int(n), nbw)
            mask[b, r * 8 * s:(r + 1) * 8 * s, c * 8 * s:(c + 1) * 8 * s] = True
    return mask[..., None]


def _diff_jpeg_check(gt, card):
    """diff_jpeg of a prefetched batch on the card vs the CPU: within 1e-4
    outside the blocks of near-tie coefficients (located on the CPU's
    values, printed as a share of the pixels), and its time on the card."""
    x_cpu = gt.cpu()
    for q in DIFFJPEG_QUALITIES:
        seen = []

        def capture(v):
            seen.append(v.detach())
            return diff_round(v)

        want = diff_jpeg(x_cpu, q, rounding=capture)
        got = diff_jpeg(gt, q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            diff_jpeg(gt, q)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 5
        mask = _tie_blocks(seen, x_cpu.shape)
        err = torch.where(mask, 0, got.cpu() - want).abs().max().item()
        print(f"diff_jpeg q{q} {tuple(gt.shape)} card vs CPU: max abs err {err:.2e} (tol 1e-4) "
              f"outside near-tie blocks ({100 * mask.float().mean().item():.2f} % of the "
              f"pixels); all pixels {(got.cpu() - want).abs().max().item():.2e}; "
              f"{ms:.2f} ms on the card ({card})", flush=True)
        if not (err <= 1e-4 and mask.float().mean().item() <= 0.2):
            raise AssertionError(f"diff_jpeg q{q}: the card disagrees with the CPU")


def _usm_check(gt, card):
    """usm_sharp_torch of a prefetched batch on the card vs the CPU: within
    1e-5 away (51 px, the blur's reach) from any pixel whose sharpening
    mask differs between the two; the flips printed."""
    x_cpu = gt.cpu()
    want = usm_sharp_torch(x_cpu)
    got = usm_sharp_torch(gt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        usm_sharp_torch(gt)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 5
    masks = [((x - gaussian_blur_torch(x)).abs() * 255 > 10).cpu() for x in (gt, x_cpu)]
    flips = (masks[0] != masks[1]).float().permute(0, 3, 1, 2)
    near = torch.nn.functional.max_pool2d(flips, 51, 1, 25).permute(0, 2, 3, 1) > 0
    d = (got.cpu() - want).abs()
    err = torch.where(near, 0, d).max().item()
    print(f"usm_sharp_torch {tuple(gt.shape)} card vs CPU: max abs err {err:.2e} (tol 1e-5) "
          f"away from {int(flips.sum())} mask flips; all pixels {d.max().item():.2e}; "
          f"{ms:.2f} ms on the card ({card})", flush=True)
    if not err <= 1e-5:
        raise AssertionError("usm_sharp_torch: the card disagrees with the CPU")


# phase 14e: the model zoo (analysis/model_zoo) at full width: card vs CPU
# at ZOO_CPU_SIZE (UVMNet at its fixed 64x64 working size), then each net at
# ZOO_SIZE, B = 1, fp32, TF32 off, no gradient
ZOO_SIZE = 256
ZOO_CPU_SIZE = 32
ZOO_ITERS = 5  # throughput(): timed forwards after one warm-up
ZOO_TOL = 2e-4  # of max(1, |CPU|)
ZOO_KERNELS = {"MambaIR": ("ss2d_dir_fused",), "UVMNet": ("linear_scan",)}


def zoo_phase(card: str):
    """Each of the nine baselines from its builder (seeded, the reference's
    comparison config): its output on the card against the port on the CPU
    at ZOO_CPU_SIZE (UVMNet 64x64), and count_flops equal on both devices;
    then at ZOO_SIZE the parameters, FLOPs (count_flops), images/s
    (analysis.throughput) and peak memory, with the launches of that run:
    rows 8 (MambaIR) and 7 (UVMNet) must launch. Returns the launches of
    the full-width runs."""
    totals = dict.fromkeys(smoke.KERNELS, 0)
    for name, build in model_zoo.BUILDERS.items():
        t0 = time.perf_counter()
        net = build(device="cpu")
        size = 64 if name == "UVMNet" else ZOO_CPU_SIZE
        gen = torch.Generator().manual_seed(0)
        x = torch.rand(1, 3, size, size, generator=gen)
        # UVMNet's check runs its first two levels (inc, down1): each level's
        # UVMB works at 64x64 whatever the input, and the deep ones' CPU
        # forwards took 89.6 s of the phase
        head = ((lambda t: net.down1(torch.nn.functional.max_pool2d(net.inc(t), 2)))
                if name == "UVMNet" else net)
        outs = []
        cpu_flops = analysis.count_flops(lambda t: outs.append(head(t)), x)["flops"]
        t_cpu = time.perf_counter() - t0
        net.to("cuda")
        card_flops = analysis.count_flops(lambda t: outs.append(head(t)), x.to("cuda"))["flops"]
        ref, got = outs[0], outs[1].cpu()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: card output {tuple(got.shape)} vs {tuple(ref.shape)}")
        err = (got - ref).abs().max().item()
        tol = ZOO_TOL * max(1.0, ref.abs().max().item())
        what = f"{name} inc + down1" if name == "UVMNet" else name
        print(f"zoo {what:13s} card vs CPU at {size}x{size}: max_abs_err {err:.3e} tol {tol:.3e} "
              f"{'ok' if err <= tol else 'FAIL'}; count_flops card {card_flops:.6e} CPU "
              f"{cpu_flops:.6e} (CPU forward {t_cpu:.1f} s)", flush=True)
        if err > tol or card_flops != cpu_flops:
            raise AssertionError(f"{name}: card vs CPU {err} > {tol} or FLOPs "
                                 f"{card_flops} != {cpu_flops}")
        del outs, ref, got
        x = torch.rand(1, 3, ZOO_SIZE, ZOO_SIZE, generator=gen).to("cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        smoke.reset_launch_counts()
        ips = analysis.throughput(net, x, iters=ZOO_ITERS, warmup=1)
        flops = analysis.count_flops(net, x)["flops"]
        counts = smoke.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launched = {k: v for k, v in counts.items() if v}
        print(f"zoo {name:13s} {ZOO_SIZE}x{ZOO_SIZE} B=1 fp32 TF32 off: params "
              f"{analysis.count_params(net)}, FLOPs {flops:.6e}, {ips:.3f} images/s, peak "
              f"{peak:.2f} GiB; launches {launched} ({card}; {time.perf_counter() - t0:.1f} s)",
              flush=True)
        if any(counts[k] <= 0 for k in ZOO_KERNELS.get(name, ())):
            raise AssertionError(f"{name}: a kernel of its path never launched: {counts}")
        for k, v in counts.items():
            totals[k] += v
        del net, x
        torch.cuda.empty_cache()
    return totals


def realesrgan_phase(card: str):
    """Phase 14d: RealESRGANDataset at the published x4plus degradation
    settings (smoke.REALESRGAN_X4PLUS) over 8 seeded files of about
    480x640 (PNG and baseline JPEG), and RealESRGANPairedDataset over
    their x4 pairs (gt_size 256), each through build_dataloader (batch 4,
    2 threads) and DevicePrefetcher: the batches' shapes on the card,
    every kernel 21 x 21 summing to 1; the loader's items/s; diff_jpeg at
    qualities 30 and 90 and the device USM on the first prefetched batch,
    card vs CPU. It launches no kernel of the port."""
    rng = np.random.default_rng(23)
    gt_dir, lq_dir = (os.path.join(REALESRGAN_DIR, d) for d in ("gt", "lq"))
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(lq_dir, exist_ok=True)
    for i in range(REALESRGAN_FILES):
        h, w = 480 + 4 * int(rng.integers(-4, 5)), 640 + 4 * int(rng.integers(-4, 5))
        img = smoke.smooth_image(rng, h, w)
        ext = (".png", ".jpg")[i % 2]
        for d, a in ((gt_dir, img), (lq_dir, cv_resize(img, (w // 4, h // 4)))):
            with open(os.path.join(d, f"{i:04d}{ext}"), "wb") as f:
                f.write(smoke.encode_image(a, ext, quality=95))
    loader_opt = dict(phase="train", batch_size_per_gpu=4, num_worker_per_gpu=2,
                      io_backend={"type": "disk"}, seed=0)
    smoke.reset_launch_counts()
    runs = {}
    for name, opt in (("RealESRGANDataset", dict(smoke.REALESRGAN_X4PLUS, dataroot_gt=gt_dir)),
                      ("RealESRGANPairedDataset", dict(dataroot_gt=gt_dir, dataroot_lq=lq_dir,
                                                       gt_size=256, scale=4))):
        opt = dict(loader_opt, type=name, **opt)
        loader = build_dataloader(build_dataset(opt), opt, seed=0)
        t0 = time.perf_counter()
        pre = DevicePrefetcher(loader, "cuda")
        batches = []
        b = pre.next()
        while b is not None:
            batches.append(b)
            b = pre.next()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = sum(len(b["gt_path"]) for b in batches)
        shapes = {k: tuple(v.shape) for k, v in batches[0].items() if isinstance(v, torch.Tensor)}
        print(f"{name}: {len(batches)} batches, {n} items in {dt:.2f} s, {n / dt:.2f} items/s "
              f"through build_dataloader + DevicePrefetcher; {shapes} ({card})", flush=True)
        runs[name] = batches
    for b in runs["RealESRGANDataset"]:
        if tuple(b["gt"].shape) != (4, 400, 400, 3) or b["gt"].device.type != "cuda":
            raise AssertionError(f"RealESRGANDataset: gt {tuple(b['gt'].shape)}")
        for k in ("kernel1", "kernel2", "sinc_kernel"):
            sums = b[k].sum(dim=(1, 2))
            if tuple(b[k].shape) != (4, 21, 21) or (sums - 1).abs().max().item() > 1e-5:
                raise AssertionError(f"RealESRGANDataset: {k} {tuple(b[k].shape)} sums {sums}")
    for b in runs["RealESRGANPairedDataset"]:
        if (tuple(b["gt"].shape), tuple(b["lq"].shape)) != ((4, 256, 256, 3), (4, 64, 64, 3)):
            raise AssertionError(f"RealESRGANPairedDataset: {tuple(b['gt'].shape)}")
    gt = runs["RealESRGANDataset"][0]["gt"]
    _diff_jpeg_check(gt, card)
    _usm_check(gt, card)
    counts = smoke.launch_counts()
    if sum(counts.values()):
        raise AssertionError(f"the RealESRGAN data path launched a kernel of the port: {counts}")
    print("the RealESRGAN data path runs no kernel of the port (diff_jpeg and USM are plain "
          "tensor code)")
    return counts


# phase 14f: video data, flow warp, DCN, the legacy ops, the "xla" IE, WebP


def _video_files(root):
    """A REDS training clip (GT 1280x720, LQ 320x180, each key frame's
    quantized flows) and Vimeo90K septuplets (GT 448x256, LQ 112x64), seeded
    PNGs; returns the two datasets' options."""
    rng = np.random.default_rng(41)
    reds = {d: os.path.join(root, "reds", d) for d in ("gt", "lq", "flow")}
    for n in range(REDS_FRAMES):
        gt = smoke.smooth_image(rng, 720, 1280)
        imwrite(gt, os.path.join(reds["gt"], "001", f"{n:08d}.png"))
        imwrite(cv_resize(gt, (320, 180)), os.path.join(reds["lq"], "001", f"{n:08d}.png"))
        yy, xx = np.mgrid[0:180, 0:320] / 40.0
        for tag in ("p", "n"):
            for i in (1, 2):
                ph = rng.uniform(0, 6.3, 2)
                flow = np.stack([6 * np.sin(xx + ph[0]), 6 * np.cos(yy + ph[1])], -1)
                flowwrite(flow.astype(np.float32),
                          os.path.join(reds["flow"], "001", f"{n:08d}_{tag}{i}.png"),
                          quantize=True, max_val=20, norm=False)
    with open(os.path.join(root, "reds", "meta.txt"), "w") as f:
        f.write(f"001 {REDS_FRAMES} (720,1280,3)\n")
    vimeo = {d: os.path.join(root, "vimeo", d) for d in ("gt", "lq")}
    seqs = [f"00001/{i:04d}" for i in range(1, VIMEO_SEQS + 1)]
    for seq in seqs:
        for n in range(1, 8):
            gt = smoke.smooth_image(rng, 256, 448)
            imwrite(gt, os.path.join(vimeo["gt"], seq, f"im{n}.png"))
            imwrite(cv_resize(gt, (112, 64)), os.path.join(vimeo["lq"], seq, f"im{n}.png"))
    with open(os.path.join(root, "vimeo", "meta.txt"), "w") as f:
        f.writelines(f"{s} 7 (256,448,3)\n" for s in seqs)
    common = dict(phase="train", batch_size_per_gpu=4, num_worker_per_gpu=2,
                  io_backend={"type": "disk"}, seed=0, gt_size=256, scale=4, use_hflip=True,
                  use_rot=True)
    # EDVR's REDS options (train_EDVR_M_x4_SR_REDS.yml): 5 frames, interval 1, no reversal
    reds_opt = dict(common, type="REDSDataset", dataroot_gt=reds["gt"], dataroot_lq=reds["lq"],
                    dataroot_flow=reds["flow"], meta_info_file=os.path.join(root, "reds",
                                                                            "meta.txt"),
                    num_frame=5, interval_list=[1], random_reverse=False,
                    frames_per_clip=REDS_FRAMES)
    vimeo_opt = dict(common, type="Vimeo90KDataset", dataroot_gt=vimeo["gt"],
                     dataroot_lq=vimeo["lq"], meta_info_file=os.path.join(root, "vimeo",
                                                                          "meta.txt"),
                     num_frame=7, random_reverse=False)
    return reds_opt, vimeo_opt


def _card_vs_cpu_check(label, fn, args):
    """fn on the CPU tensors ``args`` and on their card copies; raises past
    VIDEO_TOL of max(1, |CPU|)."""
    want = fn(*args)
    got = fn(*(copy.deepcopy(a).to("cuda") if isinstance(a, torch.nn.Module)
               else a.to("cuda") if isinstance(a, torch.Tensor) else a for a in args)).cpu()
    err = (got - want).abs().max().item()
    tol = VIDEO_TOL * max(1.0, want.abs().max().item())
    print(f"{label}: card vs CPU max_abs_err {err:.3e} tol {tol:.3e} "
          f"{'ok' if err <= tol else 'FAIL'}", flush=True)
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{label}: the card disagrees with the CPU ({err} > {tol})")


def _card_ms(fn, args, reps=3):
    """Median card ms of ``reps`` calls after one warm-up, and the peak GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), torch.cuda.max_memory_allocated() / 2 ** 30


def _video_data(card, root):
    """Both datasets through build_dataloader (EnlargedSampler) and
    DevicePrefetcher, the clock started once the first batch is on the card;
    the first REDS batch."""
    first = None
    for opt in _video_files(root):
        dataset = build_dataset(opt)
        ratio = VIDEO_ENLARGE[opt["type"]]
        loader = build_dataloader(dataset, opt, sampler=EnlargedSampler(len(dataset), ratio=ratio),
                                  seed=0)
        pre = DevicePrefetcher(loader, "cuda")
        t_first = time.perf_counter()
        batches, b = [], pre.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while b is not None:
            batches.append(b)
            b = pre.next()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = sum(len(b["key"]) for b in batches[1:])
        shapes = {k: tuple(v.shape) for k, v in batches[0].items() if isinstance(v, torch.Tensor)}
        print(f"{opt['type']}: {len(dataset)} items x enlarge ratio {ratio}, {len(batches)} "
              f"batches; the {len(batches) - 1} after the first, {n} items, in {dt:.3f} s: "
              f"{n / dt:.2f} items/s through build_dataloader + DevicePrefetcher (2 threads; "
              f"first batch {t0 - t_first:.3f} s after the prefetcher's start); {shapes} "
              f"({card})", flush=True)
        frames = opt["num_frame"]
        want = {"lq": (4, frames, 64, 64, 3), "gt": (4, 256, 256, 3)}
        if opt["type"] == "REDSDataset":
            want["flow"] = (4, frames, 64, 64, 2)
            first = batches[0]
        if shapes != want or any(v.device.type != "cuda" for v in batches[0].values()
                                 if isinstance(v, torch.Tensor)):
            raise AssertionError(f"{opt['type']}: batch {shapes}, expected {want}")
    return first


def video_phase(card: str):
    """Phase 14f (see the module docstring). Returns the launches of the
    "xla" IE's run at 400x600 and of the train CLI on WebP pairs."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the video phase's comparisons run with TF32 off")
    batch = _video_data(card, os.path.join(VIDEO_DIR, "data"))
    # each neighbouring LQ frame warped by its flow (the centre's flow is zero)
    lq = batch["lq"].flatten(0, 1).permute(0, 3, 1, 2).contiguous().cpu()
    flows = batch["flow"].flatten(0, 1).contiguous().cpu()
    _card_vs_cpu_check(f"flow_warp of the REDS batch's LQ frames {tuple(lq.shape)}", flow_warp,
                       (lq, flows))

    gen = torch.Generator().manual_seed(42)
    dcn = init.initialize(DCNv2Pack(128, 128, 3, deform_groups=8), gen)
    with torch.no_grad():  # offsets of about a pixel, so the samples move
        dcn.conv_offset.weight.normal_(0.0, 0.03, generator=gen)
        dcn.conv_offset.bias.normal_(0.0, 0.5, generator=gen)
    feat, nbr = (torch.randn(5, 128, 180, 320, generator=gen) for _ in range(2))
    wflow = 4 * torch.randn(5, 180, 320, 2, generator=gen)
    x64 = torch.randn(5, 64, 180, 320, generator=gen)
    crop = (slice(None), slice(None), slice(40, 104), slice(100, 164))
    with torch.no_grad():
        _card_vs_cpu_check("DCNv2Pack 128 ch, 8 deform groups, 3x3, 64x64 crop",
                           lambda d, a, b: d(a, b),
                           (dcn, nbr[crop].contiguous(), feat[crop].contiguous()))
        _card_vs_cpu_check("flow_warp 64 ch, 64x64 crop", flow_warp,
                           (x64[crop].contiguous(), wflow[:, 40:104, 100:164].contiguous()))
        dcn.to("cuda")
        args = (nbr.to("cuda"), feat.to("cuda"))
        ms, peak = _card_ms(dcn, args)
        print(f"DCNv2Pack 128 ch, 8 deform groups, 3x3 on 5 x 180x320 (EDVR-L alignment): "
              f"{ms:.3f} ms, peak {peak:.2f} GiB ({card})", flush=True)
        del args
        ms, peak = _card_ms(flow_warp, (x64.to("cuda"), wflow.to("cuda")))
        print(f"flow_warp 64 ch on 5 x 180x320 (BasicVSR): {ms:.3f} ms, peak {peak:.2f} GiB "
              f"({card})", flush=True)
        x = torch.randn(4, 512, 64, 64, generator=gen)
        bias = torch.randn(512, generator=gen)
        k = legacy.make_resample_kernel([1, 3, 3, 1])
        up = lambda t, kk: legacy.upfirdn2d(t, kk, up=2, pad=(2, 1))  # noqa: E731
        _card_vs_cpu_check("upfirdn2d [1,3,3,1] up 2 pad (2,1) on (4, 512, 64, 64)", up, (x, k))
        _card_vs_cpu_check("fused_leaky_relu on (4, 512, 64, 64)", legacy.fused_leaky_relu,
                           (x, bias))
        for label, fn, a in (("upfirdn2d", up, (x.to("cuda"), k.to("cuda"))),
                             ("fused_leaky_relu", legacy.fused_leaky_relu,
                              (x.to("cuda"), bias.to("cuda")))):
            ms, peak = _card_ms(fn, a)
            print(f"{label} on (4, 512, 64, 64): {ms:.3f} ms, peak {peak:.2f} GiB ({card})",
                  flush=True)
    del dcn, feat, nbr, x64
    torch.cuda.empty_cache()
    counts = _xla_route(card)
    cli = _webp(card, os.path.join(VIDEO_DIR, "webp"))
    return {k: v + cli[k] for k, v in counts.items()}


def _xla_route(card):
    """The LOLv1 IE with scan_backend "xla": card vs CPU at 64x96, then
    400x600 (448x640) B=2 on the card: row 8 launches unclamped (its carry
    on row 7), no fused serving row launches; count_flops of the default IE
    on both devices."""
    opt = parse(os.path.join(REPO, "Options", EVAL_OPTIONS[1]), is_train=False)["network_g"]
    gen = torch.Generator().manual_seed(7)
    x = torch.rand(1, 64, 96, 6, generator=gen)
    with torch.no_grad():
        net = build_network(dict(opt, scan_backend="xla"), torch.Generator().manual_seed(3))
        _card_vs_cpu_check('IE scan_backend "xla" at 64x96', lambda n, t: n(t)[-1], (net, x))
        net.to("cuda")
        default = build_network(opt, torch.Generator().manual_seed(3))
        flops_cpu = analysis.count_flops(default, x)["flops"]
        flops_card = analysis.count_flops(default.to("cuda"), x.to("cuda"))["flops"]
        print(f"count_flops of the default IE at 64x96: card {flops_card:.6e}, CPU "
              f"{flops_cpu:.6e}", flush=True)
        if flops_card != flops_cpu:
            raise AssertionError("count_flops of the default IE depends on the device")
        del default
        hp, wp = padded_size(H, W)
        xs = torch.rand(NIMG, hp, wp, 6, generator=gen).to("cuda")
        smoke.reset_launch_counts()
        ms, peak = _card_ms(lambda t: net(t)[-1], (xs,))
        counts = smoke.launch_counts()
    launched = {k: v for k, v in counts.items() if v}
    print(f'IE scan_backend "xla" {H}x{W} (padded {hp}x{wp}) B={NIMG} fp32, TF32 off: {ms:.3f} '
          f"ms/request, peak {peak:.2f} GiB; launches {launched} ({card})", flush=True)
    if counts["ss2d_dir_fused"] <= 0 or set(launched) - set(XLA_ROUTE_KERNELS):
        raise AssertionError(f'the "xla" IE: row 8 must launch unclamped (its carry on row 7) '
                             f"and no fused serving row: {launched}")
    del net, xs
    torch.cuda.empty_cache()
    return counts


def _webp(card, root):
    """The committed WebP fixtures against their PNGs (host decode ms), then
    the train CLI on WebP pairs; returns the CLI's launches."""
    for stem in WEBP_FIXTURES:
        with open(os.path.join(JPEG_FIXTURES, stem + ".webp"), "rb") as f:
            data = f.read()
        truth = imread(os.path.join(JPEG_FIXTURES, stem + ".png"), float32=False,
                       flag="unchanged")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = imdecode(data, stem + ".webp", "unchanged")
            times.append(time.perf_counter() - t0)
        same = got.shape == truth.shape and np.array_equal(got, truth)
        print(f"decode {stem}.webp ({len(data)} bytes, {got.shape}): "
              f"{1e3 * statistics.median(times):.1f} ms (median of 3, host), equal to cv2's "
              f"decode {same} ({card})", flush=True)
        if not same:
            raise AssertionError(f"{stem}.webp: the decoder disagrees with cv2's decode")
    lines = _Lines()
    logging.getLogger("bem_tpu_torch").addHandler(lines)
    try:
        for sub in ("input", "target", "val_input", "val_target"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        # the committed 112x144 crops (padded to the options' 128x128
        # training crops): the decoders are host Python, and the test data
        # stays under 1 MiB (tests/test_torch_jpeg.py)
        with open(os.path.join(JPEG_FIXTURES, "i_alpha.webp"), "rb") as f:
            lossy_alpha = f.read()  # VP8X: lossy VP8 with an ALPH plane
        with open(os.path.join(JPEG_FIXTURES, "h_lossless.webp"), "rb") as f:
            lossless = f.read()  # VP8L
        for i in range(10):
            sub = "" if i < 8 else "val_"
            for d, data in (("input", lossy_alpha), ("target", lossless)):
                with open(os.path.join(root, sub + d, f"{i:03d}.webp"), "wb") as f:
                    f.write(data)
        args = ["--device", "cuda", "--force_yml",
                f"datasets:train:dataroot_lq={os.path.join(root, 'input')}",
                f"datasets:train:dataroot_gt={os.path.join(root, 'target')}",
                f"datasets:val:dataroot_lq={os.path.join(root, 'val_input')}",
                f"datasets:val:dataroot_gt={os.path.join(root, 'val_target')}",
                "name=smoke_webp", "logger:print_freq=1", "logger:save_checkpoint_freq=4",
                "val:val_freq=4", "logger:use_tb_logger=false", "logger:wandb:project=~",
                "datasets:train:num_worker_per_gpu=2", "train:total_iter=4", *SSIM]
        smoke.reset_launch_counts()
        model, log, _ = _cli_run(EVAL_OPTIONS[1], args, root, lines)
    finally:
        logging.getLogger("bem_tpu_torch").removeHandler(lines)
    losses = [float(m) for line in log for m in re.findall(r"l_total: (\S+)", line)]
    if not (len(losses) == 4 and np.isfinite(losses).all() and model.step == 4):
        raise AssertionError(f"train CLI on WebP: losses {losses}, step {model.step}")
    _check_validation("train CLI on WebP", model.metric_results)
    rest = model.timings[1:]
    print(f"ImageEnhancer train CLI 4 iters B=8 fp32 on 8 WebP pairs (i_alpha.webp inputs, "
          f"lossy VP8 + ALPH read in colour; h_lossless.webp targets, VP8L) 112x144, 2 loader threads: losses "
          f"{[f'{x:.5f}' for x in losses]};"
          f" iters 2-4 mean {1e3 * statistics.mean(t[3] for t in rest):.1f} ms/step, data_time "
          f"{1e3 * statistics.mean(t[2] for t in rest):.1f} ms; validation PSNR "
          f"{model.metric_results['psnr']:.4f}; launches {smoke.launch_counts()} ({card})",
          flush=True)
    return smoke.launch_counts()


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


# phase 15: two ranks on the one card (gloo: NCCL takes one rank a card)
PAR_RANKS = 2
PAR_DIR = os.path.join(REPO, "results", "chip_smoke_parallel")  # gitignored, removed at the end
PAR_SCAN = (8, 16384, 40)  # row 7's table shape, the sequence split over the ranks
PAR_IE = (NIMG, 448, 640)  # the "xla" IE's batch and padded 400x600
PAR_TOL = 2e-4             # of max(1, |unsharded|), fp32, TF32 off
PAR_TRAIN_TOL = 1e-4       # 2 ranks vs 1 after a step, of 1 + |param|, where |g| is clear
PAR_SPEED_REPEAT = 1       # timed two-stage forwards a speed-test run
PAR_TRAIN_STEPS = 1        # timed train steps after the compared one
PAR_CLI_IMAGES = 16        # two steps of 2 x 4 an epoch
CLI_TRAINERS_TYPES = ("ImageEnhancer", "ConditionGenerator")


def _par_scan_inputs():
    """Row 7's (a, b) at PAR_SCAN from a seeded generator on the card (the
    same bits in every process): decays in (0.999, 1], so that the carry
    over a rank's 8192 positions matters."""
    g = torch.Generator(device="cuda").manual_seed(31)
    return (1 - 1e-3 * torch.rand(PAR_SCAN, generator=g, device="cuda"),
            torch.randn(PAR_SCAN, generator=g, device="cuda"))


def _par_ie():
    """The LOLv1 IE on the "xla" route (seeded) and its seeded input on the card."""
    opt = parse(os.path.join(REPO, "Options", EVAL_OPTIONS[1]), is_train=False)["network_g"]
    net = build_network(dict(opt, scan_backend="xla"), torch.Generator().manual_seed(3))
    g = torch.Generator(device="cuda").manual_seed(33)
    return net.to("cuda").eval(), torch.rand(*PAR_IE, 6, generator=g, device="cuda")


def _par_train_inputs(mt):
    """A global batch of 8 at the LOLv1 shapes, the seeded net and (the CG)
    its injected weight noise, as train_reference_check makes them."""
    opt = _train_opt(mt)
    batch = {k: v.numpy() for k, v in synthetic_batch(
        opt, torch.Generator().manual_seed(35), batch_size=8).items()}
    net_opt = dict(opt["network_g"])
    eps = None
    if mt == "ConditionGenerator":
        net_opt.update(bayesian=True, sigma_init=opt["sigma_init"])
    net = build_network(net_opt, torch.Generator().manual_seed(5))
    if mt == "ConditionGenerator":
        erng = np.random.default_rng(9)
        eps = {k: erng.standard_normal(tuple(p.shape)).astype(np.float32)
               for k, p in net.named_parameters() if k.rpartition(".")[2].startswith("mu_")}
    return opt, net, batch, eps


def _par_steps(model, batch, eps, sync):
    """The compared step, then PAR_TRAIN_STEPS timed ones: (the first
    step's logs, its gradients, the params after it, median ms/step)."""
    grads = _grad_capture(model)
    kw = {} if eps is None else {"eps": {k: torch.from_numpy(v) for k, v in eps.items()}}
    logs = model.train_step(batch, **kw)
    params = {k: p.detach().cpu().clone() for k, p in model.params.items()}
    grads = {k: g.cpu() for k, g in grads.items()}
    times = []
    for _ in range(PAR_TRAIN_STEPS):
        sync()
        t0 = time.perf_counter()
        model.train_step(batch, **kw)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return {k: float(v) for k, v in logs.items()}, grads, params, statistics.median(times)


def _par_rank(mesh, job):
    """Phase 15 on one rank: (a) the context-parallel scan, (b) the row-sharded
    "xla" IE and the speed test under --spatial_shard, (c) one IE and one CG
    train step on this rank's slice, (d) the eval CLI with --shard_samples
    on, then the train CLI under --launcher pytorch (torchrun's
    environment). Each part's launch counts, its outputs and its times."""
    from bem_tpu_torch.ops.scan import linear_scan_plain
    from bem_tpu_torch.parallel import context_parallel_linear_scan, shard_batch, spatial_apply
    from bem_tpu_torch.parallel import spatial

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r, n = mesh.rank, mesh.size
    out = {"backend": mesh.backend, "device": str(mesh.device), "counts": {}}

    def sync():
        torch.cuda.synchronize()
        mesh.barrier()

    def part(name):
        out["counts"][name] = smoke.launch_counts()
        smoke.reset_launch_counts()

    def ms(fn, reps=3):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return 1e3 * (time.perf_counter() - t0) / reps

    # (a) the context-parallel scan
    a, b = _par_scan_inputs()
    L = a.shape[1] // n
    ac, bc = a[:, r * L:(r + 1) * L].contiguous(), b[:, r * L:(r + 1) * L].contiguous()
    want = linear_scan_plain(a, b)[:, r * L:(r + 1) * L]
    smoke.reset_launch_counts()
    got = context_parallel_linear_scan(ac, bc, mesh)
    out["scan_err"] = ((got - want).abs().max() / max(1.0, want.abs().max().item())).item()
    out["scan_ms"] = ms(lambda: context_parallel_linear_scan(ac, bc, mesh))
    part("scan")
    del a, b, ac, bc, want, got

    # (b) the row-sharded "xla" IE, then the speed test under --spatial_shard
    net, xs = _par_ie()
    h = xs.shape[1] // n
    band = xs[:, r * h:(r + 1) * h].contiguous()
    shapes, core = [], spatial.ss2d_dir_fused

    def recording(x2, *args, **kw):
        shapes.append(tuple(x2.shape))
        return core(x2, *args, **kw)

    spatial.ss2d_dir_fused = recording
    try:
        y = spatial_apply(net, band, mesh)
    finally:
        spatial.ss2d_dir_fused = core
    ref = torch.from_numpy(job["ie_want"][:, r * h:(r + 1) * h]).to("cuda")
    out["ie_err"] = ((y - ref).abs().max() / max(1.0, ref.abs().max().item())).item()
    out["ie_core_shapes"] = shapes
    out["ie_ms"] = ms(lambda: spatial_apply(net, band, mesh), reps=1)
    part("ie")
    del net, xs, band, y, ref
    torch.cuda.empty_cache()
    out["speed"] = {}
    for dtype in ("bfloat16", "float32"):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            speed_test.main(job["speed_args"] + ["--dtype", dtype])
        out["speed"][dtype] = log.getvalue().strip()
        torch.cuda.empty_cache()
    part("speed")

    # (c) one IE and one CG step on this rank's slice of the global batch
    out["train"] = {}
    for mt in CLI_TRAINERS_TYPES:
        opt, net, batch, eps = _par_train_inputs(mt)
        opt = dict(opt, dist=True, rank=r, world_size=n)
        model = build_model(opt, device="cuda", net=net)
        logs, grads, params, step_ms = _par_steps(model, shard_batch(mesh, batch), eps, sync)
        out["train"][mt] = dict(logs=logs, params=params, ms=step_ms)
        del model
        torch.cuda.empty_cache()
    part("train")

    # (d) the eval CLI with the K samples over the ranks
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out["eval"] = eval_main(job["eval_args"])
    out["eval_log"] = log.getvalue()
    torch.cuda.empty_cache()
    part("eval")

    # the train CLI as torchrun starts it: the launcher's environment, the
    # group started anew by --launcher pytorch
    torch.distributed.destroy_process_group()
    os.environ.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                      MASTER_PORT=str(job["port"]))
    model = train_pipeline(PAR_DIR, job["cli_args"])
    out["cli"] = dict(step=model.step, rank=model.opt["rank"], world=model.opt["world_size"],
                      device=model.opt["device"])
    part("cli")
    return out


def _par_references():
    """What phase 15 compares with, on one process: the whole sequence's
    row-7 scan, the unsharded "xla" IE, the 1-process train steps and the
    unsharded eval. Their launches do not count."""
    ref = {}
    a, b = _par_scan_inputs()
    ref["scan_ms"] = smoke.time_ms(smoke.KERNELS["linear_scan"][0], (a, b))
    del a, b
    net, xs = _par_ie()
    with torch.no_grad():
        ref["ie_want"] = net(xs)[-1].cpu().numpy()
        ref["ie_ms"], _ = _card_ms(lambda t: net(t)[-1], (xs,), reps=1)
    del net, xs
    ref["train"] = {}
    for mt in CLI_TRAINERS_TYPES:
        opt, net, batch, eps = _par_train_inputs(mt)
        p0 = {k: p.detach().clone() for k, p in net.named_parameters()}
        model = build_model(opt, device="cuda", net=net)
        logs, grads, params, step_ms = _par_steps(model, batch, eps, torch.cuda.synchronize)
        ref["train"][mt] = dict(logs=logs, grads=grads, params=params, ms=step_ms, p0=p0,
                                lr=opt["train"]["optim_g"]["lr"])
        del model
    torch.cuda.empty_cache()
    return ref


def parallel_phase(card: str):
    """Phase 15: 2 ranks on the one card (``parallel.spawn``, the spawn start
    method, the kernels built by this process first; gloo, since both ranks
    share the card) against one process. Rows 7 and 8 must launch on each
    rank; returns the launches summed over the ranks."""
    from bem_tpu_torch import parallel
    from bem_tpu_torch.parallel.mesh import pick_backend

    t0 = time.perf_counter()
    devices = ["cuda:0"] * PAR_RANKS
    print(f"phase 15: {PAR_RANKS} ranks on {devices}, backend {pick_backend(devices)} "
          f"(NCCL takes one rank a card) ({card})", flush=True)
    smoke.write_eval_images(os.path.join(PAR_DIR, "eval"), 3, H, W, seed=41)
    smoke.write_eval_images(os.path.join(PAR_DIR, "train"), PAR_CLI_IMAGES, H, W, seed=42)
    smoke.write_eval_images(os.path.join(PAR_DIR, "val"), 2, H, W, seed=43)
    opts = [os.path.join(REPO, "Options", name) for name in EVAL_OPTIONS]
    eval_root = os.path.join(PAR_DIR, "eval")
    sharded_args = _eval_args(opts, eval_root, "sharded", "niqe", "cuda", K, 8,
                              ["--shard_samples", "on"])
    ref = _par_references()
    t_ref = time.perf_counter()
    ref_eval = eval_main(_eval_args(opts, eval_root, "one", "niqe", "cuda", K, 8,
                                    ["--shard_samples", "off"]))
    t_ref = time.perf_counter() - t_ref
    torch.cuda.empty_cache()
    data = lambda sub, phase: [  # noqa: E731
        f"datasets:{phase}:dataroot_gt={os.path.join(PAR_DIR, sub, 'target')}",
        f"datasets:{phase}:dataroot_lq={os.path.join(PAR_DIR, sub, 'input')}"]
    cli_args = ["--opt", opts[1], "--device", "cuda", "--launcher", "pytorch", "--force_yml",
                *data("train", "train"), *data("val", "val"), "name=smoke_par",
                "train:total_iter=4", "logger:print_freq=1", "logger:save_checkpoint_freq=2",
                "val:val_freq=100", "logger:use_tb_logger=false", "logger:wandb:project=~",
                "datasets:train:batch_size_per_gpu=4", "datasets:train:num_worker_per_gpu=2"]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    job = dict(ie_want=ref["ie_want"], eval_args=sharded_args, cli_args=cli_args, port=port,
               speed_args=["--opt", opts[0], "--cond_opt", opts[1], "--input_size",
                           str(SPEED_SIZE), "--device", "cuda", "--repeat",
                           str(PAR_SPEED_REPEAT), "--spatial_shard", str(PAR_RANKS)])
    t_ranks = time.perf_counter()
    res = parallel.spawn(_par_rank, PAR_RANKS, args=(job,), devices=devices, threads=4,
                         timeout=600)
    t_ranks = time.perf_counter() - t_ranks
    note = "two ranks time-share one card's SMs: not a scaling result"
    fails = []

    # (a)
    a_err = max(o["scan_err"] for o in res)
    rows7 = [o["counts"]["scan"]["linear_scan"] for o in res]
    print(f"(a) context_parallel_linear_scan {PAR_SCAN} fp32 over {PAR_RANKS} ranks vs "
          f"linear_scan_plain of the whole sequence: max err / max(1, |plain|) {a_err:.3e} "
          f"(tol {PAR_TOL}); row-7 launches by rank {rows7}; {res[0]['scan_ms']:.4f} ms on "
          f"{PAR_RANKS} ranks vs linear_scan of the whole sequence on one process "
          f"{ref['scan_ms']:.4f} ms ({note}; {card})", flush=True)
    if not (a_err <= PAR_TOL and min(rows7) > 0):
        fails.append("(a) the context scan")

    # (b)
    b_err = max(o["ie_err"] for o in res)
    hp, wp = PAR_IE[1:]
    want_l = sorted([hp * wp // 2 ** (2 * i) // PAR_RANKS for i in (0, 1, 2)])
    seen_l = [sorted(set(s[-1] for s in o["ie_core_shapes"])) for o in res]
    rows8 = [o["counts"]["ie"]["ss2d_dir_fused"] for o in res]
    print(f'(b) spatial_apply of the "xla" IE {hp}x{wp} B={PAR_IE[0]} fp32 over {PAR_RANKS} '
          f"ranks vs the unsharded one: max err / max(1, |ref|) {b_err:.3e} (tol {PAR_TOL}); "
          f"row-8 launches by rank {rows8} at L {seen_l} (H*W/{PAR_RANKS} a level: {want_l}); "
          f"{res[0]['ie_ms']:.1f} ms on {PAR_RANKS} ranks vs {ref['ie_ms']:.1f} ms on one "
          f"process ({note}; {card})", flush=True)
    if not (b_err <= PAR_TOL and min(rows8) > 0 and all(x == want_l for x in seen_l)):
        fails.append("(b) the row-sharded IE")
    for dtype, text in res[0]["speed"].items():
        print(f"(b) speed test {SPEED_SIZE}x{SPEED_SIZE} {dtype} --spatial_shard {PAR_RANKS} "
              f"--repeat {PAR_SPEED_REPEAT}: {'; '.join(text.splitlines())} ({note}; {card})",
              flush=True)
        if not re.search(r"running time: \d+\.\d{4} sec", text) or res[1]["speed"][dtype]:
            fails.append(f"(b) the speed test {dtype}")
    rows8s = [o["counts"]["speed"]["ss2d_dir_fused"] for o in res]
    print(f"(b) speed test row-8 launches by rank {rows8s}", flush=True)
    if min(rows8s) <= 0:
        fails.append("(b) the speed test's row 8")

    # (c)
    for mt in CLI_TRAINERS_TYPES:
        rt = ref["train"][mt]
        lr = rt["lr"]
        err = far = 0.0
        for o in res:
            got = o["train"][mt]["params"]
            for k, want in rt["params"].items():
                moved = (torch.from_numpy(got[k]) - want).abs()
                g = rt["grads"][k].abs()
                clear = g > 1e-2 * g.max()
                if clear.any():
                    err = max(err, (moved[clear] / (1 + want[clear].abs())).max().item())
                far = max(far, (moved - 2 * lr * (1 + 1e-4 * rt["p0"][k].abs())).max().item())
        loss = [o["train"][mt]["logs"]["l_total"] for o in res]
        print(f"(c) {mt} step, global B=8, {PAR_RANKS} ranks vs 1 (fp32, TF32 off): loss "
              f"{loss} vs {rt['logs']['l_total']:.7f}; params max rel err {err:.3e} where "
              f"|g| > 1e-2 max|g| of the leaf (tol {PAR_TRAIN_TOL}), beyond one step (2 lr) "
              f"{max(far, 0.0):.3e} (tol 1e-6); {res[0]['train'][mt]['ms']:.1f} ms/step on "
              f"{PAR_RANKS} ranks vs {rt['ms']:.1f} on one process ({note}; {card})", flush=True)
        if not (err <= PAR_TRAIN_TOL and far <= 1e-6
                and all(abs(x - rt["logs"]["l_total"]) <= 1e-4 * abs(rt["logs"]["l_total"])
                        for x in loss)):
            fails.append(f"(c) the {mt} step")
    exp = os.path.join(PAR_DIR, "experiments", "smoke_par")
    logs = [f for f in os.listdir(exp) if f.startswith("train_")]
    text = open(os.path.join(exp, logs[0])).read() if len(logs) == 1 else ""
    losses = [float(x) for x in re.findall(r"l_total: (\S+)", text)]
    files = sorted(os.listdir(os.path.join(exp, "models")))
    print(f"(c) train CLI --launcher pytorch, {PAR_RANKS} ranks, 4 iters, global B=8: ranks "
          f"{[(o['cli']['rank'], o['cli']['world'], o['cli']['step']) for o in res]}; one log "
          f"{logs}, losses {losses}; models {files}", flush=True)
    if not (len(logs) == 1 and len(losses) == 4 and np.isfinite(losses).all()
            and files == [f"net_g_{i}.msgpack" for i in (2, 4, 5)]
            and [o["cli"]["step"] for o in res] == [4] * PAR_RANKS
            and "World size: 2" in text):
        fails.append("(c) the train CLI")

    # (d)
    got_eval = res[0]["eval"]
    lsb = 0
    for i in range(3):
        a = imread(os.path.join(eval_root, "sharded", "dataset", f"{i}.png"), False).astype(int)
        b = imread(os.path.join(eval_root, "one", "dataset", f"{i}.png"), False).astype(int)
        lsb = max(lsb, int(np.abs(a - b).max()))
    print(f"(d) eval CLI niqe K={K} {H}x{W} LOLv1, --shard_samples on over {PAR_RANKS} ranks vs "
          f"one process: picks {got_eval['selected']} vs {ref_eval['selected']}, PNGs within "
          f"{lsb} LSB (tol 1); steady-state {got_eval['steady_s_per_img']:.4f} vs "
          f"{ref_eval['steady_s_per_img']:.4f} s/img ({note}; {card})", flush=True)
    if not (got_eval["selected"] == ref_eval["selected"] and lsb <= 1
            and res[1]["eval"] is None):
        fails.append("(d) the sharded eval")

    counts = {k: sum(o["counts"][p][k] for o in res for p in o["counts"])
              for k in smoke.KERNELS}
    print(f"phase 15 backend {sorted({o['backend'] for o in res})} on "
          f"{sorted({o['device'] for o in res})}; references {t_ref:.1f} s (eval) and ranks "
          f"{t_ranks:.1f} s of {time.perf_counter() - t0:.1f} s; launches over the ranks' runs "
          f"{counts}", flush=True)
    if fails:
        raise AssertionError(f"phase 15: {fails}")
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
    phase("serving artifact (torch.export)")
    try:
        export_counts = export_phase(card)
    finally:
        shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    phase("native host library")
    native_check(card)
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
    phase("classifier CLI at full width")
    try:
        cls_cli_counts = cls_cli_phase(card)
    finally:
        shutil.rmtree(CLS_CLI_DIR, ignore_errors=True)
    phase("RealESRGAN data at full width")
    try:
        realesrgan_phase(card)
    finally:
        shutil.rmtree(REALESRGAN_DIR, ignore_errors=True)
    phase("model zoo at full width")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the zoo's comparisons run with TF32 off")
    zoo_counts = zoo_phase(card)
    phase("video data, flow warp, DCN and WebP")
    try:
        video_counts = video_phase(card)
    finally:
        shutil.rmtree(VIDEO_DIR, ignore_errors=True)
    phase("multi-GPU on the one card (2 ranks)")
    torch.cuda.empty_cache()
    try:
        par_counts = parallel_phase(card)
    finally:
        shutil.rmtree(PAR_DIR, ignore_errors=True)
    phase("microbenchmarks")
    mb_counts = microbench_phase()
    # each kernel's launches over the runs of its own paths: the BEM kernels
    # over the training, train / test CLI, serving, serving artifact, eval, flagship, flagship
    # training, VMUNet family, image formats, speed test and option-set runs, the fused core and its backward over VMamba-T's, the
    # clamped form over the narrow reference runs, selective_scan_fused over
    # VMamba-T v052d's, the SS2D modes' over their checks and VMamba-T
    # v052dc_noz's, the classifier CLI's over its three runs, rows 7 and 8
    # also over the model zoo's full-width runs, rows 7 and 8 also over the
    # "xla" IE's run of phase 14f and rows 1-7 over its train CLI on WebP
    # pairs, the microbenchmarks over their sweeps
    paths = {name: (train_counts, cli_counts, serve_counts, export_counts, eval_counts,
                    flagship_counts, flagship_train_counts, vmunet_counts, formats_counts,
                    speed_counts, options_counts, video_counts, par_counts)
             for name in smoke.BEM_KERNELS}
    paths["linear_scan"] += (modes_counts, cascade_counts, cls_cli_counts, zoo_counts)
    paths.update(ss2d_dir_fused=(cls_train_counts, cls_tp_counts, modes_counts, cls_cli_counts,
                                 zoo_counts, video_counts, par_counts),
                 ss2d_dir_fused_bwd=(cls_train_counts, cls_tp_counts, modes_counts,
                                     cls_cli_counts),
                 ss2d_dir_fused_g=(cls_ref_counts, modes_counts, cls_cli_counts),
                 selective_scan_fused=(scan_train_counts, scan_tp_counts),
                 vpu_scan_step=(mb_counts,), vpu_op_rounds=(mb_counts,))
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=sum(c[name] for c in paths[name]), **summary[name])
               for name, (_, _, src, rep) in smoke.KERNELS.items()]
    since_start = process_seconds()
    print(f"chip_smoke: {time.perf_counter() - t_start:.0f} s"
          + (f" ({since_start:.0f} s since the process started, imports included)"
             if since_start is not None else ""))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
