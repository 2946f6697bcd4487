#!/usr/bin/env python3
"""Drive the PyTorch port's CIFAR-10 (NCSN++ and DDPM), ImageNet-256 and
CelebA-HQ defences once on one NVIDIA GPU.

    python3 chip_smoke.py          (from the root of the repository)

Phases, each fatal on failure:
  1. versions, the card's name and power limit, and the build of the CUDA
     kernels from diffpure_tpu_torch/csrc (timed); the count of wgmma
     (HGMMA) instructions in the SASS of the halo conv, flash attention,
     the CIFAR block GEMM and the attention block's core, which must be
     non-zero for their bf16 kernels; the fp32 kernels of #1 / #2's and
     #4 / #5's chains, #3's chain and #10 (FP32_KERNELS) must hold no
     tensor-core instruction (HMMA, HGMMA: TF32 stays off) and spill nothing
     (-Xptxas -v);
  2. each hand-written kernel against its plain PyTorch version on the card,
     at every shape the CIFAR-10 NCSN++ gives it, batch 8, bf16 and fp32,
     and the bf16 blocks again at batch 128 (the attention block also at
     16), with seeded random-normal weights; per shape the wrappers'
     CUDA-event time, the kernels' device time (profiler), the plain time,
     and for the bf16 blocks TFLOP/s, the share of the bound and cuDNN's
     convs as a yardstick; for the attention block the device time by
     chain step (GN, qkv GEMM, core with the output NIN), the bound, a
     PyTorch yardstick (attn_yardstick) and in fp32 the core alone as
     F.scaled_dot_product_attention under each backend
     (sdpa_core_yardstick); an attention block that launches an old GEMM,
     GN or core kernel (OLD_ATTN_KERNELS) or a second, out GEMM fails; and
     the attention block with an Inf in one example, whose neighbours must
     agree with the plain version (phase_attn_isolation); #1 / #2 in fp32
     (every run script's precision) also at batch 64, the run scripts'
     batch (phase_f32_blocks), each fp32 call run twice for the same bits,
     with cuDNN's two fp32 convs (TF32 off) as a yardstick; an fp32 #1 / #2
     call that launches a kernel of the old chain (OLD_F32_FWD_KERNELS)
     fails; the fp32 GEMM alone against cuDNN's conv, beside its other
     thread tile and its ablated copies, and the SM clock while it runs
     (phase_f32_ablation);
  3. the slice: DefendedModel (full-width configs/cifar10.yml NCSN++ with a
     bf16 torso + WRN-28-10, seeded random weights) on 8 seeded images at
     t*=100 through get_accuracy under inference_mode; the kernel launch
     counters must read exactly 40, 36 and 10 per score evaluation;
  3b. the same at batch 128 (the CIFAR batch of the JAX bench), cold and
     warm, with the same counters per evaluation;
  3c. the defended call in fp32 at batch 64 (the run scripts' precision
     and batch), cold and warm, the same counters, and the device ms and
     idle share of three fp32 evaluations at that batch;
  4. the same purification at t*=5 once through the kernels (on the card)
     and once through the plain versions (on the CPU, where the wrappers
     take them), with the same noise; the purified images must agree;
  2b. (run after phase 2) each backward kernel against its plain version
     (autograd of the plain block on the card) at every resblock and
     concat-resblock shape of the main path, batch 8, bf16 and fp32, batch
     16 (phase 5's), bf16 and fp32, and batch 64 (the run scripts'), fp32;
     per shape the wrapper's CUDA-event time, the profiler's device time by
     chain step (GN1 and conv0 recompute, conv1^T, GN2 backward, conv0^T,
     skip adjoint, GN1 backward; fp32 at 16 and 64 from one profiler
     session), TFLOP/s and cuDNN's four products as a yardstick (fp32 with
     TF32 off); each fp32 call runs twice and must give the same bits; a
     bf16 backward that launches the old GEMM or GN backward kernel
     (OLD_BWD_KERNELS), or an fp32 one that launches the old fp32 chain
     (OLD_F32_BWD_KERNELS), fails;
  5. the gradient-image rate: the input gradient of the cross-entropy of
     DefendedModel at t*=100, batch 16, bf16 torso, weights frozen, with
     grad_mode 'checkpoint' and 'adjoint', cold and warm; the launch
     counters must read exactly what each mode derives; then 'checkpoint'
     with the fp32 torso, cold and warm;
  6. the input gradient of the t*=5 purification (against a seeded
     cotangent) at batch 2, kernels (card) in fp32 and bf16 against the
     plain fp32 path (CPU), same noise, both grad modes;
  7. the entry point: eval_autoattack (AutoAttack 'rand', APGD-CE and
     APGD-DLR with EOT) through the full-width bf16 defence at t*=AA_T,
     batch 8; x_adv must lie in the eps-ball and in [0, 1], and every
     kernel of the path must have launched.
  2c. (run after phase 2b) the ImageNet-256 kernels (tiled GroupNorm stats
     and apply, halo conv, flash attention) against their plain versions at
     every shape the full-width imagenet256_config ADM gives them at batch
     4 (a census of the wrappers' calls over one evaluation), bf16 and
     fp32; kernel, plain and bound times, TFLOP/s and share of the bound;
     beside the flash kernel, F.scaled_dot_product_attention on 4-D views
     under each backend that takes the inputs, the fastest that agrees with
     the plain version as its library time (a yardstick on no path); and
     flash attention at head widths 32, 128 and 256, and 48, 96, 160 and
     36, which the kernel is not built for (T = 1024), off the census;
  8. the ImageNet slice: DefendedModel(resize_to=256) with the
     guided-diffusion purify_sde at t*=150 through that ADM (bf16 torso,
     552,814,086 parameters) and ResNet-50, on 4 seeded 224x224 images under
     inference_mode, cold then warm; the launch counters must read 150 x the
     census for the four 256-px kernels and 0 for the CIFAR ones;
  9. one full-width ADM evaluation at batch 1, fp32 and bf16, and a t*=3
     fp32 purification, kernels (card) against the plain fp32 path (CPU),
     same noise;
  2d. (run after phase 2c) GroupNorm+SiLU (#10) against its plain version
     at every shape the full-width score_sde DDPM gives it at batch 8 (a
     census of its GNSiLU calls over one evaluation) and at a shape off the
     census that takes its L2 route (GN_OFF_CENSUS), bf16 and fp32; kernel
     (CUDA events), device (profiler), plain and bound times, per shape and
     per evaluation, and F.silu(F.group_norm(.)) as #10's yardstick; a #10
     call that launches the old kernel (OLD_GN_KERNELS) fails; then fused
     bias + leaky ReLU (#11, on no path) at the DDPM's feature-map shapes,
     an odd one and two past L2 (FLR_CASES, FLR_LARGE), with and without a
     bias, bf16 and fp32: device time back to back and, past L2, in steady
     state over rotating copies (steady_device_ms), the yardstick
     F.leaky_relu(x + b) * scale, the 1-element launch floor, and its
     gradient on the card, the kernel route against the plain one;
  10. the DDPM slice: DefendedModel (full-width DDPM, fp32, 35,218,947
     parameters + WRN-28-10) on 8 seeded images at t*=100 through
     get_accuracy under inference_mode, cold then warm; the launch
     counters must read 100 x the census for #10 and the attention block,
     0 for every other kernel;
  11. the t*=5 DDPM purification, and one evaluation of NCSN++ with
     resblock_type='ddpm' (2 blocks per level, fp32 and bf16), kernels
     (card) against plain (CPU), same noise;
  12. BPDA+EOT on the main path: the defence vote (timed), eval_bpda
     through the bf16 CIFAR defence at t*=BPDA_T (50), batch 4, 2 PGD steps, 2
     attack and 4 defence reps, then one PGD step with the attack reps one
     a call (the chunked seeds); x_adv must lie in the eps-ball and in
     [0, 1], class_batch never turn from false to true, and the launch
     counters read 40 / 36 / 10 x the NFE ledger's total, the backward
     kernels 0; then the flip verification, with the attack reps answered
     by a probe image the classifier puts off the labels, so that the
     fold_in(k_step, 555) vote verifies candidates through the kernels
     (phase_bpda);
  13. DPM-Solver++(2M): DefendedModel with purify_dpm at t*=100 in 20
     steps, bf16, batch 8, cold and warm (counters 40 / 36 / 10 x 20, the
     ledger dpm_solver_pp = 20), then t*=5 in 3 steps and its input
     gradient at batch 2, kernels (card) against plain (CPU), fp32 and bf16
     (phase_dpm);
  14. the CLI: python -m diffpure_tpu_torch.cli as a subprocess in a fresh
     directory under chip_smoke_out/ with a seeded CIFAR-10 pickle fixture,
     on the BPDA, rand and rand L2 run scripts' flags (run_scripts/torch/
     cifar10/) with tiny budgets (the rand runs' APGD at 2 iterations,
     TINY_AA_CLI_CODE) and random weights, fp32, and on the three
     ImageNet rand scripts' (run_scripts/torch/imagenet/) with a seeded
     image folder and the same images in an LMDB cache; each run must
     exit 0 and print its NFE report and results line, the BPDA run save
     x_adv_bpda.npy, the ImageNet runs launch #6-#8 and not #9 (the
     YAML-built ADM takes no flash) and read the same images from the
     folder and the LMDB (phase_cli);
  15. the input gradient of the ImageNet purification (guided purify_sde at
     t*=1 through the full-width ADM, flash on, batch 1, a seeded
     cotangent), fp32 and bf16, both grad modes, kernels (card) against
     the plain fp32 path (CPU), the same noise; #6-#9 must launch (phase_adm_grad_parity);
  16. the ImageNet gradient-image rate: the input gradient of the
     cross-entropy of DefendedModel(resize_to=256) at t*=10, bf16 ADM +
     ResNet-50, batch 2, both grad modes, once each (phase 15 warmed the
     paths), wall time, gradient-images/s and peak device memory, the
     launch counters exactly the forward census times the mode's forward
     evaluations (phase_adm_grad_rate);
  17. eval_autoattack 'rand' through the ImageNet defence at the budget
     AA_IMAGENET; x_adv in the eps-ball and in [0, 1], #6-#9 launched
     (phase_adm_attack);
  18. #10's gradient: the t*=5 DDPM purification's input gradient (fp32,
     batch 2, both modes, exact counters) and an NCSN++ 'ddpm' evaluation's
     (bf16), kernels (card) against plain (CPU) (phase_gn_silu_grad).
  19. the CIFAR classifier zoo: ResNet-50, WRN-70-16 with dropout and the
     DeepMind WRN-70-16 at full width, fp32, card against CPU at batch 4,
     ms per forward at batch 64; the bf16 NCSN++ + WRN-70-16-dropout
     defence at t*=100, batch 8, counters 40 / 36 / 10 per evaluation
     (phase_classifiers);
  20. the other purifiers: purify_ode at t*=100 (100 Euler steps), bf16,
     batch 8, cold and warm, beside phase 3's SDE rate; at t*=2, batch 1,
     the purified images and their input gradient through purify_ode
     (checkpoint, adjoint, reversible), purify_ldsde (checkpoint, adjoint)
     and purify_sde (reversible), fp32 and bf16, kernels (card) against
     plain (CPU), the launch counters each mode derives; whether the score
     model gives the same bits twice; reversible Heun's gradient at batch
     16, t*=REV_T (25) (rate, peak memory, reconstruction error) beside phase 5's,
     and its gap to the exact gradient of the same solve (autograd through
     its steps) (phase_purifiers);
  21. eval_autoattack 'standard' (APGD-CE, APGD-T, FAB-T, Square) through
     the bf16 CIFAR defence at t*=5, batch 4, a tiny budget, Linf and L2:
     each attack attacks a non-empty set, x_adv in the ball and [0, 1],
     #1-#5 launched; then the CLI on a stand, an ODE, a WRN-70-16 and an
     ImageNet stand script's flags with tiny budgets, at once
     (phase_standard);
  22. StAdv (ROADMAP item 13) through the fp32 CIFAR defence (NCSN++ +
     ResNet-50) at t*=5, batch 4, 2 iterations of 2 EOT samples: every grid
     within the bound of the identity and in [-1, 1], x_adv in [0, 1], the
     counters 40 / 36 / 10 per forward and 40 / 36 per backward evaluation
     times the NFE ledger; grid_sample card against CPU, values and both
     gradients (phase_stadv);
  23. the discrete guided DDPM (item 15) through the bf16 ADM with flash
     and ResNet-50: DefendedModel with diffusion_type 'ddpm' at t=150 and
     DDIM at t=8 on the ddim50 respacing, batch 4, cold and warm, counters
     56 / 16 / 40 / 5 per evaluation; t=2, batch 1, ancestral and DDIM,
     fp32 and bf16 on the card against the CPU's fp32, and the ADM's
     output itself at the float timestep the ddim50 process gives it; one
     input gradient (checkpoint) through the kernels (phase_guided_ddpm);
  24. the CelebA-HQ defence (item 17): SDEdit's DDPM UNet at full width
     (113,673,219 parameters) + the attribute net, its halo census (30
     stages an evaluation, half with pre_shift), #6 and #8 against their
     plain versions at each of its shapes, bf16 and fp32, batch 2;
     purify_celebahq_ddpm at t=50, batch 2, bf16 and fp32, #6 and #8
     exactly 30 an evaluation and every other kernel 0; one evaluation and
     the t=2 purification, card against CPU, the attribute net
     card against CPU (phase_celebahq); then the CLI on the StAdv and the
     two CelebA-HQ BPDA scripts' flags, at once (phase_new_cli);
  25. training on the card (item 19): (a) the --large defence demo's
     score-matching step (get_step_fn, Adam with its warmup and clip, EMA
     0.999) on the full-width fp32 NCSN++ (106,632,579 parameters) at batch
     128: steps/s, wall and device ms a step, idle share, device ms by part
     (#1 / #2, #3, #4 / #5, the weight cotangents, #3's backward, the
     optimizer), peak memory, launches exactly 40 / 36 / 10 / 40 / 36 a
     step; the loss and every gradient at batch 128 through the kernels
     against the same on the blocks' plain versions on the card
     (plain_blocks); one step at batch 2 with injected draws against the
     CPU's plain step (loss, every gradient, Adam's moments, the weights
     and EMA unchanged by the warmup's lr-0 first update), then two Adam
     updates at lr 1e-3 (one clipped, one not) and the EMA on the same
     gradients, the weights and EMA card against CPU; a forward after two
     steps and an EMA copy_to / restore against the plain forward on the
     weights as they then stand (stale kernel packs); (b) TrainLoop on the
     full-width score_sde DDPM at batch 8 (#10 44 and #3 4 a step), and
     save / resume / one more step, bit for bit; (c) the demo's default
     score model (nf 32, 16x16) against its plain blocks on the card: a
     step at batch 128, the forward and input gradient at batch 8
     (phase_demo_shapes); then the defence demo through python -m
     diffpure_tpu_torch.experiments.defense_demo --device cuda, its
     budgets cut (DEMO_ARGS), #1-#5 launched while the score model trains
     and #1-#3 while it purifies (phase_train_step, phase_train_loop,
     phase_demo);
  26. the score_sde samplers and legacy score models (ROADMAP items 4, 5,
     18): (a) score_sde's VE NCSN++ (configs/cifar10_ve.yml, 62,758,915
     parameters: FIR resampling, the residual input pyramid, Fourier
     features, sigma scaling) in fp32: one evaluation at batch 2 card
     against CPU (fp32 1e-4; bf16 against the CPU's bf16 1e-2, through the
     kernels and with every block plain, beside the VP model's bf16
     evaluation as a yardstick) and two PC
     steps (reverse_diffusion + langevin) card against CPU with the same
     draws; the PC sampler at batch 8 on the VE SDE cut to N = 10, kernels
     against the plain blocks on the card (1e-4, each evaluation and the
     sample), launches exactly 18 / 20 / 6 an evaluation and 6 FIR blocks
     (3 down, 3 up) on JAX's unfused graph; the wall and device ms per
     evaluation at batch 64 by part (#1 / #2, #3, the plain FIR blocks,
     the rest); (b) the VP NCSN++ of configs/cifar10.yml in fp32 under the
     PC sampler (euler_maruyama) and the probability-flow ODE sampler, N =
     10, batch 8, kernels against the plain blocks, 40 / 36 / 10 an
     evaluation; (c) NCSNv2 (ncsnv2_64, 32 px, nf 128, 232 scales from 50
     to 0.01): one evaluation card against CPU, then annealed Langevin
     dynamics (5 steps a level, snr 0.176) over the first 3 noise levels at
     batch 8, cold and warm, no kernel launched (phase_samplers);
  27. the rest of the JAX package: (a) guided-diffusion's
     noise-conditioned classifier (create_classifier at 256 px, 54,096,360
     parameters) at batch 2, fp32 and bf16 card against the CPU's fp32,
     #6 / #7 / #8 launches exactly its 256-px route census (walked on the
     meta device), ms a forward by events and device; the input gradient
     of log p(y | x_t), kernels against the plain routes on the card (fp32
     5e-4; bf16 within BF16_SPREAD of the plain bf16 gradient's distance
     from the plain fp32 one); one classifier-guided DDIM step (ddim50)
     with the ImageNet ADM, fp32, kernels against plain; (b) the 64 -> 256
     upsampler (sr_create_model, 311,027,910, bf16) at batch 1, kernels
     against plain, its census's launches; (c) perturbation_pgd with
     DeltaAddition, ReColorAdv (LUT, YPbPr) and ReColorAdv then
     FullSpatial, pgd_attack Linf, fgsm and carlini_wagner through the fp32
     CIFAR defence (t*=4, checkpoint, batch 8, 2 iterations), launches
     exact, the first-iterate gradient of each parameterisation (LUT and
     grid; x) kernels against the plain blocks (the
     classifier's cotangent held fixed), the discretized check
     and SSIM on each result; (d) the bf16 defence served over two shards
     on the card, bit for bit its per-shard calls; (e) the score_sde DDPM's
     training mode (rate 0 bit for bit eval mode, rate 0.1 #10 44 and #3 4
     times), a debug_dir dump read back, flops_estimate of one NCSN++
     evaluation beside bench.py's 34.70 GFLOP (phase_rest).

The CPU's side of the card-against-CPU checks of phases 6, 9, 13, 15,
20(b), 23, 24, 25(a) and 26 runs in a thread of its own (CpuSide), on CPU
copies of the models, while the main thread goes on driving the card. The
sides run beside phases 7, 11-14, 17-19 and 21-22 and beside 24's CLI runs
and 25(c)'s demo, so
the timed runs of phases 3-5, 8, 10, 16, 20(a, c) and 24(a) have the
host to themselves (23(a) too, once 23's side has ended). Each check
runs where its side is joined (phase 6's at the end of phase 7, 9's and
13's of 14, 15's of 19, 20(b)'s of 21, 23's and 24's in their own
phase) and fails the run there.

Needs the CUDA toolkit (nvcc) and one card; exits non-zero without them.
Writes details (per-shape records, the compiler's report) to
chip_smoke_out/. The second-to-last line of stdout is the kernels' JSON
record, the last the device JSON. ``--stop-after 2b``, ``2c`` or ``2d`` ends
after that phase (a short first run of changed kernels; prints no result
line).
``--profile-adm`` (``--profile-ddpm``) profiles the ImageNet ADM's (the
score_sde DDPM's) evaluation after phase 1 and ends (device time by kernel
family, idle share; profile_adm.json, profile_ddpm.json);
``--profile-cifar`` the CIFAR NCSN++'s at batch 8 and 128 (bf16) and at 8
and 64 (fp32), with the block chains' steps and the host time per block
call in each dtype (profile_cifar.json);
``--profile-grad`` phase 5's gradient step (device time by kernel and by
part, idle share, tensor-map cache misses), one evaluation's backward at
batch 8 and 16 by chain step, the same in fp32 (the run scripts'
precision) at batch 16 and 64 (profile_grad_f32), and phase 16's ImageNet
gradient step at t*=10 by part and by kernel family (profile_grad.json);
``--phase-26`` runs phase 26 alone after phase 1 and ends (phase26.json);
``--phase-27`` phase 27 (phase27.json).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import functools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
OUT = REPO / "chip_smoke_out"
N = 8
SEED = 0
CIFAR_PARAMS = 106_632_579
EVALS = 100  # t* = 100 Euler steps, one score evaluation each
CIFAR_BIG_N = 128  # the CIFAR batch of the JAX bench (bench.py:38 BATCH)
# the fp32 batch of the CIFAR run scripts (15 of 16 pass --adv_batch_size 64,
# none passes --precision: fp32 is the CLI's default)
F32_BIG_N = 64
# kernel -> (source, TPU kernel it replaces, launches per score evaluation)
KERNELS = {
    "fused_resblock": ("diffpure_tpu_torch/csrc/fused_resblock.cu",
                       "diffpure_tpu/ops/fused_resblock.py:290", 40),
    "fused_resblock_cat": ("diffpure_tpu_torch/csrc/fused_resblock.cu",
                           "diffpure_tpu/ops/fused_resblock.py:728", 36),
    "fused_attnblock": ("diffpure_tpu_torch/csrc/fused_attnblock.cu",
                        "diffpure_tpu/ops/fused_attnblock.py:106", 10),
}
# backward kernel -> (source, TPU kernel, the forward kernel whose calls it
# differentiates)
BWD_KERNELS = {
    "fused_resblock_bwd": ("diffpure_tpu_torch/csrc/fused_resblock_bwd.cu",
                           "diffpure_tpu/ops/fused_resblock.py:506", "fused_resblock"),
    "fused_resblock_cat_bwd": ("diffpure_tpu_torch/csrc/fused_resblock_bwd.cu",
                               "diffpure_tpu/ops/fused_resblock.py:941",
                               "fused_resblock_cat"),
}
# The card's published dense peaks (H100 SXM at 700 W): FLOP/s by compute
# dtype (bf16 on the tensor cores, fp32 on the FMA units) and HBM bytes/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES = 3.35e12
# max |kernel - plain| <= REL * max |plain|. fp32: both sides multiply in
# full fp32 (TF32 off), only the summation order differs. bf16: the kernel
# keeps conv0's accumulator in fp32 into GN2 where the plain version rounds
# it to bf16 (as the TPU kernel and the JAX reference differ), and the
# output's own bf16 rounding is 2^-8 relative.
REL = {"float32": 1e-4, "bfloat16": 1e-2}
# Purified images after 5 steps, kernel (card) against plain (CPU), as a
# fraction of max |plain|. In a CPU rehearsal of this run the bf16 torso and
# the fp32 one ended 3.1e-4 apart: the bf16 bound is about 6x that gap; fp32
# kernel and plain differ only in summation order.
SLICE_REL = {"float32": 1e-4, "bfloat16": 2e-3}
# Backward kernels, max |kernel - plain| <= BWD_REL * max |plain|, for each
# of dx (dx1, dx2) and dtemb. fp32: as the forward. bf16: the plain version
# rounds each conv's input gradient to bf16, the kernel keeps d_a2, d_h and
# the skip adjoint in fp32 and rounds only d_c1 (as the TPU kernel). A CPU
# rehearsal at these 17 shapes (batch 2), with the kernel's roundings
# emulated in fp32, put that gap at <= 6.0e-3 of max |plain| (dx) and
# <= 4.2e-3 (dtemb); the bound is 2.5x the larger.
BWD_REL = {"float32": 1e-4, "bfloat16": 1.5e-2}
# The t*=5 input gradient of the purification, kernels (card) against plain
# (CPU). fp32: five steps of summation-order differences. bf16: a CPU
# rehearsal (NCSN++ at nf 32 and 64, two and three levels; t*=5, batch 2)
# put the plain bf16 gradient <= 1.5e-3 of max |plain| from the fp32 one,
# in either grad mode; the kernels round fewer intermediates than the plain
# bf16 path, so their gap to it is about that. The full-width torso is
# deeper: the bound is 6.5x the rehearsed gap.
GRAD_REL = {"float32": 5e-4, "bfloat16": 1e-2}
GRAD_N = 16       # phase 5 batch
GRAD_MODES = ("checkpoint", "adjoint")
# score evaluations per gradient: (forward kernel runs, backward kernel runs)
# as multiples of EVALS. checkpoint: the forward loop, then each step again
# when its checkpoint is recomputed in the backward, then the step's
# backward. adjoint: the forward loop without a graph, then per step one
# drift evaluation without a graph to reconstruct x_prev and one with a
# graph at x_prev, whose backward is the step's only backward.
GRAD_EVALS = {"checkpoint": (2, 1), "adjoint": (3, 1)}
# --profile-grad: steps of the profiled gradient (each step the same work
# as one of phase 5's t*=100 steps).
GRAD_PROFILE_T = 10
# The backward chain's launches (#4/#5) by kernel-name fragment: the
# recomputed GN1 pass, the GEMMs (BWD_GEMMS, in launch order), the
# GroupNorm+SiLU backward passes (BWD_GNS, in launch order), the split-K
# passes. The bf16 chain launches none of OLD_BWD_KERNELS, the fp32 chain
# (csrc/resblock_f32.cu: f32conv_kernel, rb_gn_kernel<float, float>,
# rb_gn_bwd_kernel<float, float>) none of the old fp32 chain's,
# OLD_F32_BWD_KERNELS, at a census shape (phase 2b).
BWD_KINDS = (("gn", ("gn_apply_kernel", "rb_gn_kernel")),
             ("gn_bwd", ("gn_silu_bwd_kernel", "rb_gn_bwd_kernel")),
             ("gemm", ("igemm_", "rb_wgmma_kernel", "f32conv_kernel")), ("splitk", ("splitk_",)))
BWD_GEMMS = ("conv0 recompute", "conv1^T", "conv0^T", "skip adjoint")
BWD_GNS = ("GN2+SiLU backward", "GN1+SiLU backward")
OLD_BWD_KERNELS = ("igemm_bf16_kernel", "gn_silu_bwd_kernel")
OLD_F32_BWD_KERNELS = ("igemm_f32_kernel", "gn_apply_kernel", "gn_silu_bwd_kernel")
# The attention block's (#3) calls per evaluation of the CIFAR NCSN++, by
# shape as shape_census gives them: 9 at 16x16x256, the middle block at
# 4x4x256 (phase 2 checks the census against it).
ATTN_CENSUS = {("fused_attnblock", "none", 16, 256, 0, 256): 9,
               ("fused_attnblock", "none", 4, 256, 0, 256): 1}
# Its chain's launches by kernel-name fragment: the GroupNorm pass, the NIN
# GEMMs (ATTN_GEMMS, in launch order; a split-K pass counts to the GEMM
# before it), the attention core. Both chains have only the first GEMM:
# their output NIN runs in the core (bf16 attn_wgmma_kernel on wgmma + TMA,
# fp32 attn_f32_kernel on the FMA units; their GN passes rb_gn_kernel and
# gn_regs_kernel, the fp32 q | k | v GEMM attn_qkv_f32_kernel). A block
# that launches a kernel of OLD_ATTN_KERNELS, or an out GEMM, fails (phase
# 2): the old fp32 chain was gn_apply_kernel, two igemm_f32_kernel GEMMs
# and attn_kernel, the old bf16 one igemm_bf16_kernel.
ATTN_KINDS = (("gn", ("gn_apply_kernel", "rb_gn_kernel", "gn_regs_kernel")),
              ("gemm", ("igemm_", "rb_wgmma_kernel", "attn_qkv_f32_kernel")),
              ("splitk", ("splitk_", "attn_qkv_sum_kernel")),
              ("core", ("attn_kernel", "attn_wgmma_kernel", "attn_f32_kernel")))
ATTN_GEMMS = ("qkv GEMM", "out GEMM")
OLD_ATTN_KERNELS = ("gn_apply_kernel", "igemm_", "attn_kernel")
OLD_ATTN_STEPS = (ATTN_GEMMS[1],)
# The ImageNet-256 slice: the full-width imagenet256_config ADM (bf16 torso)
# + ResNet-50 at t*=150, batch 4 (run_scripts/imagenet/run_in_rand_inf.sh).
ADM_N = 4
ADM_PARAMS = 552_814_086
ADM_EVALS = 150
# 256-px kernel wrapper -> (source, TPU kernel it replaces)
ADM_KERNELS = {
    "group_stats": ("diffpure_tpu_torch/csrc/tiled_groupnorm.cu",
                    "diffpure_tpu/ops/tiled_groupnorm.py:52"),
    "gn_film_silu_apply": ("diffpure_tpu_torch/csrc/tiled_groupnorm.cu",
                           "diffpure_tpu/ops/tiled_groupnorm.py:136"),
    "gn_silu_conv3x3_halo": ("diffpure_tpu_torch/csrc/halo_conv.cu",
                             "diffpure_tpu/ops/halo_conv.py:168"),
    "flash_attention": ("diffpure_tpu_torch/csrc/flash_attention.cu",
                        "diffpure_tpu/ops/flash_attention.py:145"),
}
# Phase 2c's kernels whose device time (profiler) is taken beside their
# CUDA-event time: #6 and #7, whose event time is mostly the host's
DEVICE_TIMED = ("group_stats", "gn_film_silu_apply")
# Phase 2c's flash attention at the head widths off the census, (BH, T, D),
# T = 1024: the ADM-256's 32^2 attention (4 images, 512 channels) in heads
# of 32 and of 128 channels, and heads of 256, the widest the kernel takes;
# 48, 96 and 160, which it is not built for, run on the kernel of the next
# built width (64, 128, 256), bf16 on the unpadded heads and fp32 on heads
# the wrapper zero-pads; 36 (not a multiple of 8) runs zero-padded to 64 in
# both.
FLASH_WIDTHS_OFF_CENSUS = ((64, 1024, 32), (16, 1024, 128), (32, 1024, 48), (16, 1024, 96),
                           (8, 1024, 160), (8, 1024, 256), (32, 1024, 36))
# The fp32 kernels of #1 / #2's and #4 / #5's chains (f32conv_kernel,
# rb_gn_kernel<float, float>, rb_gn_bwd_kernel<float, float>), #3's chain
# and #10 (both dtypes), which must hold no tensor-core instruction (HMMA,
# HGMMA: TF32 stays off) and spill nothing (phase 1).
FP32_KERNELS = ("attn_f32_kernel", "attn_qkv_f32_kernel", "attn_qkv_sum_kernel",
                "gnsilu_regs_kernel", "gn_regs_kernel", "gnsilu_l2_kernel", "gn_l2_kernel",
                "f32conv_kernel", "rb_gn_kernelIff", "rb_gn_bwd_kernelIff")
# The fp32 forward of #1 / #2 runs f32conv_kernel and rb_gn_kernel<float,
# float> (csrc/resblock_f32.cu); an fp32 #1 / #2 call that launches a
# kernel of the old chain fails (phase 2), and #4 / #5 launch none of them
# either (OLD_F32_BWD_KERNELS): gn_apply_kernel is left only for GroupNorm
# passes beyond the cluster kernels' scratch, off the census.
OLD_F32_FWD_KERNELS = ("igemm_f32_kernel", "gn_apply_kernel")
# The bf16 kernels that must run on wgmma: HGMMA in their SASS (phase 1).
WGMMA_KERNELS = ("halo_wgmma_kernel", "flash_wgmma_kernel", "rb_wgmma_kernel",
                 "attn_wgmma_kernel")
# Phase 9, card (kernels) against CPU (plain versions), max abs error over
# max |CPU|. One full-width ADM evaluation: fp32 differs by summation order
# only (the port's fp32 ADM and JAX's sit 1.5e-6 apart at the small ADM of
# tests/test_torch_adm.py; the full width is deeper and wider, so ~100x
# that). bf16: a CPU rehearsal of the plain bf16 ADM of this structure at
# 64 channels landed 1.4e-2 from its fp32 self; card and CPU round at
# other places (the halo kernel keeps the conv, bias and skip in fp32, the
# flash kernel skips the dense path's bf16 logits) and each drifts about
# that far: 3.5x. The t*=3 fp32 purification: as the CIFAR slice's.
ADM_EVAL_REL = {"float32": 2e-4, "bfloat16": 5e-2}
ADM_PURIFY_REL = 1e-4
# The score_sde DDPM slice: the full-width CIFAR-10 DDPM (fp32; the widths
# of score_sde's configs/vp/ddpm/cifar10_continuous.py) + WRN-28-10 at
# t*=100, batch 8.
DDPM_PARAMS = 35_218_947
# kernel wrapper -> (source, TPU kernel it replaces)
DDPM_KERNELS = {
    "group_norm_silu_fused": ("diffpure_tpu_torch/csrc/group_norm_silu.cu",
                              "diffpure_tpu/ops/groupnorm.py:81"),
    "fused_leaky_relu": ("diffpure_tpu_torch/csrc/fused_act.cu",
                         "diffpure_tpu/ops/fused_act.py:47"),
}
# #11 lies on no path: it is held at the DDPM's feature-map shapes, without
# a bias at one, and at a shape whose element and channel counts are no
# multiple of the 16-byte vector width. (shape, bias)
FLR_CASES = (((N, 32, 32, 128), True), ((N, 16, 16, 256), True), ((N, 16, 16, 256), False),
             ((N, 8, 8, 512), True), ((N, 4, 4, 256), True), ((7, 9, 11, 13), True))
# ... and at two shapes past the 50 MB L2 that the repo's models give a
# first-level activation at full width: the ImageNet ADM's at batch 4
# (imagenet256_config, model_channels 256) and the CIFAR NCSN++'s at the bf16
# serving batch (bench.py:38, 128), with and without a bias; timed in
# steady state past L2 (steady_device_ms). Every shape of #11 is held
# against its plain version with and without a bias.
FLR_LARGE = ((4, 256, 256, 256), (CIFAR_BIG_N, 32, 32, 128))
# #10 off the census: a 64 x 64 map of 512 channels, whose (example, group)
# slices (4096 x 16 values) are above the registers route's budget and take
# the L2 route (ops/groupnorm.py gn_silu_plan). No #10 call may launch the
# old kernel (OLD_GN_KERNELS); this one must launch the L2 route's
# (GN_L2_FRAGMENT).
GN_OFF_CENSUS = ((N, 64, 64, 512),)
OLD_GN_KERNELS = ("gn_silu_kernel",)
GN_L2_FRAGMENT = "_l2_kernel"
# Phase 11, card against CPU, max abs error over max |CPU|: the t*=5 fp32
# DDPM purification as the CIFAR slice's; one NCSN++ 'ddpm' evaluation as
# phase 9's ADM one (fp32: summation order; bf16: card and CPU round at
# other places, #10 once where the plain chain rounds before the SiLU).
DDPM_PURIFY_REL = 1e-4
NCSN_DDPM_REL = {"float32": 2e-4, "bfloat16": 5e-2}
# Phase 15: the ImageNet purification's input gradient, card against the
# CPU's plain fp32 one: t* (Euler steps) and the bound, max |card - cpu|
# <= ADM_GRAD_REL * max |cpu|. fp32: summation order through the steps of
# the full-width ADM and its backward (phase 6's fp32 bound). bf16: a CPU
# rehearsal of this gradient (scripts/torch_rehearse_grad_gaps.py:
# imagenet256_config's structure at 64 and 128 channels, batch 1, t*=2,
# both modes) put the plain bf16 gradient 5.2e-4 to 1.25e-3 of max |plain|
# from the fp32 one, and a card run at the full width 4.4e-4, with the
# card's bf16 gradient 3.9e-4 to 4.9e-4 from the CPU's plain bf16 one; the
# card's bf16 rounds at other places (the halo kernel keeps the conv, bias
# and skip in fp32, flash the logits): phase 6's 1e-2, about 8x the
# largest rehearsed gap.
# t* 1: the CPU's side, two full-width ADM gradients, runs beside phases
# 17-19 and should end within them.
ADM_GRAD_PARITY_T = 1
ADM_GRAD_REL = {"float32": 5e-4, "bfloat16": 1e-2}
# Phase 16: the ImageNet gradient-image rate at JAX's ADM_GRAD_BATCH
# (bench.py:186) and t* = ADM_GRAD_T: 10 (JAX's cell is t* = 150; at 150
# the phase took 113.8 s of a full run, at 50 49.1 s, at 25 26.9 s on the
# slowest card machines seen): a depth cut that holds the run in 1200 s there.
ADM_GRAD_N, ADM_GRAD_T = 2, 10
# Phase 17: eval_autoattack 'rand' through the ImageNet defence: batch, t*
# (Euler steps), APGD iterations, EOT samples, eps (the scripts' 0.0157).
# t* 5 here and phase 7's AA_T 50: depth cuts that hold the run in 1200 s
# on the slowest card machines seen.
AA_IMAGENET = dict(batch=2, t=5, n_iter=2, eot_iter=2, eps=0.0157)
AA_T = 50
# Phase 18: the score_sde DDPM's launches per evaluation (#10, #3), which
# phase 2d's census reads (checked there), and the bound of NCSN++ 'ddpm''s
# bf16 input gradient, card against CPU: a CPU rehearsal (this model,
# batch 2, three seeds) put the plain bf16 gradient 1.1e-2 to 1.2e-2 of max
# |plain| from the fp32 one; the card's #10 rounds once where the plain chain rounds twice, as
# phase 11's forward bound (5e-2, about 4x).
DDPM_GRAD_CENSUS = (44, 4)
NCSN_DDPM_GRAD_REL = 5e-2
# phase 12: BPDA+EOT through the main path's defence, at t* = BPDA_T (the
# scripts' 100 cut to 50, a depth cut that holds the run in 1200 s on the
# slowest card machines seen)
BPDA_N, BPDA_T = 4, 50
BPDA_CFG = dict(adv_steps=2, eot_attack_reps=2, eot_defense_reps=4, defense_batch=4)
# phase 13: DPM-Solver++(2M) steps (score evaluations) at t* = 100
DPM_STEPS = 20
# phase 14: the CLI on the run scripts' flags (run_scripts/torch/cifar10/),
# with tiny budgets
CLI_COMMON = ["--exp", "./exp_results", "--seed", "0", "--data_seed", "0", "--config",
              "cifar10.yml", "--domain", "cifar10", "--diffusion_type", "sde",
              "--score_type", "score_sde", "--adv_eps", "0.031373", "--classifier_name",
              "cifar10-wideresnet-28-10", "--random_weights"]
CLI_RUNS = {
    "bpda": ["--adv_batch_size", "4", "--num_sub", "4", "--t", "100", "--attack_version",
             "bpda", "--eot_defense_reps", "2", "--eot_attack_reps", "2", "--adv_steps", "1"],
    "rand": ["--adv_batch_size", "4", "--num_sub", "4", "--t", "2", "--attack_version",
             "rand", "--eot_iter", "1"],
    # run_cifar_rand_L2.sh
    "rand_L2": ["--adv_batch_size", "4", "--num_sub", "4", "--t", "2", "--attack_version",
                "rand", "--eot_iter", "1", "--lp_norm", "L2", "--adv_eps", "0.5"],
}
# The CLI with AutoAttack cut to AA_STANDARD's budget (the CLI has no flag
# for it), then the launch counters: phase 14's rand runs (at APGD's
# default 100 iterations rand_L2 alone held phase 14 for 77 s) and phase
# 21's runs
TINY_AA_CLI_CODE = (
    "import functools, json, sys; from diffpure_tpu_torch import cli; "
    "from diffpure_tpu_torch.eval import drivers; "
    "from diffpure_tpu_torch.ops import launch_counts; "
    "drivers.AutoAttackConfig = functools.partial(drivers.AutoAttackConfig, n_iter=2, "
    "apgd_t_n_target_classes=2, fab_n_target_classes=2, square_n_queries=8); "
    "cli.main(sys.argv[1:]); print('launches: ' + json.dumps(launch_counts()))")
# ... and on the three ImageNet rand scripts' flags (run_scripts/torch/
# imagenet/), each with its classifier; the first reads the image folder,
# the others the same images from the LMDB cache beside it
IMAGENET_CLI_COMMON = ["--exp", "./exp_results", "--seed", "0", "--data_seed", "0", "--config",
                       "imagenet.yml", "--domain", "imagenet", "--diffusion_type", "sde",
                       "--score_type", "guided_diffusion", "--adv_eps", "0.0157",
                       "--attack_version", "rand", "--random_weights", "--adv_batch_size", "2",
                       "--num_sub", "2", "--t", "2", "--eot_iter", "1"]
IMAGENET_CLI_RUNS = {"rn50": ("imagenet-resnet50", "folder"),
                     "wrn50_2": ("imagenet-wideresnet-50-2", "lmdb"),
                     "deit_s": ("imagenet-deit-s", "lmdb")}
IMAGENET_FIXTURE = 6  # images, 3 classes
# The CLI as ``python -m`` runs it, then the launch counters as a line
CLI_WITH_COUNTS = ("import json, sys; from diffpure_tpu_torch import cli; "
                   "from diffpure_tpu_torch.ops import launch_counts; cli.main(sys.argv[1:]); "
                   "print('launches: ' + json.dumps(launch_counts()))")
CLI_TIMEOUT_S = 400
# Phase 19: the CIFAR classifier zoo (ROADMAP item 14) at full width, fp32,
# with the CLI's classifier seed (1), so that phase 21's CLI run of the
# WRN-70-16 script meets the same network: parameters, card against CPU at
# batch ZOO_N (1e-4 of max |logit|, TF32 off), and the time per forward at
# the run scripts' --adv_batch_size (ZOO_RATE_N).
ZOO = {"cifar10-resnet-50": 23_520_842, "cifar10-wrn-70-16-dropout": 266_796_506,
       "cifar10-wrn-70-16-at0": 266_796_506}
ZOO_N, ZOO_RATE_N, ZOO_REL = 4, 64, 1e-4
# Phase 20: the ODE, LDSDE and reversible purifiers (ROADMAP item 11),
# (diffusion_type, grad_mode) each, at t* = PURIFY_T, batch PURIFY_N: the
# purified images and their input gradient, card against CPU at phases 4 and 6's
# bounds (SLICE_REL, GRAD_REL): the images against the CPU's in the same
# dtype, the gradients against the CPU's fp32, as phase 15 does (a
# rehearsal on the card machine's CPU, at this width, put each mode's plain
# bf16 gradient 1.4e-5 to 1.5e-3 of max |plain| from its fp32 one; the
# CPU's bf16 gradients would cost the run about four minutes). t* = 2 (two
# ODE / SDE steps, one LDSDE step), the depth of the CPU parity tests, and
# batch 1: the CPU's side at t* = 5, batch 2 took two minutes of the run.
PURIFY_MODES = (("ode", "checkpoint"), ("ode", "adjoint"), ("ode", "reversible"),
                ("ldsde", "checkpoint"), ("ldsde", "adjoint"), ("sde", "reversible"))
PURIFY_T, PURIFY_N = 2, 1
# (c) reversible Heun's gradient at batch GRAD_N and t* = REV_T, beside
# phase 5's at 100: 25, a depth cut (with its yardstick, the exact gradient
# of the same solve, it took ≈ 50 s of the run at 100 on a slow card
# machine, and the whole script 1183 s at 50 on the slowest seen)
REV_T = 25
# Phase 21: AutoAttack 'standard' through the bf16 CIFAR defence (WRN-28-10)
# at the budget AA_STANDARD (t* = 5: at 10 the suites took 46 s of the
# run), in each norm at its run scripts' eps
AA_STANDARD = dict(batch=4, t=5, n_iter=2, apgd_t_n_target_classes=2,
                   fab_n_target_classes=2, square_n_queries=8)
STANDARD_EPS = {"Linf": 0.031373, "L2": 0.5}
STANDARD_ATTACKS = ("apgd-ce", "apgd-t", "fab-t", "square")
# ... and the CLI on the new run scripts' flags (run_scripts/torch/), the
# flags read from each script with a tiny budget in place of its own:
# (script under run_scripts/torch/, budget)
STAND_CLI_RUNS = {
    "stand_inf": ("cifar10/run_cifar_stand_inf.sh",
                  ["--num_sub", "4", "--adv_batch_size", "4", "--t", "2"]),
    "rand_inf_ode": ("cifar10/run_cifar_rand_inf_ode.sh",
                     ["--num_sub", "4", "--adv_batch_size", "4", "--t", "2", "--eot_iter", "1"]),
    "stand_L2_70-16-dp": ("cifar10/run_cifar_stand_L2_70-16-dp.sh",
                          ["--num_sub", "4", "--adv_batch_size", "4", "--t", "2"]),
    "in_stand_inf": ("imagenet/run_in_stand_inf.sh",
                     ["--num_sub", "2", "--adv_batch_size", "2", "--t", "2"]),
}
# Phase 22: StAdv (ROADMAP item 13) through the CIFAR defence at its run
# script's fp32 (run_cifar_stadv_rn50.sh: NCSN++, ResNet-50, bound 0.05)
# at t* = 5, batch 4, 2 iterations of 2 EOT samples; and grid_sample, card
# against CPU (values and both gradients; max abs error over max |CPU|:
# summation order only, the values and the image gradient agree to the bit
# on the card, the grid gradient (|max| of tens) to ~1e-5).
STADV = dict(batch=4, t=5, n_iter=2, eot_iter=2, bound=0.05)
GRID_REL = 1e-6
# Phase 23: the discrete guided DDPM (item 15) through imagenet256_config's
# bf16 ADM (flash on): ancestral at t = 150 on the 1000-step process
# (JAX's imagenet256_adm_t150 cell, bench.py:122-152), DDIM at t = 8 on the
# ddim50 respacing (imagenet256_ddim50_t8, bench.py:154-188), batch 4; card
# against CPU at t = 2, batch 1 (fp32 and bf16, against the CPU's fp32:
# ADM_PURIFY_REL and GUIDED_T2_BF16_REL).
GUIDED_T, DDIM_T, DDIM_RESPACING = 150, 8, "ddim50"
DISCRETE_PARITY_T = 2
# At t = 2 the model's output reaches the image through coefficients of
# about 0.01-0.015, so the purification check alone cannot fail a wrong
# model: the ADM's output is also held itself, card against the CPU's fp32,
# at the float timestep the ddim50 process gives respaced index
# GUIDED_EPS_INDEX (its timestep_map: 140.0), fp32 at ADM_EVAL_REL and bf16
# at GUIDED_EPS_BF16_REL (phase 9 reads 9.3e-3 for card bf16 against CPU
# fp32 at t = 149 on the card: about 2x). The t = 2 bf16 purification
# read 3.9e-4 (ancestral) and 2.2e-3 (DDIM) on the card:
# GUIDED_T2_BF16_REL holds them at about 2x.
GUIDED_EPS_INDEX = 7
GUIDED_EPS_BF16_REL = 2e-2
GUIDED_T2_BF16_REL = 5e-3
# Phase 24: the CelebA-HQ defence (item 17): SDEdit's DDPM UNet at full
# width (113,673,219 parameters, jax.eval_shape of JAX's DDPMUNet() at 256^2)
# + the attribute classifier; purify_celebahq_ddpm at t = 50, batch 2, bf16
# (JAX's celebahq_ddpm256_bf16, bench.py:289-318) and fp32; card against CPU
# at t = 2, batch 1, and one evaluation at batch 1, fp32 and bf16 (bf16
# against the CPU's fp32), at phase 9's bounds; the attribute net at
# ZOO_REL. #6 and #8 launch 30 times an evaluation (15 halo blocks, two
# stages each, the second with the timestep embedding as pre_shift, which
# the combine of the stats kernel's sums into the affine takes, in
# PyTorch); each of the census's shapes (the same in both dtypes) is held
# kernel against plain on the card at REL, batch 2, bf16 and fp32.
CELEBAHQ_PARAMS = 113_673_219
CELEBAHQ_T, CELEBAHQ_N = 50, 2
CELEBAHQ_STAGES = 30
# ... and the CLI on the three run scripts this slice adds, at once, with
# tiny budgets: StAdv cut to one iteration (the CLI's own 100 has no flag),
# the CelebA-HQ BPDA runs at t = 2 with 2 defence and 1 attack reps, 1 step
TINY_STADV_CLI_CODE = (
    "import json, sys; from diffpure_tpu_torch import cli; "
    "from diffpure_tpu_torch.ops import launch_counts; kw = cli._attack_kwargs; "
    "cli._attack_kwargs = lambda a: {**kw(a), 'n_iter': 1}; "
    "cli.main(sys.argv[1:]); print('launches: ' + json.dumps(launch_counts()))")
NEW_CLI_RUNS = {
    "stadv_rn50": ("cifar10/run_cifar_stadv_rn50.sh",
                   ["--num_sub", "4", "--adv_batch_size", "4", "--t", "2", "--eot_iter", "1"]),
    "celebahq_glasses": ("celebahq/run_celebahq_bpda_glasses.sh",
                         ["--t", "2", "--eot_defense_reps", "2", "--eot_attack_reps", "1",
                          "--adv_steps", "1"]),
    "celebahq_smiling": ("celebahq/run_celebahq_bpda_smiling.sh",
                         ["--t", "2", "--eot_defense_reps", "2", "--eot_attack_reps", "1",
                          "--adv_steps", "1"]),
}
CELEBAHQ_FIXTURE = 12  # images; every third in the val partition


# phase 25: training on the card. (a) the --large demo's score-matching
# step at its batch; launches a step: the forward's and the backward's
# blocks once each (the weight cotangents and #3's backward are autograd of
# the plain versions, which count nothing)
TRAIN_N = 128
TRAIN_WARM_STEPS = 3
TRAIN_STEP_COUNTS = {"fused_resblock": 40, "fused_resblock_cat": 36, "fused_attnblock": 10,
                     "fused_resblock_bwd": 40, "fused_resblock_cat_bwd": 36}
# one step at batch 2, card against the CPU's plain step: gradients at the
# fp32 gradient bound of PERF.md section 2; a gradient that is zero but for
# rounding (the attention's key bias: the softmax cancels it) must stay
# under ZERO_GRAD of the largest gradient on both sides
TRAIN_PARITY_N = 2
TRAIN_GRAD_REL = 5e-4
ZERO_GRAD = 1e-6
# the forward after the weights move (stale packs): the fp32 forward bound
TRAIN_FWD_REL = 1e-4
# the optimizer on the same gradients, card against CPU: the weights and the
# EMA within TRAIN_GRAD_REL of the largest change of each tensor, plus two
# float32 ulps of its largest value (each side rounds w + u once)
F32_ULP = 2.0 ** -23
# the demo's default score model (nf 32, 16x16) held against its plain
# blocks on the card: a training step at its score batch, and the forward
# and input gradient at the batch it purifies and is attacked at (DEMO_ARGS'
# --n_eval)
DEMO_SCORE_N = 128
DEMO_EVAL_N = 8
# (b) TrainLoop on the score_sde DDPM: #10 and #3 per forward
DDPM_TRAIN_N = 8
DDPM_TRAIN_WARM = 3
DDPM_TRAIN_COUNTS = {"group_norm_silu_fused": 44, "fused_attnblock": 4}
# (c) the demo at its default distribution (nf 32, 16x16), cut to a budget
DEMO_ARGS = ["--score_steps", "50", "--n_eval", "8", "--apgd_iter", "1", "--eot_iter", "1",
             "--attacks", "apgd-eot"]
DEMO_TIMEOUT_S = 300
# the demo in a process of its own, with the launch counts read before and
# after its score model trains and at its end
DEMO_CODE = """import json, sys
from diffpure_tpu_torch.ops import launch_counts
from diffpure_tpu_torch.experiments import defense_demo as demo
marks = {}
train = demo.train_demo_score
def counted(*a, **k):
    marks["before_score_training"] = launch_counts()
    out = train(*a, **k)
    marks["after_score_training"] = launch_counts()
    return out
demo.train_demo_score = counted
demo.main(sys.argv[1:])
marks["end"] = launch_counts()
print("launches: " + json.dumps(marks))
"""
# Phase 26: the score_sde samplers and legacy score models. (a) score_sde's
# VE NCSN++ (configs/cifar10_ve.yml, 62,758,915 parameters): one evaluation
# launches #1 18 times, #2 20 and #3 6, and runs 6 BigGAN blocks that
# resample with the FIR filter (3 down, 3 up) on JAX's unfused graph
VE_PARAMS = 62_758_915
VE_COUNTS = {"fused_resblock": 18, "fused_resblock_cat": 20, "fused_attnblock": 6}
VE_PLAIN_BLOCKS = 6
VE_FOURIER_SCALE = 16.0   # the Fourier projection's W ~ N(0, 16^2), as initialised
VE_PARITY_N = 2           # card against CPU: fp32 at SLICE_REL; bf16 below
# bf16: two bf16 routes that round in different places (card and CPU, the
# kernels and the plain blocks) decorrelate within a few layers, so a whole
# evaluation's bf16 routes sit apart about as far as bf16 sits from fp32.
# Each bf16 distance of one evaluation is therefore held against that of
# the CPU's own bf16 from its fp32 on the same inputs: within a factor
# BF16_SPREAD, either way for the card's distance from its fp32 (a bf16
# route, no worse than the CPU's). One module at a time, fed the CPU's own
# bf16 inputs, the card holds REL["bfloat16"], the blocks' bound (phase 2).
BF16_SPREAD = 2.0
# the PC / ODE schedules cut to 20 steps (score_sde's: 1000)
SAMPLER_N = 20
SAMPLER_BATCH = 8
SAMPLER_REL = 1e-4        # kernels against the plain blocks, per evaluation and at the end
VE_PROFILE_N = 64         # the run scripts' batch: wall and device ms per evaluation by part
VE_PROFILE_EVALS = 3
VE_PARTS = ("#1 / #2", "#3", "plain FIR blocks")
# (c) NCSNv2 (ncsnv2_64) at 32 px, nf 128, under the VE SDE with 232 discrete
# scales from sigma 50 to 0.01, sampled by annealed Langevin dynamics
# (predictor none, corrector ald, 5 steps a level, snr 0.176): score_sde's
# configs/ncsnv2/cifar10.py and NCSNv2's own CIFAR-10 setting (L = 232,
# sigma_1 = 50); the JAX package has no NCSNv2 config loader
NCSNV2_CFG = dict(image_size=32, nf=128, num_scales=232, sigma_min=0.01, sigma_max=50.0)
NCSNV2_PARAMS = 29_694_083
NCSNV2_ALD = dict(snr=0.176, n_steps_each=5)
NCSNV2_LEVELS = 3         # the ALD run: the first 3 of the 232 noise levels
NCSNV2_N = 8

# Phase 27: the rest of the JAX package. (a) guided-diffusion's
# noise-conditioned classifier, create_classifier(**classifier_defaults())
# at 256 px (width 128, depth 2, attention at 32 / 16 / 8, the attention
# pool: 54,096,360 parameters by JAX's tree), batch 2; (b) the 64 -> 256
# upsampler, sr_create_model(256, 64, **SR_FLAGS) (guided-diffusion's
# 64_256 flags without class conditioning, as JAX's factory builds it:
# 311,027,910), batch 1, bf16; (c) the mister_ed attacks and PGD through
# the fp32 CIFAR defence (configs/cifar10.yml's NCSN++ + WRN-28-10), batch
# 8, t* = ME_T, `checkpoint`, ME_ITERS iterations each; (d) the defence
# served over two shards of one card; (e) the DDPM's training mode, a
# debug_dir dump, flops_estimate.
CLS_PARAMS = 54_096_360
CLS_N = 2
SR_PARAMS = 311_027_910
SR_FLAGS = dict(num_channels=192, num_heads=4, num_res_blocks=2, attention_resolutions="32,16,8",
                use_scale_shift_norm=True, resblock_updown=True, learn_sigma=True, use_fp16=True)
# The classifier and the guided step, card against CPU (fp32 reference)
# and kernels against the plain blocks on the card: the ADM's bounds
# (ADM_EVAL_REL: the same blocks, fewer of them). The input gradient of
# log p(y | x_t), kernels against plain: fp32 ADM_GRAD_REL's (phase 15);
# bf16 has no fixed bound: two bf16 routes' gradients sit as far apart as
# bf16's from fp32 (a CPU rehearsal at width 32: 5.3e-2), so the kernels'
# bf16 gradient is held within BF16_SPREAD of the plain bf16 one's
# distance from the plain fp32 one (phase 26's rule)
CLS_GRAD_REL = {"float32": ADM_GRAD_REL["float32"], "bfloat16": float("inf")}
GUIDANCE_SCALE = 1.0
DDIM_STEP = 30            # the guided DDIM step's respaced index on ddim50 (original step 600)
# t* cut to 4 (10 made phase 27 a third of the slack the run's time limit
# leaves the whole script on a slow host)
ME_N, ME_T, ME_ITERS = 8, 4, 2
SERVE_N, SERVE_T = 8, 4
TRAIN_DROPOUT = 0.1       # the score_sde DDPM's own rate (cifar10_continuous.py)
NCSNPP_XLA_GFLOP = 34.70  # bench.py:46, XLA's cost analysis of one evaluation at batch 1

OWN_KERNELS = ("f32conv_kernel", "rb_gn_kernel", "rb_gn_bwd_kernel", "splitk_epilogue_kernel",
               "gn_apply_kernel", "gn_silu_bwd_kernel", "gn_regs_kernel", "attn_qkv_f32_kernel",
               "attn_qkv_sum_kernel", "attn_f32_kernel", "gnsilu_regs_kernel", "gnsilu_l2_kernel",
               "gn_l2_kernel")


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Mean milliseconds per call, by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def block_cost(name, rs, H, c1, c2, cout, n, esize):
    """(FLOPs, bytes) one call of a block kernel must do and move at batch
    n: the convs' and projections' multiply-adds (the GroupNorm and
    elementwise work is < 1% of it) and each input read once, each output
    written once (weights as the kernel reads them, in the compute dtype;
    GroupNorm affines and biases in fp32; backward outputs in fp32)."""
    cin = c1 + c2
    Ho = {"none": H, "down": H // 2, "up": 2 * H}[rs]
    m_in, m_out = n * H * H, n * Ho * Ho
    if name == "fused_attnblock":  # qkv, q k^T, p v, out
        flops = 2 * m_in * 4 * cin * cin + 2 * 2 * n * (H * H) ** 2 * cin
        return flops, 2 * m_in * cin * esize + 4 * cin * cin * esize + 10 * cin * 4
    proj = cin != cout or rs != "none"
    w = 9 * cin * cout + 9 * cout * cout + (cin * cout if proj else 0)
    vecs = (2 * cin + 4 * cout) * 4
    if name.endswith("_bwd"):  # recompute conv0, conv1^T, conv0^T, skip adjoint
        flops = 2 * m_out * (w + 9 * cin * cout)
        nbytes = (m_in * cin + n * cout + m_out * cout + w) * esize + vecs \
            + (m_in * cin + n * cout) * 4
        return flops, nbytes
    return 2 * m_out * w, (m_in * cin + n * cout + m_out * cout + w) * esize + vecs


def bound_ms(records, dtype_name="bfloat16"):
    """Least card time per score evaluation over the records of one kernel
    (calls x the larger of operations over peak and bytes over the HBM
    rate, per shape), and which term bounds most of it."""
    esize = 2 if dtype_name == "bfloat16" else 4
    total, by = 0.0, {"operations": 0.0, "bytes": 0.0}
    for r in records:
        flops, nbytes = block_cost(r["kernel"], r["resample"], r["H"], r["c1"], r["c2"],
                                   r["cout"], N, esize)
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES
        t = max(t_ops, t_bytes) * 1e3 * r["calls_per_eval"]
        total += t
        by["operations" if t_ops >= t_bytes else "bytes"] += t
    return total, max(by, key=by.get)


def block_inputs(torch, dev, i, name, rs, H, c1, c2, cout, n=N):
    """Seeded random-normal block weights and fp32 inputs (x, temb) at batch
    n for the i-th shape of the census, on dev."""
    import numpy as np

    def normal(*shape, fan_in=None, scale=1.0, shift=0.0):
        a = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
        if fan_in:
            a /= np.float32(np.sqrt(fan_in))
        return torch.from_numpy(a + np.float32(shift)).to(dev)

    rng = np.random.default_rng(1000 + i)
    cin = c1 + c2
    if name == "fused_attnblock":
        params = [normal(cin, scale=0.1, shift=1.0), normal(cin, scale=0.1)]
        for _ in range(4):
            params += [normal(cin, cin, fan_in=cin), normal(cin, scale=0.1)]
    else:
        proj = cin != cout or rs != "none"
        params = [normal(cin, scale=0.1, shift=1.0), normal(cin, scale=0.1),
                  normal(cout, cin, 3, 3, fan_in=9 * cin), normal(cout, scale=0.1),
                  normal(cout, scale=0.1, shift=1.0), normal(cout, scale=0.1),
                  normal(cout, cout, 3, 3, fan_in=9 * cout), normal(cout, scale=0.1),
                  normal(cout, cin, fan_in=cin) if proj else None,
                  normal(cout, scale=0.1) if proj else None]
    return tuple(params), normal(n, H, H, cin), normal(n, cout, scale=0.3), normal


# A process opens only so many profiler sessions before they come back
# empty (a run of this script that opened about 190 failed in phase 2b):
# the per-shape records with many small parts share sessions
# (device_ms_many), and the cuDNN yardsticks' device time is taken at batch
# 8 only (CUDA events at every batch).
YARDSTICK_DEVICE_N = N


def kernel_events_many(torch, fns, reps=20):
    """The device events of each of ``fns``, in launch order, from one
    profiler session: each fn runs ``reps`` times back to back, then a
    spin kernel (torch.cuda._sleep) closes its share of the session's
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then records no kernel: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for f in fns:
                for _ in range(reps):
                    f()
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        out, cur = [], []
        for e in evs:
            if "spin_kernel" in e.name:
                out.append(cur)
                cur = []
            else:
                cur.append(e)
        if len(out) == len(fns) and all(out):
            return out
    raise AssertionError("three profiler sessions did not record every function's kernels")


def device_ms_many(torch, fns, reps=20):
    """The device time per call of each of ``fns`` (ms) and the names of
    the kernels it launched, from one profiler session
    (kernel_events_many)."""
    return [(sum(e.time_range.end - e.time_range.start for e in evs) / 1e3 / reps,
             sorted({e.name for e in evs})) for evs in kernel_events_many(torch, fns, reps)]


def device_ms(torch, fn, reps=10):
    """The kernels' own device time per call of fn, from the profiler over
    ``reps`` back-to-back calls (without the host's gaps between them): the
    total, its GEMM, GroupNorm and split-K shares (CHAIN_KINDS), and the
    names of the kernels it launched (``kernels``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then records no kernel: take another
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {"total": 0.0, "gemm": 0.0, "gn": 0.0, "splitk": 0.0, "kernels": []}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if not str(e.device_type).endswith("CUDA") or us <= 0:
                continue
            by["kernels"].append(e.key)
            by["total"] += us / 1e3 / reps
            kind = next((k for k, frags in CHAIN_KINDS if any(f in e.key for f in frags)), None)
            if kind in by:
                by[kind] += us / 1e3 / reps
        if by["total"] > 0:
            return by
    raise AssertionError("three profiler sessions recorded no device time")


def conv_yardstick(torch, params, rs, H, cin, cout, n, dtype=None, device_time=True):
    """cuDNN's F.conv2d on channels_last ``dtype`` (bf16 by default) for a
    block's two 3x3 convs and its 1x1 projection (on the output grid), at
    batch n: a yardstick for the block's GEMMs only (not the same function:
    no GroupNorm, no epilogue), on no path of the port; fp32 with
    torch.backends.cudnn.allow_tf32 off (main sets it). Returns (CUDA-event
    ms, device ms or None) per call."""
    import torch.nn.functional as F

    Ho = {"none": H, "down": H // 2, "up": 2 * H}[rs]
    cl = dict(memory_format=torch.channels_last)
    bf = dtype or torch.bfloat16

    def act(c):
        return torch.randn(n, c, Ho, Ho, device=params[2].device, dtype=bf).contiguous(**cl)
    a1, a2 = act(cin), act(cout)
    w0 = params[2].to(bf).contiguous(**cl)
    w1 = params[6].to(bf).contiguous(**cl)
    wp = None if params[8] is None else params[8].to(bf)[:, :, None, None].contiguous(**cl)
    xs = act(cin) if wp is not None else None

    def call():
        F.conv2d(a1, w0, padding=1)
        F.conv2d(a2, w1, padding=1)
        if wp is not None:
            F.conv2d(xs, wp)
    return cuda_ms(torch, call), (device_ms(torch, call)["total"]
                                  if n == YARDSTICK_DEVICE_N and device_time else None)


def phase_kernels(torch, dev, shapes, n=N, dtypes=("bfloat16", "float32")):
    """Kernel against plain at every main-path shape ``shapes``:
    (kernel, resample, H, c1, c2, cout) -> calls per evaluation, at batch
    n; returns the per-shape records: CUDA-event ms of back-to-back wrapper
    calls (which measure the host where the kernels take less) and the
    kernels' device ms (profiler), plain ms; for the bf16 blocks also the
    GEMMs' share of the device time, TFLOP/s and share of the bound, and
    cuDNN's convs as a yardstick (conv_library_ms); for the attention block
    the device ms by chain step (attn_device_ms), TFLOP/s and share of the
    bound, and in bf16 its PyTorch yardstick (attn_yardstick, library_ms).
    A bf16 attention block that launches a kernel of OLD_ATTN_KERNELS
    fails."""
    from diffpure_tpu_torch.ops import fused_attnblock as fab
    from diffpure_tpu_torch.ops import fused_resblock as frb
    from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups

    records = []
    for i, ((name, rs, H, c1, c2, cout), calls) in enumerate(sorted(shapes.items())):
        params, x32, temb32, _ = block_inputs(torch, dev, i, name, rs, H, c1, c2, cout, n)
        cin = c1 + c2
        g1, g2 = ncsn_num_groups(cin), ncsn_num_groups(cout)
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            x, temb = x32.to(dtype), temb32.to(dtype)
            if name == "fused_attnblock":
                pk = fab.pack_attnblock_params(params, dtype, dev)
                kern = lambda: fab.fused_attnblock(  # noqa: E731
                    x, params, num_groups=g1, packed=pk)
                plain = lambda: fab.fused_attnblock_reference(  # noqa: E731
                    x, params, num_groups=g1)
            elif name == "fused_resblock_cat":
                pk = frb.pack_resblock_params(params, dtype, dev)
                x1, x2 = x[..., :c1].contiguous(), x[..., c1:].contiguous()
                kern = lambda: frb.fused_resblock_cat(  # noqa: E731
                    x1, x2, temb, params, num_groups1=g1, num_groups2=g2, packed=pk)
                plain = lambda: frb.fused_resblock_reference(  # noqa: E731
                    x, temb, params, num_groups1=g1, num_groups2=g2)
            else:
                pk = frb.pack_resblock_params(params, dtype, dev)
                kern = lambda: frb.fused_resblock(  # noqa: E731
                    x, temb, params, num_groups1=g1, num_groups2=g2,
                    resample=rs, packed=pk)
                plain = lambda: frb.fused_resblock_reference(  # noqa: E731
                    x, temb, params, num_groups1=g1, num_groups2=g2, resample=rs)
            with torch.inference_mode():
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                ok = bool(torch.isfinite(got.float()).all()) and err <= REL[dtype_name] * scale
                attn = name == "fused_attnblock"
                dev_ms = attn_device_ms(torch, kern) if attn else device_ms(torch, kern)
                rec = dict(kernel=name, resample=rs, H=H, c1=c1, c2=c2, cout=cout, batch=n,
                           calls_per_eval=calls, dtype=dtype_name, max_abs_err=err,
                           rel_err=err / scale, rel_tol=REL[dtype_name],
                           ms=cuda_ms(torch, kern), device_ms=dev_ms["total"],
                           device_ms_by=dev_ms,
                           plain_ms=cuda_ms(torch, plain, reps=20 if n == N else 5), ok=ok)
                line = ""
                if attn:
                    flops, nbytes = block_cost(name, rs, H, c1, c2, cout, n,
                                               x.element_size())
                    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES
                    old = [k for k in dev_ms["kernels"]
                           if any(f in k for f in OLD_ATTN_KERNELS)]
                    old += [k for k in OLD_ATTN_STEPS if k in dev_ms["steps"]]
                    rec.update(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
                               bound_by="operations" if t_ops >= t_bytes else "bytes",
                               tflops=flops / rec["device_ms"] / 1e9,
                               device_steps=dev_ms["steps"], device_kernels=dev_ms["kernels"])
                    rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
                    steps = ", ".join(f"{k} {v:.4f}" for k, v in dev_ms["steps"].items())
                    line = (f" ({steps}; {rec['tflops']:.1f} TFLOP/s, "
                            f"{rec['bound_share']:.3f} of bound)")
                    rec.update(attn_yardstick(torch, x, params, g1, want))
                    line += (f" PyTorch yardstick {rec['library_ms']:.4f} ms (device "
                             f"{rec['library_device_ms']:.4f}, rel err "
                             f"{rec['library_rel_err']:.1e})")
                    if dtype_name == "float32":
                        core = sdpa_core_yardstick(torch, x, params, g1)
                        rec["sdpa_core"] = core
                        line += (f"; core as SDPA: {core['library_backend']} device "
                                 f"{core['library_device_ms']} ms")
                    if old:
                        rec["ok"] = ok = False
                        line += f" OLD KERNELS {old}"
                else:
                    flops, nbytes = block_cost(name, rs, H, c1, c2, cout, n, x.element_size())
                    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES
                    # fp32: cuDNN's fp32 convs with TF32 off, CUDA events only
                    # (the profiler sessions are a budget)
                    f32 = dtype_name == "float32"
                    lib_ms, lib_dev = conv_yardstick(torch, params, rs, H, cin, cout, n, dtype,
                                                     device_time=not f32)
                    rec.update(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
                               bound_by="operations" if t_ops >= t_bytes else "bytes",
                               tflops=flops / rec["device_ms"] / 1e9,
                               gemm_tflops=flops / max(dev_ms["gemm"], 1e-9) / 1e9,
                               conv_library_ms=lib_ms, conv_library_device_ms=lib_dev)
                    rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
                    line = (f" ({rec['tflops']:.1f} TFLOP/s, GEMM {rec['gemm_tflops']:.1f}, "
                            f"{rec['bound_share']:.3f} of bound) cuDNN convs {lib_ms:.4f} ms "
                            + (f"(device {lib_dev:.4f})" if lib_dev is not None else "")
                            + (f" (allow_tf32={torch.backends.cudnn.allow_tf32})" if f32
                               else ""))
                    if f32:
                        again = kern()
                        old = [k for k in dev_ms["kernels"]
                               if any(f in k for f in OLD_F32_FWD_KERNELS)]
                        rec.update(same_bits=bool(torch.equal(got, again)),
                                   device_kernels=dev_ms["kernels"],
                                   allow_tf32=torch.backends.cudnn.allow_tf32)
                        line += " same bits" if rec["same_bits"] else " BITS DIFFER"
                        if old:
                            line += f" OLD KERNELS {old}"
                        if old or not rec["same_bits"]:
                            rec["ok"] = ok = False
            records.append(rec)
            log(f"  {name:18s} {rs:4s} {H:2d}x{H:<2d} {c1:3d}+{c2:<3d}->{cout:3d} "
                f"b{n:<3d} {dtype_name:8s} rel err {err / scale:.2e} <= {REL[dtype_name]:.0e} "
                f"kernel {rec['ms']:.4f} ms device {rec['device_ms']:.4f} ms (GEMM "
                f"{dev_ms['gemm']:.4f}, GN {dev_ms['gn']:.4f}) plain {rec['plain_ms']:.4f} ms"
                f"{line} {'ok' if ok else 'FAIL'}")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel checks failed: {bad}")
    return records


def phase_f32_blocks(torch, dev, shapes, n=F32_BIG_N, reps=5):
    """#1 / #2 in fp32 (the run scripts' precision) at batch n against the
    plain version at each resblock shape of ``shapes``, run twice (the same
    bits), with CUDA-event ms, the plain version's, and cuDNN's fp32 convs
    as a yardstick (conv_yardstick, TF32 off); the kernels' device time and
    names for all shapes from one profiler session (device_ms_many). A call
    that launches a kernel of OLD_F32_FWD_KERNELS fails."""
    from diffpure_tpu_torch.ops import fused_resblock as frb
    from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups

    records, kerns = [], []
    for i, ((name, rs, H, c1, c2, cout), calls) in enumerate(sorted(shapes.items())):
        if name == "fused_attnblock":
            continue
        params, x, temb, _ = block_inputs(torch, dev, i, name, rs, H, c1, c2, cout, n)
        cin = c1 + c2
        g1, g2 = ncsn_num_groups(cin), ncsn_num_groups(cout)
        pk = frb.pack_resblock_params(params, torch.float32, dev)
        kw = dict(num_groups1=g1, num_groups2=g2)
        if name == "fused_resblock_cat":
            x1, x2 = x[..., :c1].contiguous(), x[..., c1:].contiguous()
            kern = functools.partial(frb.fused_resblock_cat, x1, x2, temb, params, packed=pk,
                                     **kw)
        else:
            kern = functools.partial(frb.fused_resblock, x, temb, params, resample=rs,
                                     packed=pk, **kw)
        with torch.inference_mode():
            got, again = kern(), kern()
            torch.cuda.synchronize()
            want = frb.fused_resblock_reference(x, temb, params, resample=rs, **kw)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            same = bool(torch.equal(got, again))
            ok = bool(torch.isfinite(got).all()) and err <= REL["float32"] * scale and same
            flops, nbytes = block_cost(name, rs, H, c1, c2, cout, n, 4)
            t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES
            lib_ms, _ = conv_yardstick(torch, params, rs, H, cin, cout, n, torch.float32,
                                       device_time=False)
            plain_ms = cuda_ms(torch, lambda: frb.fused_resblock_reference(
                x, temb, params, resample=rs, **kw), reps=3, warmup=1)
            records.append(dict(
                kernel=name, resample=rs, H=H, c1=c1, c2=c2, cout=cout, batch=n,
                calls_per_eval=calls, dtype="float32", max_abs_err=err, rel_err=err / scale,
                rel_tol=REL["float32"], same_bits=same, ms=cuda_ms(torch, kern, reps=reps),
                plain_ms=plain_ms, flops=flops, bytes=nbytes,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                conv_library_ms=lib_ms, allow_tf32=torch.backends.cudnn.allow_tf32, ok=ok))
        kerns.append(kern)
    with torch.inference_mode():
        timed = device_ms_many(torch, kerns, reps=reps)
    for rec, (ms, names) in zip(records, timed):
        old = [k for k in names if any(f in k for f in OLD_F32_FWD_KERNELS)]
        rec.update(device_ms=ms, device_kernels=names, tflops=rec["flops"] / ms / 1e9,
                   bound_share=rec["bound_ms"] / ms)
        if old:
            rec["ok"] = False
        log(f"  {rec['kernel']:18s} {rec['resample']:4s} {rec['H']:2d}x{rec['H']:<2d} "
            f"{rec['c1']:3d}+{rec['c2']:<3d}->{rec['cout']:3d} b{n:<3d} float32  rel err "
            f"{rec['rel_err']:.2e} <= 1e-04{' same bits' if rec['same_bits'] else ' BITS DIFFER'}"
            f" kernel {rec['ms']:.4f} ms device {ms:.4f} ms ({rec['tflops']:.1f} TFLOP/s, "
            f"{rec['bound_share']:.3f} of bound {rec['bound_ms']:.4f}) plain "
            f"{rec['plain_ms']:.4f} ms cuDNN fp32 convs {rec['conv_library_ms']:.4f} ms "
            f"(allow_tf32={rec['allow_tf32']})"
            + (f" OLD KERNELS {old}" if old else "") + f" {'ok' if rec['ok'] else 'FAIL'}")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} fp32 block checks at batch {n} failed: {bad}")
    return records


# The fp32 GEMM alone (csrc/resblock_f32.cu diffpure_f32conv): conv0 of the
# census's 32x32 128 -> 128, 16x16 256 -> 256 and 8x8 concat 512 -> 256
# blocks, (H, cin, cout), at batch 8 and F32_BIG_N; beside the plan's
# kernel, the other thread tile (8 x 8 or 8 x 16, split for its own grid)
# and the 8 x 16 tile's ablated copies (FMAs removed, shared loads removed).
F32_ABLATION = ((32, 128, 128), (16, 256, 256), (8, 512, 256))
F32_ABLATIONS = ("kernel", "other tile", "1/8 of the FMAs", "shared loads once a step")


def sample_clocks(torch, fn, seconds=2.0):
    """nvidia-smi's SM clock, maximum SM clock and power draw, sampled about
    every 0.3 s while fn runs back to back for ``seconds``."""
    import threading

    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True, text=True,
                timeout=30).stdout.strip())
            stop.wait(0.3)

    fn()
    torch.cuda.synchronize()
    th = threading.Thread(target=poll)
    th.start()
    t_end = time.time() + seconds
    while time.time() < t_end:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    return samples


def phase_f32_ablation(torch, dev, reps=10):
    """The fp32 GEMM as a plain 3x3 conv at the F32_ABLATION shapes, tiled
    by resblock_f32_plan, against cuDNN's fp32 conv (TF32 off) at REL, and
    beside it the F32_ABLATIONS variants, each's device time from one
    profiler session: what the kernel's time is made of, and what the
    plan's choice of thread tile gains."""
    import torch.nn.functional as F
    from diffpure_tpu_torch.ops import _cuda
    from diffpure_tpu_torch.ops import fused_resblock as frb

    lib = _cuda.lib()
    sms = _cuda.num_sms(dev)
    cases, fns = [], []
    for n in (N, F32_BIG_N):
        for H, cin, cout in F32_ABLATION:
            g = torch.Generator(device="cpu").manual_seed(H * cin + n)
            act = torch.randn(n, H, H, cin, generator=g).to(dev)
            w = (torch.randn(cout, cin, 3, 3, generator=g) / (9 * cin) ** 0.5).to(dev)
            wk = w.permute(0, 2, 3, 1).reshape(cout, 9 * cin).contiguous()
            plan = frb.resblock_f32_plan(n, H, H, cin, 0, cout, sms)
            conv = plan.convs[0]
            tn = 8 if conv.tn == 16 else 16
            splits, per = frb._f32_split(conv.steps, plan.mtiles * plan.ntiles, n * H * H, cout,
                                         sms * frb.F32_BLOCKS_PER_SM[tn],
                                         _cuda.SPLITK_WORKSPACE)
            other = frb.F32ConvPlan(tn, frb.F32_STAGES[tn], conv.steps, splits, per, 0)
            out = torch.empty(n, H, H, cout, device=dev)
            ws = torch.empty(_cuda.SPLITK_WORKSPACE, device=dev)
            want = F.conv2d(act.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
            for variant in F32_ABLATIONS:
                cp = other if variant == "other tile" else conv
                ablate = max(0, F32_ABLATIONS.index(variant) - 1)
                if ablate and cp.tn != 16:
                    continue  # the ablated copies exist for the 8 x 16 tile

                def call(act=act, wk=wk, out=out, ws=ws, cp=cp, ablate=ablate, n=n, H=H,
                         cin=cin, cout=cout):
                    _cuda.check(lib.diffpure_f32conv(
                        act.data_ptr(), n, H, H, cin, wk.data_ptr(), cout, out.data_ptr(),
                        ws.data_ptr(), _cuda.SPLITK_WORKSPACE, cp.tn, cp.stages, cp.splits,
                        cp.per, ablate, _cuda.stream(dev)), "f32conv")
                call()
                torch.cuda.synchronize()
                rec = dict(batch=n, H=H, cin=cin, cout=cout, variant=variant, tn=cp.tn,
                           splits=cp.splits, flops=2 * n * H * H * 9 * cin * cout)
                if not ablate:
                    err = float((out - want).abs().max())
                    rec.update(max_abs_err=err, rel_err=err / float(want.abs().max()),
                               ok=err <= REL["float32"] * float(want.abs().max()))
                cases.append(rec)
                fns.append(call)
    timed = device_ms_many(torch, fns, reps=reps)
    # the card's SM clock and power while the kernel runs back to back at the
    # last batch-F32_BIG_N shape (its FMA rate is the clock's)
    last = max(i for i, r in enumerate(cases) if r["variant"] == F32_ABLATIONS[0])
    clocks = sample_clocks(torch, fns[last])
    log(f"  SM clock MHz, max MHz, power W while the kernel runs: {clocks}")
    cases[last]["clocks"] = clocks
    for rec, (ms, _) in zip(cases, timed):
        rec.update(device_ms=ms, tflops=rec["flops"] / ms / 1e9)
        log(f"  f32conv b{rec['batch']:<3d} {rec['H']:2d}x{rec['H']:<2d} {rec['cin']:3d}->"
            f"{rec['cout']:3d} (8 x {rec['tn']:2d}, splits {rec['splits']:2d}) "
            f"{rec['variant']:24s} device {ms:.4f} ms ({rec['tflops']:.1f} TFLOP/s by the "
            f"kernel's FLOPs)" + (f" rel err {rec['rel_err']:.2e} {'ok' if rec['ok'] else 'FAIL'}"
                                  if "ok" in rec else ""))
    bad = [r for r in cases if not r.get("ok", True)]
    if bad:
        raise AssertionError(f"the fp32 GEMM disagrees with cuDNN's conv: {bad}")
    return cases


def phase_f32_defended(torch, dev, score, clf, rng, smi, want):
    """Phase 3c: the defended call in fp32 at the run scripts' batch
    (F32_BIG_N), t*=100, cold and warm (purified images/s, the launch
    counters ``want``), then three warm fp32 evaluations of the score model
    at that batch under the profiler: device ms and idle share per
    evaluation, and the block chains' steps."""
    from diffpure_tpu_torch.eval import DefendedModel, get_accuracy
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import PurifyConfig

    score.dtype = torch.float32
    x = torch.from_numpy(rng.uniform(size=(F32_BIG_N, 32, 32, 3)).astype("float32")).to(dev)
    y = torch.from_numpy(rng.integers(0, 10, F32_BIG_N)).to(dev)
    dm = DefendedModel(score, clf, PurifyConfig(t=EVALS, grad_mode="none"), log_every=0)
    res = dict(runs=[])
    for run in ("cold", "warm"):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            acc = get_accuracy(dm, x, y, seed=SEED + 9, bs=F32_BIG_N)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        res["runs"].append(dict(run=run, wall_s=wall, images_per_s=F32_BIG_N / wall,
                                counts=counts))
        log(f"  {run}: {wall:.3f} s, {F32_BIG_N / wall:.3f} images/s on {smi}, accuracy "
            f"{acc:.3f} (random weights); launches {counts}")
        if counts != want:
            raise AssertionError(f"fp32 defended call: launch counts {counts} != {want}")
    prof = profile_eval(torch, score, x * 2 - 1, torch.full((F32_BIG_N,), 99.9, device=dev))
    res["profile"] = {k: prof[k] for k in ("wall_ms_per_eval", "device_ms_per_eval",
                                           "idle_share", "chain_steps")}
    log(f"  one fp32 evaluation at batch {F32_BIG_N}: wall {prof['wall_ms_per_eval']:.3f} ms, "
        f"device {prof['device_ms_per_eval']:.3f} ms, idle share {prof['idle_share']:.3f}; "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(prof["chain_steps"].items())))
    score.dtype = torch.bfloat16
    return res


def phase_f32_grad(torch, score, clf, xg, yg, smi):
    """Phase 5 in fp32: the checkpoint input gradient of CE(DefendedModel)
    at t*=100, batch GRAD_N, cold and warm (gradient-images/s), with its
    exact launch counters."""
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import PurifyConfig

    score.dtype = torch.float32
    dmg = DefendedModel(score, clf, PurifyConfig(t=EVALS, grad_mode="checkpoint"), log_every=0)
    fwd, bwd = GRAD_EVALS["checkpoint"]
    want = {**expected_counts(EVALS * fwd),
            **{k: KERNELS[v[2]][2] * EVALS * bwd for k, v in BWD_KERNELS.items()}}
    runs = []
    for run in ("cold", "warm"):
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        gx, _ = input_grad(torch, dmg, xg, yg, SEED + 5)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs.append(dict(mode="checkpoint", dtype="float32", run=run, wall_s=wall,
                         grad_images_per_s=GRAD_N / wall, counts=counts, peak_gib=peak))
        log(f"  checkpoint fp32 {run}: {wall:.3f} s, {GRAD_N / wall:.3f} gradient-images/s on "
            f"{smi}; peak device memory {peak:.2f} GiB; launches {counts}")
        if tuple(gx.shape) != tuple(xg.shape) or not bool(torch.isfinite(gx).all()) \
                or not bool((gx != 0).any()):
            raise AssertionError(f"fp32 checkpoint: bad input gradient, shape {tuple(gx.shape)}")
        if counts != want:
            raise AssertionError(f"fp32 checkpoint: launch counts {counts} != {want}")
    score.dtype = torch.bfloat16
    return runs


def phase_identity_resample(torch, dev, n=N):
    """The resampling blocks with an identity skip (cin == cout, no
    projection), which no NCSN++ census shape has: the skip is then the
    resampled x (its adjoint, g through the resample's transpose). One up
    and one down block of 128 channels at 16x16, kernel against plain,
    forward at REL and backward at BWD_REL, bf16 and fp32."""
    from diffpure_tpu_torch.ops import fused_resblock as frb

    checks = {}
    for i, rs in enumerate(("up", "down")):
        params, x32, temb32, normal = block_inputs(torch, dev, 900 + i, "fused_resblock", "none",
                                                   16, 128, 0, 128, n)
        if params[8] is not None:
            raise AssertionError("identity-skip block inputs came with a projection")
        Ho = {"up": 32, "down": 8}[rs]
        g32 = normal(n, Ho, Ho, 128)
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            x, temb, g = x32.to(dtype), temb32.to(dtype), g32.to(dtype)
            kw = dict(num_groups1=32, num_groups2=32, resample=rs)
            with torch.inference_mode():
                got = frb.fused_resblock(x, temb, params,
                                         packed=frb.pack_resblock_params(params, dtype, dev),
                                         **kw)
                want = frb.fused_resblock_reference(x, temb, params, **kw)
            got_b = frb.fused_resblock_bwd(x, temb, params, g,
                                           packed_bwd=frb.pack_resblock_bwd_params(params, dtype,
                                                                                   dev), **kw)
            want_b = frb.fused_resblock_bwd_reference(x, temb, params, g, **kw)
            for what, gots, wants, tol in (("forward", (got,), (want,), REL[dtype_name]),
                                           ("backward", got_b, want_b, BWD_REL[dtype_name])):
                rel = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                          for a, b in zip(gots, wants))
                ok = all(bool(torch.isfinite(a.float()).all()) for a in gots) and rel <= tol
                checks[f"{rs}/{what}/{dtype_name}"] = dict(rel_err=rel, rel_tol=tol, ok=ok)
                log(f"  fused_resblock{'_bwd' if what == 'backward' else '    '} {rs:4s} 16x16 "
                    f"128->128 identity skip b{n} {dtype_name:8s} rel err {rel:.2e} <= "
                    f"{tol:.1e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"identity-skip {rs} block {what} {dtype_name}: "
                                         f"kernel and plain disagree")
    return checks


def phase_attn_isolation(torch, dev, n=N):
    """The attention block keeps its examples apart: at each census shape,
    example 1 of a batch of n holds an Inf (its output is then not finite,
    in the plain version too) and every other example's output must be
    finite and agree with the plain version on the same batch, at REL, bf16
    and fp32. A kernel whose boxes reach into a neighbour's rows turns them
    into NaN (0 * Inf)."""
    from diffpure_tpu_torch.ops import fused_attnblock as fab
    from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups

    checks = {}
    for i, ((name, rs, H, c1, c2, cout), _) in enumerate(sorted(ATTN_CENSUS.items())):
        params, x32, _, _ = block_inputs(torch, dev, 950 + i, name, rs, H, c1, c2, cout, n)
        x32[1, 0, 0, 0] = float("inf")
        keep = [e for e in range(n) if e != 1]
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            x = x32.to(dtype)
            kw = dict(num_groups=ncsn_num_groups(c1))
            with torch.inference_mode():
                got = fab.fused_attnblock(x, params, packed=fab.pack_attnblock_params(
                    params, dtype, dev), **kw)[keep].float()
                want = fab.fused_attnblock_reference(x, params, **kw)[keep].float()
            rel = float((got - want).abs().max() / want.abs().max())
            ok = bool(torch.isfinite(got).all()) and rel <= REL[dtype_name]
            checks[f"{H}x{H}/{dtype_name}"] = dict(rel_err=rel, rel_tol=REL[dtype_name], ok=ok)
            log(f"  fused_attnblock {H:2d}x{H:<2d} {c1} b{n}, example 1 holds an Inf; the "
                f"others {dtype_name:8s} rel err {rel:.2e} <= {REL[dtype_name]:.0e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"attention block {H}x{H} {dtype_name}: an example with an "
                                     f"Inf changed its neighbours")
    return checks


def kernel_events(torch, fn, reps):
    """The device events of ``reps`` back-to-back calls of fn under the
    profiler, in launch order."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then records no kernel: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        if evs:
            return evs
    raise AssertionError("three profiler sessions recorded no device time")


def attn_device_ms(torch, fn, reps=10):
    """The attention block's own device time per call of fn, from the
    profiler over ``reps`` back-to-back calls: the total, each step of its
    chain (ATTN_KINDS: GN, qkv GEMM, core (bf16: with the output NIN), out
    GEMM (fp32), labelled in launch order), the GEMMs' and the GN pass's
    totals, and the kernels' names."""
    from collections import Counter

    steps, names, gi, last = Counter(), set(), 0, ATTN_GEMMS[0]
    for e in kernel_events(torch, fn, reps):
        names.add(e.name)
        kind = next((k for k, frags in ATTN_KINDS if any(f in e.name for f in frags)), None)
        if kind == "gn":  # a call's first launch
            label, gi = "GN", 0
        elif kind == "gemm":
            label = last = ATTN_GEMMS[min(gi, len(ATTN_GEMMS) - 1)]
            gi += 1
        elif kind == "splitk":
            label = last
        elif kind == "core":
            label = "core"
        else:
            label = "other (the wrapper's casts and copies)"
        steps[label] += (e.time_range.end - e.time_range.start) / 1e3 / reps
    steps = dict(steps)
    return dict(total=sum(steps.values()), gn=steps.get("GN", 0.0),
                gemm=sum(steps.get(k, 0.0) for k in ATTN_GEMMS), steps=steps,
                kernels=sorted(names))


def attn_yardstick(torch, x, params, groups, want):
    """The attention block in one PyTorch call per step, in x's dtype:
    F.group_norm, torch.matmul for q | k | v, F.scaled_dot_product_attention
    on (N, 1, HW, C) views, torch.matmul for the output NIN, then the
    residual and the 1/sqrt(2): a yardstick on no path of the port. Its
    CUDA-event and device ms per call and its error against the plain
    version ``want``."""
    import torch.nn.functional as F
    from diffpure_tpu_torch.ops.fused_resblock import INV_SQRT2

    gns, gnb, wq, bq, wk, bk, wv, bv, wo, bo = (t.to(x.dtype) for t in params)
    n, H, W, C = x.shape
    wqkv, bqkv = torch.cat([wq, wk, wv], 1), torch.cat([bq, bk, bv])
    xc = x.permute(0, 3, 1, 2)  # the NHWC map as an NCHW view

    def call():
        h = F.group_norm(xc, groups, gns, gnb, 1e-6).permute(0, 2, 3, 1).reshape(n, 1, H * W, C)
        q, k, v = (torch.matmul(h, wqkv) + bqkv).split(C, dim=-1)
        a = F.scaled_dot_product_attention(q, k, v, scale=C ** -0.5)
        o = torch.matmul(a, wo) + bo
        return ((x.reshape(n, 1, H * W, C) + o) * INV_SQRT2).reshape(n, H, W, C)

    with torch.inference_mode():
        got = call()
        torch.cuda.synchronize()
        rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        return dict(library_ms=cuda_ms(torch, call), library_device_ms=device_ms(torch, call)["total"],
                    library_rel_err=rel)


def sdpa_core_yardstick(torch, x, params, groups, reps=20):
    """The attention block's core alone, softmax(q k^T / sqrt(C)) v, as
    F.scaled_dot_product_attention on (N, 1, HW, C) views of q, k, v (from
    the plain GroupNorm and NIN in x's dtype), once under each backend that
    takes them: device ms (profiler) and CUDA-event ms per call, and the
    error against the plain core. The fastest backend by device time that
    agrees within REL is the core's library time. On no path of the port."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gns, gnb, wq, bq, wk, bk, wv, bv = (t.to(x.dtype) for t in params[:8])
    n, H, W, C = x.shape
    with torch.inference_mode():
        h = F.group_norm(x.permute(0, 3, 1, 2), groups, gns, gnb, 1e-6).permute(0, 2, 3, 1)
        q, k, v = ((h.reshape(n, 1, H * W, C) @ w + b).contiguous()
                   for w, b in ((wq, bq), (wk, bk), (wv, bv)))
        s = (q.float() @ k.float().transpose(-1, -2)) * C ** -0.5
        want = torch.softmax(s, dim=-1) @ v.float()
    rel_tol = REL["float32" if x.dtype == torch.float32 else "bfloat16"]
    backends, calls = {}, {}
    for b in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, b, None)
        if backend is None:
            continue

        def call(backend=backend):
            with sdpa_kernel(backend), torch.inference_mode():
                return F.scaled_dot_product_attention(q, k, v, scale=C ** -0.5)
        try:
            out = call()
            torch.cuda.synchronize()
        except RuntimeError as e:
            backends[b] = dict(refused=str(e).splitlines()[0][:200])
            continue
        err = float((out.float() - want).abs().max() / want.abs().max())
        backends[b] = dict(ms=cuda_ms(torch, call, reps), rel_err=err, ok=err <= rel_tol)
        calls[b] = call
    for b, (ms, _) in zip(calls, device_ms_many(torch, list(calls.values()))):
        backends[b]["device_ms"] = ms
    agree = {b: r["device_ms"] for b, r in backends.items() if r.get("ok")}
    best = min(agree, key=agree.get) if agree else None
    return dict(library_device_ms=agree.get(best),
                library_ms=backends[best]["ms"] if best else None, library_backend=best,
                library_backends=backends)


def bwd_steps(evs, reps):
    """The backward kernel's device time per call from the events of
    ``reps`` back-to-back calls: the total, each step of the chain
    (BWD_KINDS, labelled in launch order) and the kernels' names."""
    from collections import Counter

    steps, names, gi, bi = Counter(), set(), 0, 0
    for e in evs:
        names.add(e.name)
        kind = next((k for k, frags in BWD_KINDS if any(f in e.name for f in frags)), None)
        if kind == "gn":  # a call's first chain kernel: the recomputed GN1 pass
            label, gi, bi = "GN1 recompute", 0, 0
        elif kind == "gemm":
            label, gi = BWD_GEMMS[min(gi, len(BWD_GEMMS) - 1)], gi + 1
        elif kind == "gn_bwd":
            label, bi = BWD_GNS[min(bi, len(BWD_GNS) - 1)], bi + 1
        elif kind == "splitk":
            label = "split-K passes"
        else:
            label = "other (the wrapper's casts and copies)"
        steps[label] += (e.time_range.end - e.time_range.start) / 1e3 / reps
    steps = dict(steps)
    shares = dict(recompute=steps.get("GN1 recompute", 0.0) + steps.get("conv0 recompute", 0.0),
                  gemms=sum(steps.get(k, 0.0) for k in BWD_GEMMS[1:]) +
                  steps.get("split-K passes", 0.0),
                  gn_backward=sum(steps.get(k, 0.0) for k in BWD_GNS))
    return dict(total=sum(steps.values()), steps=steps, shares=shares, kernels=sorted(names))


def bwd_device_ms(torch, fn, reps=10):
    """bwd_steps of ``reps`` back-to-back calls of fn under the profiler."""
    return bwd_steps(kernel_events(torch, fn, reps), reps)


def bwd_conv_yardstick(torch, params, rs, H, cin, cout, n, dtype=None, device_time=True):
    """cuDNN on channels_last ``dtype`` (bf16 by default) for the
    backward's four products at batch n: conv0 (the recompute), conv1 and
    conv0 transposed (F.conv_transpose2d, the adjoints of the 3x3 SAME
    convs) and the skip projection's adjoint, on the output grid: a
    yardstick for the chain's GEMMs only (no GroupNorm, no epilogue), on no
    path of the port; fp32 with torch.backends.cudnn.allow_tf32 off (main
    sets it). Returns (CUDA-event ms, device ms or None) per call."""
    import torch.nn.functional as F

    Ho = {"none": H, "down": H // 2, "up": 2 * H}[rs]
    cl = dict(memory_format=torch.channels_last)
    bf = dtype or torch.bfloat16

    def act(c):
        return torch.randn(n, c, Ho, Ho, device=params[2].device, dtype=bf).contiguous(**cl)
    a1, g, dc1 = act(cin), act(cout), act(cout)
    w0 = params[2].to(bf).contiguous(**cl)
    w1 = params[6].to(bf).contiguous(**cl)
    wp = None if params[8] is None else params[8].to(bf)[:, :, None, None].contiguous(**cl)

    def call():
        F.conv2d(a1, w0, padding=1)
        F.conv_transpose2d(g, w1, padding=1)
        F.conv_transpose2d(dc1, w0, padding=1)
        if wp is not None:
            F.conv_transpose2d(g, wp)
    return cuda_ms(torch, call), (device_ms(torch, call)["total"]
                                  if n == YARDSTICK_DEVICE_N and device_time else None)


def phase_bwd_kernels(torch, dev, shapes, n=N, dtypes=("float32", "bfloat16"),
                      forbid=OLD_BWD_KERNELS, plain_timing=True, one_session=False):
    """Each backward kernel against autograd of the plain block on the card,
    at every resblock / concat-resblock shape of ``shapes`` (the inputs of
    phase 2 plus a seeded output cotangent g) at batch n; returns per-shape
    records: CUDA-event ms of back-to-back wrapper calls, the profiler's
    device ms with the chain's steps (bwd_steps; one session per call, or
    for all shapes with ``one_session``), plain ms, TFLOP/s, the share of
    the bound and cuDNN's products as a yardstick (conv_library_ms; fp32
    with TF32 off, CUDA events only). ``plain_gap``: the plain bf16
    backward against the plain fp32 one. Each fp32 call runs twice and must
    give the same bits. A bf16 backward that launches a kernel of
    ``forbid``, or an fp32 one that launches one of OLD_F32_BWD_KERNELS,
    fails."""
    from diffpure_tpu_torch.ops import fused_resblock as frb
    from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups

    records, kerns = [], []

    def finish(rec, dev_ms):
        f32 = rec["dtype"] == "float32"
        old = [k for k in dev_ms["kernels"]
               if any(f in k for f in (OLD_F32_BWD_KERNELS if f32 else forbid))]
        rec.update(device_ms=dev_ms["total"], device_steps=dev_ms["steps"],
                   device_shares=dev_ms["shares"], device_kernels=dev_ms["kernels"],
                   tflops=rec["flops"] / dev_ms["total"] / 1e9,
                   bound_share=rec["bound_ms"] / dev_ms["total"])
        if old:
            rec["ok"] = False
        sh = dev_ms["shares"]
        lib_dev = rec["conv_library_device_ms"]
        plain_s = "" if rec["plain_ms"] is None else f" plain {rec['plain_ms']:.4f} ms"
        log(f"  {rec['kernel']:22s} {rec['resample']:4s} {rec['H']:2d}x{rec['H']:<2d} "
            f"{rec['c1']:3d}+{rec['c2']:<3d}->{rec['cout']:3d} b{rec['batch']:<3d} "
            f"{rec['dtype']:8s} rel err {max(rec['rel_err'].values()):.2e} <= "
            f"{rec['rel_tol']:.1e}" + ("" if not f32 else " same bits" if rec["same_bits"]
                                       else " BITS DIFFER")
            + f" kernel {rec['ms']:.4f} ms device {rec['device_ms']:.4f} ms (recompute "
            f"{sh['recompute']:.4f}, GEMMs {sh['gemms']:.4f}, GN bwd {sh['gn_backward']:.4f}; "
            f"{rec['tflops']:.1f} TFLOP/s, {rec['bound_share']:.3f} of bound "
            f"{rec['bound_ms']:.4f}) cuDNN products {rec['conv_library_ms']:.4f} ms "
            + (f"(device {lib_dev:.4f})" if lib_dev is not None else "")
            + (f"(allow_tf32={rec['allow_tf32']})" if f32 else "")
            + (f" OLD KERNELS {old}" if old else "") + plain_s
            + f" {'ok' if rec['ok'] else 'FAIL'}")

    for i, ((name, rs, H, c1, c2, cout), calls) in enumerate(sorted(shapes.items())):
        if name == "fused_attnblock":
            continue
        params, x32, temb32, normal = block_inputs(torch, dev, i, name, rs, H, c1, c2, cout, n)
        Ho = {"none": H, "down": H // 2, "up": 2 * H}[rs]
        g32 = normal(n, Ho, Ho, cout)
        kw = dict(num_groups1=ncsn_num_groups(c1 + c2), num_groups2=ncsn_num_groups(cout))
        wants = {}
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            f32 = dtype_name == "float32"
            x, temb, g = x32.to(dtype), temb32.to(dtype), g32.to(dtype)
            pk = frb.pack_resblock_params(params, dtype, dev)
            pkb = frb.pack_resblock_bwd_params(params, dtype, dev)
            if name == "fused_resblock_cat":
                x1, x2 = x[..., :c1].contiguous(), x[..., c1:].contiguous()
                kern = functools.partial(frb.fused_resblock_cat_bwd, x1, x2, temb, params, g,
                                         packed=pk, packed_bwd=pkb, **kw)
                plain = functools.partial(frb.fused_resblock_cat_bwd_reference, x1, x2, temb,
                                          params, g, **kw)
                outs = ("dx1", "dx2", "dtemb")
            else:
                kern = functools.partial(frb.fused_resblock_bwd, x, temb, params, g,
                                         resample=rs, packed=pk, packed_bwd=pkb, **kw)
                plain = functools.partial(frb.fused_resblock_bwd_reference, x, temb, params, g,
                                          resample=rs, **kw)
                outs = ("dx", "dtemb")
            got = kern()
            again = kern() if f32 else got
            torch.cuda.synchronize()
            want = wants[dtype_name] = plain()
            errs = {o: float((a - b).abs().max()) for o, a, b in zip(outs, got, want)}
            rels = {o: errs[o] / float(b.abs().max()) for o, b in zip(outs, want)}
            same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            ok = all(bool(torch.isfinite(a).all()) for a in got) and same and \
                max(rels.values()) <= BWD_REL[dtype_name]
            flops, nbytes = block_cost(name + "_bwd", rs, H, c1, c2, cout, n,
                                       x.element_size())
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES
            # fp32: cuDNN's fp32 products with TF32 off, CUDA events only
            # (the profiler sessions are a budget)
            lib_ms, lib_dev = bwd_conv_yardstick(torch, params, rs, H, c1 + c2, cout, n, dtype,
                                                 device_time=not f32)
            rec = dict(kernel=name + "_bwd", resample=rs, H=H, c1=c1, c2=c2, cout=cout,
                       batch=n, calls_per_eval=calls, dtype=dtype_name,
                       max_abs_err=max(errs.values()), rel_err=rels,
                       rel_tol=BWD_REL[dtype_name], ms=cuda_ms(torch, kern),
                       plain_ms=cuda_ms(torch, plain) if plain_timing else None,
                       flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       conv_library_ms=lib_ms, conv_library_device_ms=lib_dev, ok=ok)
            if f32:
                rec.update(same_bits=same, allow_tf32=torch.backends.cudnn.allow_tf32)
            if dtype_name == "bfloat16" and "float32" in wants:
                rec["plain_gap"] = {o: float((a - b).abs().max() / b.abs().max())
                                    for o, a, b in zip(outs, want, wants["float32"])}
            records.append(rec)
            if one_session:
                kerns.append(kern)
            else:
                finish(rec, bwd_device_ms(torch, kern))
    if one_session:
        for rec, evs in zip(records, kernel_events_many(torch, kerns, reps=10)):
            finish(rec, bwd_steps(evs, 10))
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} backward kernel checks failed: {bad}")
    return records


def bwd_per_eval(records, label):
    """Per evaluation's backward, for each backward kernel and dtype of
    ``records``: the calls' CUDA-event, device, bound and cuDNN-yardstick
    ms, logged; returns them."""
    out = {}
    for r in records:
        v = out.setdefault(f"{r['kernel']} {r['dtype']}", dict(
            ms=0.0, device_ms=0.0, bound_ms=0.0, conv_library_ms=0.0, max_abs_err=0.0))
        for f in ("ms", "device_ms", "bound_ms", "conv_library_ms"):
            v[f] += r[f] * r["calls_per_eval"]
        v["max_abs_err"] = max(v["max_abs_err"], r["max_abs_err"])
    for k, v in out.items():
        log(f"  {label}, {k}, per evaluation's backward: kernel {v['ms']:.3f} ms, device "
            f"{v['device_ms']:.3f} ms, bound {v['bound_ms']:.3f} ms "
            f"({v['bound_ms'] / v['device_ms']:.3f} of it), cuDNN products "
            f"{v['conv_library_ms']:.3f} ms")
    return out


def build_adm(torch, dev):
    """The full-width imagenet256_config ADM (bf16 torso) with seeded
    random-normal weights, built on the meta device and filled from numpy."""
    from diffpure_tpu_torch.models import ADMUNet, imagenet256_config
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    with torch.device("meta"):
        adm = ADMUNet(**imagenet256_config())
    sd = seeded_normal_state_dict(adm, SEED + 10)
    adm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, assign=True)
    n_params = sum(p.numel() for p in adm.parameters())
    if n_params != ADM_PARAMS:
        raise AssertionError(f"ADM has {n_params} params, expected {ADM_PARAMS}")
    return adm.eval().requires_grad_(False).to(dev)


def adm_route_census(torch, model, x_shape, **inputs):
    """The 256-px routes of one evaluation of an ADM-family ``model`` (built
    on the meta device) at an input of ``x_shape``, walked on the meta
    device with adm_unet's two route functions replaced by recorders:
    ("halo", x shape, cout, projected skip) and ("tiled", x shape, FiLM) ->
    calls. ``inputs``: the model's other tensor arguments by name (meta
    tensors), timesteps zero unless given. ``census_launches`` turns it
    into kernel launches."""
    from collections import Counter
    from diffpure_tpu_torch.models import adm_unet

    calls = Counter()

    def halo(x, gn_scale, gn_bias, film_scale, film_shift, w, bias, skip, w_proj,
             pre_shift, num_groups, eps, packed=None):
        calls[("halo", tuple(x.shape), w.shape[-1], w_proj is not None)] += 1
        return torch.empty(tuple(x.shape[:3]) + (w.shape[-1],), dtype=x.dtype,
                           device=x.device)

    def tiled(x, scale, bias, num_groups, eps, film_scale, film_shift, silu):
        calls[("tiled", tuple(x.shape), film_scale is not None)] += 1
        return torch.empty_like(x)

    inputs.setdefault("timesteps", torch.zeros(x_shape[0], dtype=torch.int32,
                                               device="meta"))
    with mock.patch.object(adm_unet, "gn_silu_conv_block", halo), \
            mock.patch.object(adm_unet, "group_norm_film_silu", tiled):
        model(torch.empty(*x_shape, device="meta"), **inputs)
    return calls


def census_launches(census):
    """Launches per kernel wrapper of an ``adm_route_census``: a halo stage
    is one #6 (``group_stats``) and one #8 (``gn_silu_conv3x3_halo``), a
    tiled call one #6 and one #7 (``gn_film_silu_apply``)."""
    halo = sum(n for k, n in census.items() if k[0] == "halo")
    tiled = sum(n for k, n in census.items() if k[0] == "tiled")
    return {"group_stats": halo + tiled, "gn_film_silu_apply": tiled,
            "gn_silu_conv3x3_halo": halo, "flash_attention": 0}


def adm_census(torch, adm, x):
    """(kernel wrapper, shape key) -> calls over one ADM evaluation at x's
    batch, recorded at the four kernels' launchers as the model's autograd
    Functions (halo_conv.gn_silu_conv_block, tiled_groupnorm.
    group_norm_film_silu, flash_attention) call them."""
    from collections import Counter
    from diffpure_tpu_torch.ops import flash_attention as fla
    from diffpure_tpu_torch.ops import halo_conv as halo
    from diffpure_tpu_torch.ops import tiled_groupnorm as tgn

    seen = Counter()
    keys = {
        "_stats_kernel": lambda x_: ("group_stats", (x_.shape[1], x_.shape[3])),
        "_apply_kernel": lambda x_, A, B, silu: ("gn_film_silu_apply",
                                                 (x_.shape[1], x_.shape[3], bool(silu))),
        "_halo_kernel": lambda x_, A, B, w, b, skip, wp, pk: ("gn_silu_conv3x3_halo", (
            x_.shape[1], x_.shape[3], w.shape[3],
            "none" if skip is None else ("identity" if wp is None else "proj"),
            0 if skip is None else skip.shape[3])),
        "_flash_kernel": lambda scale, q, k, v: ("flash_attention", tuple(q.shape))}

    def recorder(orig, key):
        def rec(*a):
            seen[key(*a)] += 1
            return orig(*a)
        return rec

    # the launchers as each module's functions look them up, and flash's
    # Function table, which holds its launcher itself
    patched = [(m, n, getattr(m, n)) for m, n in (
        (tgn, "_stats_kernel"), (halo, "_stats_kernel"), (tgn, "_apply_kernel"),
        (halo, "_halo_kernel"))] + [(fla, "_FLASH", fla._FLASH)]
    try:
        for m, n, orig in patched[:-1]:
            setattr(m, n, recorder(orig, keys[n]))
        fla._FLASH = (recorder(fla._flash_kernel, keys["_flash_kernel"]), *fla._FLASH[1:])
        with torch.inference_mode():
            adm(x, torch.full((x.shape[0],), 149, dtype=torch.int32, device=x.device))
    finally:
        for m, n, orig in patched:
            setattr(m, n, orig)
    return dict(seen)


def adm_cost(name, shape, esize, n=ADM_N):
    """(FLOPs, bytes) one call of a 256-px kernel must do and move at batch
    n: each input read once, each output written once (weights in the
    compute dtype; the affines, biases and stats partials in fp32)."""
    if name == "flash_attention":
        bh, t, d = shape
        return 4 * bh * t * t * d, 4 * bh * t * d * esize
    if name == "gn_silu_conv3x3_halo":
        H, cin, cout, kind, cr = shape
        m = n * H * H
        k = 9 * cin + (cr if kind == "proj" else 0)
        nbytes = (m * (cin + cout + (cr if kind != "none" else 0)) + k * cout) * esize \
            + (2 * n * cin + cout) * 4
        return 2 * m * cout * k, nbytes
    H, C = shape[:2]
    elems = n * H * H * C
    if name == "group_stats":  # sum and sum of squares; (N, tiles, C) partials out
        from diffpure_tpu_torch.ops.tiled_groupnorm import _rows_per_tile
        tiles = -(-H // _rows_per_tile(n, H, C))
        return 3 * elems, elems * esize + 2 * n * tiles * C * 4
    return 6 * elems, 2 * elems * esize + 2 * n * C * 4  # gn_film_silu_apply


def sass_counts(torch, lib_path, mnemonics=("HGMMA", "HMMA")):
    """{mnemonic: {kernel function: count}} of tensor-core instructions
    (HGMMA: wgmma; HMMA: mma.sync, TF32 included) in the built library's
    SASS, by cuobjdump from the toolkit that built it."""
    import re
    from diffpure_tpu_torch.ops._cuda import _nvcc

    tool = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {m: {} for m in mnemonics}, None
    pats = {m: re.compile(rf"\b{m}\b") for m in mnemonics}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            for m in mnemonics:
                counts[m][fn] = 0
        elif fn is not None:
            for m in mnemonics:
                if pats[m].search(line):
                    counts[m][fn] += 1
    return counts


def ptxas_report(text, fragments):
    """{entry function: {registers, spill}} from nvcc's -Xptxas -v report
    (the build log), for the functions whose names hold one of
    ``fragments``; spill: bytes of spill stores and loads."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if any(f in m.group(1) for f in fragments) else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {})["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def sdpa_yardstick(torch, q, k, v, want, rel, reps, warm):
    """F.scaled_dot_product_attention on 4-D views (1, BH, T, D) of q, k, v,
    once under each backend that accepts them: its time and its error
    against the plain version (``want``). The fastest backend that agrees
    within ``rel`` is the flash kernel's library_ms. On no path of the port."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = q[None], k[None], v[None]
    scale = q.shape[-1] ** -0.5
    backends = {}
    for b in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, b, None)
        if backend is None:
            continue

        def call():
            return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        with sdpa_kernel(backend):  # entered once: its own cost stays out of the time
            try:
                out = call()[0]
                torch.cuda.synchronize()
            except RuntimeError as e:
                backends[b] = dict(refused=str(e).splitlines()[0][:200])
                continue
            err = float((out.float() - want.float()).abs().max() / want.float().abs().max())
            backends[b] = dict(ms=cuda_ms(torch, call, reps, warm), rel_err=err, ok=err <= rel)
    agree = {b: r["ms"] for b, r in backends.items() if r.get("ok")}
    best = min(agree, key=agree.get) if agree else None
    return dict(library_ms=agree.get(best), library_backend=best, library_backends=backends)


def phase_adm_kernels(torch, dev, census, n=ADM_N, device_time=True):
    """Each 256-px kernel against its plain version on the card at every
    census shape, bf16 and fp32, seeded inputs at batch n; per-shape
    records with kernel, plain (and for flash attention the library
    call's) times and the bound; with ``device_time``, for #6 and #7
    (DEVICE_TIMED) also the device time (profiler, one session), summed per
    evaluation beside the CUDA-event time. A group_stats shape (H, C) is
    checked with FiLM (the ADM's); (H, C, "pre_shift") with a pre_shift
    and (H, C, "plain") with neither (the SDEdit UNet's two stages)."""
    import numpy as np
    from diffpure_tpu_torch.ops import flash_attention as fla
    from diffpure_tpu_torch.ops import halo_conv as halo
    from diffpure_tpu_torch.ops import tiled_groupnorm as tgn

    records, device_fns = [], []
    for i, ((name, shape), calls) in enumerate(sorted(census.items(), key=str)):
        rng = np.random.default_rng(2000 + i)

        def normal(*s, fan_in=None, scale=1.0, shift=0.0):
            a = rng.standard_normal(s).astype(np.float32) * np.float32(scale)
            if fan_in:
                a /= np.float32(np.sqrt(fan_in))
            return torch.from_numpy(a + np.float32(shift)).to(dev)

        if name == "flash_attention":
            bh, t, d = shape
            q32, k32, v32 = normal(bh, t, d), normal(bh, t, d), normal(bh, t, d)
        else:
            H, C = shape[0], shape[1]
            x32 = normal(n, H, H, C, shift=0.2)
            A, B = normal(n, C, scale=0.3, shift=1.0), normal(n, C, scale=0.3)
        if name == "group_stats":
            gs, gb = normal(C, scale=0.1, shift=1.0), normal(C, scale=0.1)
            fs, ft = normal(n, C, scale=0.1), normal(n, C, scale=0.1)
            if len(shape) > 2:
                fs = ft = None
            ps = normal(n, C, scale=0.5) if shape[2:] == ("pre_shift",) else None
        if name == "gn_silu_conv3x3_halo":
            _, cin, cout, kind, cr = shape
            w, b = normal(3, 3, cin, cout, fan_in=9 * cin), normal(cout, scale=0.1)
            skip32 = None if kind == "none" else normal(n, H, H, cr)
            wp = normal(cr, cout, fan_in=cr) if kind == "proj" else None
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            esize = 2 if dtype_name == "bfloat16" else 4
            if name == "flash_attention":
                q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
                sc = 1.0 / shape[2] ** 0.25
                kern = lambda: fla.flash_attention(q, k, v, sc)  # noqa: E731
                plain = lambda: fla._reference_attention(q, k, v, sc)  # noqa: E731
                check = (kern, plain)
            elif name == "group_stats":
                x = x32.to(dtype)
                kern = lambda: tgn.group_stats(x)  # noqa: E731
                plain = lambda: tgn.group_sums_reference(x)  # noqa: E731
                # the checked function: the per-(example, channel) affine
                check = (lambda: tgn.group_stats_affine(x, gs, gb, 32, 1e-5, fs, ft, ps),
                         lambda: tgn.group_stats_affine_reference(x, gs, gb, 32, 1e-5, fs, ft,
                                                                  ps))
            elif name == "gn_film_silu_apply":
                x = x32.to(dtype)
                kern = lambda: tgn.gn_film_silu_apply(x, A, B, shape[2])  # noqa: E731
                plain = lambda: tgn.gn_film_silu_apply_reference(x, A, B, shape[2])  # noqa: E731
                check = (kern, plain)
            else:
                x = x32.to(dtype)
                skip = None if skip32 is None else skip32.to(dtype)
                pk = halo.pack_halo_weights(w, wp, dtype, dev)
                kern = lambda: halo.gn_silu_conv3x3_halo(  # noqa: E731
                    x, A, B, w, b, skip=skip, w_proj=wp, packed=pk)
                plain = lambda: halo.gn_silu_conv3x3_reference(  # noqa: E731
                    x, A, B, w, b, skip=skip, w_proj=wp)
                check = (kern, plain)
            got = check[0]()
            torch.cuda.synchronize()
            want = check[1]()
            got, want = (got if isinstance(got, tuple) else (got,)), \
                (want if isinstance(want, tuple) else (want,))
            rels = [float((g.float() - w_.float()).abs().max() / w_.float().abs().max())
                    for g, w_ in zip(got, want)]
            err = max(float((g.float() - w_.float()).abs().max()) for g, w_ in zip(got, want))
            ok = all(bool(torch.isfinite(g.float()).all()) for g in got) \
                and max(rels) <= REL[dtype_name]
            flops, nbytes = adm_cost(name, shape, esize, n)
            t_ops = flops / PEAK_FLOPS[dtype_name]
            t_bytes = nbytes / HBM_BYTES
            big = flops > 1e11
            reps, warm = (5, 1) if big and dtype_name == "float32" else (10, 2)
            rec = dict(kernel=name, shape=list(shape), calls_per_eval=calls, dtype=dtype_name,
                       max_abs_err=err, rel_err=max(rels), rel_tol=REL[dtype_name],
                       ms=cuda_ms(torch, kern, reps, warm),
                       plain_ms=cuda_ms(torch, plain, reps, warm), library_ms=None,
                       flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes", ok=ok)
            rec["tflops"] = flops / rec["ms"] / 1e9
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            if name == "flash_attention":
                rec.update(sdpa_yardstick(torch, q, k, v, want[0], REL[dtype_name], reps, warm))
            records.append(rec)
            if device_time and name in DEVICE_TIMED:
                # bound now: the loop's lambdas read the loop's variables
                device_fns.append((rec, functools.partial(tgn.group_stats, x)
                                   if name == "group_stats" else functools.partial(
                                       tgn.gn_film_silu_apply, x, A, B, shape[2])))
            lib = rec["library_ms"]
            log(f"  {name:20s} {str(shape):32s} x{calls:<2d} {dtype_name:8s} rel err "
                f"{max(rels):.2e} <= {REL[dtype_name]:.0e} kernel {rec['ms']:.4f} ms "
                f"({rec['tflops']:.1f} TFLOP/s, {rec['bound_share']:.3f} of bound) plain "
                f"{rec['plain_ms']:.4f} ms bound {rec['bound_ms']:.4f} ms"
                + ("" if lib is None else f" library {lib:.4f} ms ({rec['library_backend']})")
                + f" {'ok' if ok else 'FAIL'}")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} 256-px kernel checks failed: {bad}")
    if not device_time:
        return records
    # #6 and #7's device time (one profiler session), beside their CUDA-event
    # time, per evaluation
    for (rec, _), (ms, _) in zip(device_fns, device_ms_many(torch, [f for _, f in device_fns])):
        rec["device_ms"] = ms
    for name in DEVICE_TIMED:
        for dtype_name in ("bfloat16", "float32"):
            mine = [r for r in records if r["kernel"] == name and r["dtype"] == dtype_name]
            per_eval = {k: sum(r[k] * r["calls_per_eval"] for r in mine)
                        for k in ("ms", "device_ms", "bound_ms")}
            log(f"  {name} {dtype_name} per evaluation: kernel (CUDA events) "
                f"{per_eval['ms']:.3f} ms, device (profiler) {per_eval['device_ms']:.3f} ms, "
                f"bound {per_eval['bound_ms']:.3f} ms ({per_eval['bound_ms'] / per_eval['device_ms']:.2f} "
                f"of the device time)")
    return records


def phase_flash_widths(torch, dev):
    """Flash attention at the head widths FLASH_WIDTHS_OFF_CENSUS (off the
    ImageNet-256 census, whose heads are 64 wide), T = 1024 tokens (JAX's
    flash gate), against its plain version on the card at REL, bf16 and
    fp32, with the same records as phase 2c's (the SDPA yardstick beside
    it); calls_per_eval 0: no shipped configuration runs them."""
    import numpy as np
    from diffpure_tpu_torch.ops import flash_attention as fla

    records = []
    for i, shape in enumerate(FLASH_WIDTHS_OFF_CENSUS):
        rng = np.random.default_rng(2500 + i)
        q32, k32, v32 = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                         for _ in range(3))
        sc = 1.0 / shape[2] ** 0.25
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            kern = lambda: fla.flash_attention(q, k, v, sc)  # noqa: E731
            plain = lambda: fla._reference_attention(q, k, v, sc)  # noqa: E731
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = float((got.float() - want.float()).abs().max())
            rel = err / float(want.float().abs().max())
            ok = bool(torch.isfinite(got.float()).all()) and rel <= REL[dtype_name]
            flops, nbytes = adm_cost("flash_attention", shape, 2 if dtype_name == "bfloat16" else 4)
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES
            rec = dict(kernel="flash_attention", shape=list(shape), calls_per_eval=0,
                       dtype=dtype_name, max_abs_err=err, rel_err=rel, rel_tol=REL[dtype_name],
                       ms=cuda_ms(torch, kern, 10, 2), plain_ms=cuda_ms(torch, plain, 10, 2),
                       flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes", ok=ok)
            rec["tflops"] = flops / rec["ms"] / 1e9
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            rec.update(sdpa_yardstick(torch, q, k, v, want, REL[dtype_name], 10, 2))
            records.append(rec)
            lib = rec["library_ms"]
            log(f"  flash_attention D={shape[2]:<3d} {str(shape):16s} {dtype_name:8s} rel err "
                f"{rel:.2e} <= {REL[dtype_name]:.0e} kernel {rec['ms']:.4f} ms "
                f"({rec['tflops']:.1f} TFLOP/s, {rec['bound_share']:.3f} of bound) plain "
                f"{rec['plain_ms']:.4f} ms bound {rec['bound_ms']:.4f} ms"
                + ("" if lib is None else f" library {lib:.4f} ms ({rec['library_backend']})")
                + f" {'ok' if ok else 'FAIL'}")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} flash head-width checks failed: {bad}")
    return records


# Kernel families of a device profile, by kernel-name fragment; the first
# that matches names the family.
FAMILIES = (
    # the whole attention block: its fp32 chain's GN pass and GEMMs too (no
    # other kernel of these models launches them)
    ("attention block (#3)", ("attn_", "gn_regs_kernel", "gn_apply_kernel", "igemm_f32",
                              "splitk_epilogue")),
    ("halo conv", "halo_"), ("group stats", "stats_kernel"),
    ("GN apply", "apply_kernel"), ("flash attention", "flash_"),
    ("GN+SiLU (#10)", ("gn_silu_kernel", "gnsilu_")),
    ("convs and matmuls (cuDNN / cuBLAS)", ("conv", "gemm", "xmma", "cutlass",
                                             "sm90", "implicit")),
    ("elementwise", "elementwise"), ("reductions", "reduce"))
ADM_FAMILIES = ("halo conv", "group stats", "GN apply", "flash attention")


def family(name):
    return next((f for f, keys in FAMILIES if any(
        k in name for k in ((keys,) if isinstance(keys, str) else keys))), "other")


def profile_eval(torch, model, x, t, evals=3):
    """torch.profiler over ``evals`` warm evaluations model(x, t): device
    time by kernel family, and the device's idle share of the window's
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for _ in range(2):
            model(x, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for _ in range(evals):
                model(x, t)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
    by, kernels = {}, []
    for e in prof.key_averages():
        # the kernels' own events (the CPU ops that launched them carry
        # their time again)
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if not str(e.device_type).endswith("CUDA") or dev_us <= 0:
            continue
        kernels.append((e.key, dev_us / 1e3 / evals, e.count // evals))
        fam = family(e.key)
        by[fam] = by.get(fam, 0.0) + dev_us / 1e3 / evals
    busy = sum(by.values())
    kernels.sort(key=lambda r: -r[1])
    return dict(wall_ms_per_eval=wall_ms / evals, device_ms_per_eval=busy,
                idle_share=max(0.0, 1.0 - busy * evals / wall_ms), by_family=by,
                top_kernels=kernels[:25], chain_steps=chain_steps(prof, evals))


# Kernel-name fragments of the CIFAR block chains' launches (#1/#2 and #3):
# the GroupNorm pass, the GEMM (the mma.sync one and the wgmma one), the
# split-K pass, the attention core.
CHAIN_KINDS = (("gn", ("gn_apply_kernel", "rb_gn_kernel", "gn_regs_kernel")),
               ("gemm", ("igemm_", "rb_wgmma_kernel", "attn_qkv_f32_kernel", "f32conv_kernel")),
               ("splitk", ("splitk_", "attn_qkv_sum_kernel")),
               ("attn", ("attn_kernel", "attn_wgmma_kernel", "attn_f32_kernel")))


def chain_steps(prof, evals):
    """Device ms per evaluation of each step of the NCSN++ block chains, from
    the profiler's kernels in launch order. A block call's launches follow
    each other with no other kernel between: a run of chain kernels splits
    at each GroupNorm pass into segments; a segment with the attention core
    is an attention block (#3; also by step: its GN pass, qkv GEMM, core
    (bf16: with the output NIN) and fp32's out GEMM, a split-K pass counted
    to its GEMM); the others alternate GN1
    + conv0 and GN2 + conv1 (a resblock's chain never shares a run with
    another resblock: the temb row's plain ops come first)."""
    from collections import Counter

    evs = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                 key=lambda e: e.time_range.start)
    steps, run = Counter(), []

    def flush():
        segs = []
        for kind, dur in run:
            if kind == "gn" and (not segs or segs[-1][-1][0] != "gn"):
                segs.append([])
            if segs:
                segs[-1].append((kind, dur))
        n_res = 0
        for seg in segs:
            if any(k == "attn" for k, _ in seg):
                steps["attention block (#3)"] += sum(d for _, d in seg)
                gemms = 0
                for k, d in seg:
                    if k == "gemm":
                        gemms += 1
                    label = {"gn": "GN", "attn": "core"}.get(
                        k, ATTN_GEMMS[min(max(gemms, 1), 2) - 1])
                    steps[f"#3 {label}"] += d
                continue
            first = n_res % 2 == 0
            n_res += 1
            for k, d in seg:
                steps[{"gn": "GN1 pass" if first else "GN2 pass",
                       "gemm": "conv0" if first else "conv1",
                       "splitk": "split-K pass"}[k]] += d
        run.clear()

    for e in evs:
        kind = next((k for k, frags in CHAIN_KINDS if any(f in e.name for f in frags)), None)
        if kind is None:
            flush()
        else:
            run.append((kind, e.time_range.end - e.time_range.start))
    flush()
    return {k: v / 1e3 / evals for k, v in steps.items()}


def host_us_per_call(torch, dev, dtype=None):
    """Host microseconds per resblock call at batch 8 in ``dtype`` (bf16 by
    default): back-to-back
    calls timed on the host clock up to the last enqueue, once through
    ops/fused_resblock._launch and once through the public wrapper under
    inference_mode; beside them the CUDA-event ms per call (the device
    keeps up with the host where it is below the host's time)."""
    from diffpure_tpu_torch.ops import fused_resblock as frb
    from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups

    dtype = dtype or torch.bfloat16
    out = {}
    for rs, H, c, cout in (("none", 4, 256, 256), ("none", 32, 128, 128)):
        params, x32, temb32, _ = block_inputs(torch, dev, 0, "fused_resblock", rs, H, c, 0, cout)
        x, temb = x32.to(dtype), temb32.to(dtype)
        g1, g2 = ncsn_num_groups(c), ncsn_num_groups(cout)
        pk = frb.pack_resblock_params(params, dtype, dev)
        calls = {
            "_launch": lambda: frb._launch(x, None, temb, pk, g1, g2, 1e-6, True, rs),
            "fused_resblock": lambda: frb.fused_resblock(
                x, temb, params, num_groups1=g1, num_groups2=g2, resample=rs, packed=pk)}
        for what, fn in calls.items():
            reps = 150
            with torch.inference_mode():
                ms = cuda_ms(torch, fn, reps=reps, warmup=10)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                host = (time.perf_counter() - t0) / reps * 1e6
                torch.cuda.synchronize()
            out[f"{what} {H}x{H} {c}->{cout}"] = dict(host_us=host, cuda_event_ms=ms)
    return out


def profile_cifar(torch, dev, smi):
    """--profile-cifar: warm evaluations of the full-width NCSN++ under the
    profiler (device ms by kernel, the block chains' steps, idle share),
    bf16 torso at batch 8 and 128 and fp32 (the CLI's default precision)
    at batch 8 and F32_BIG_N, the host time per block call in each dtype,
    and phase 3b's defended call at batch 128 (t*=100, cold and warm
    wall)."""
    import numpy as np
    from diffpure_tpu_torch.eval import DefendedModel, get_accuracy
    from diffpure_tpu_torch.purify import PurifyConfig

    score, clf = build_models(torch, dev, torch.bfloat16)
    res = dict(card=smi)
    for dtype, tag, batches in ((torch.bfloat16, "bf16", (N, CIFAR_BIG_N)),
                                (torch.float32, "fp32", (N, F32_BIG_N))):
        score.dtype = dtype
        for n in batches:
            log(f"== profile: CIFAR NCSN++ evaluations, batch {n}, {tag}")
            x, t = torch.randn(n, 32, 32, 3, device=dev), torch.full((n,), 99.9, device=dev)
            prof = profile_eval(torch, score, x, t)
            res[f"batch_{n}" if tag == "bf16" else f"fp32_batch_{n}"] = prof
            log(f"  wall {prof['wall_ms_per_eval']:.3f} ms, device "
                f"{prof['device_ms_per_eval']:.3f} ms per evaluation, idle share "
                f"{prof['idle_share']:.3f} on {smi}")
            for step, ms in sorted(prof["chain_steps"].items(), key=lambda kv: -kv[1]):
                log(f"  chain step {step:24s} {ms:8.3f} ms")
            for name, ms, calls in prof["top_kernels"][:12]:
                log(f"  {ms:8.3f} ms x{calls:<4d} {name[:100]}")
        host = host_us_per_call(torch, dev, dtype)
        res["host_us" if tag == "bf16" else "fp32_host_us"] = host
        for k, v in host.items():
            log(f"  host {tag} {k:36s} {v['host_us']:8.1f} us per call (CUDA events "
                f"{v['cuda_event_ms'] * 1e3:8.1f} us)")
    score.dtype = torch.bfloat16
    rng = np.random.default_rng(SEED + 8)
    x128 = torch.from_numpy(rng.uniform(size=(CIFAR_BIG_N, 32, 32, 3)).astype(np.float32)).to(dev)
    y128 = torch.from_numpy(rng.integers(0, 10, CIFAR_BIG_N)).to(dev)
    dm = DefendedModel(score, clf, PurifyConfig(t=EVALS, grad_mode="none"), log_every=0)
    res["defended_128_wall_s"] = []
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            get_accuracy(dm, x128, y128, seed=SEED + 8, bs=CIFAR_BIG_N)
        torch.cuda.synchronize()
        res["defended_128_wall_s"].append(time.time() - t0)
        log(f"  phase 3b's defended call, batch {CIFAR_BIG_N}, {run}: "
            f"{res['defended_128_wall_s'][-1]:.3f} s on {smi}")
    (OUT / "profile_cifar.json").write_text(json.dumps(res, indent=1))


def range_device_ms(prof, fragment):
    """Device ms of the kernels launched inside the profiler's outermost CPU
    ranges whose name contains ``fragment``: the kernels of each range's
    launches and of its descendants'."""
    def kernels_ms(e):
        return sum(k.duration for k in e.kernels) / 1e3 + sum(
            kernels_ms(ch) for ch in e.cpu_children)

    def inside(e):
        p = e.cpu_parent
        while p is not None:
            if fragment in p.name:
                return True
            p = p.cpu_parent
        return False
    return sum(kernels_ms(e) for e in prof.events()
               if fragment in e.name and not str(e.device_type).endswith("CUDA")
               and not inside(e))


def wg_map_misses(torch):
    """Tensor-map cache misses of the wgmma GEMM so far (None where the
    library does not count them)."""
    from diffpure_tpu_torch.ops import _cuda

    fn = getattr(_cuda.lib(), "diffpure_wg_map_misses", None)
    if fn is None:
        return None
    fn.restype = ctypes.c_long
    return int(fn())


def host_us_bwd(torch, dev, dtype=None):
    """Host microseconds per backward wrapper call at batch 8 in ``dtype``
    (bf16 by default), timed as host_us_per_call times the forward's:
    ops/fused_resblock._launch_bwd and the public fused_resblock_bwd, back
    to back up to the last enqueue; beside them the CUDA-event ms per
    call."""
    from diffpure_tpu_torch.ops import fused_resblock as frb
    from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups

    dtype = dtype or torch.bfloat16
    out = {}
    for rs, H, c, cout in (("none", 4, 256, 256), ("none", 32, 128, 128)):
        params, x32, temb32, normal = block_inputs(torch, dev, 0, "fused_resblock", rs, H, c, 0,
                                                   cout)
        x, temb = x32.to(dtype), temb32.to(dtype)
        g = normal(N, H, H, cout).to(dtype)
        g1, g2 = ncsn_num_groups(c), ncsn_num_groups(cout)
        pk = frb.pack_resblock_params(params, dtype, dev)
        pkb = frb.pack_resblock_bwd_params(params, dtype, dev)
        calls = {
            "_launch_bwd": lambda: frb._launch_bwd(x, None, temb, g, pk, pkb, g1, g2, 1e-6,
                                                   True, rs),
            "fused_resblock_bwd": lambda: frb.fused_resblock_bwd(
                x, temb, params, g, num_groups1=g1, num_groups2=g2, resample=rs, packed=pk,
                packed_bwd=pkb)}
        for what, fn in calls.items():
            reps = 150
            ms = cuda_ms(torch, fn, reps=reps, warmup=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host = (time.perf_counter() - t0) / reps * 1e6
            torch.cuda.synchronize()
            out[f"{what} {H}x{H} {c}->{cout}"] = dict(host_us=host, cuda_event_ms=ms)
    return out


def grad_step_profile(torch, dev, score, clf, xg, yg, steps=GRAD_PROFILE_T):
    """A warm 'checkpoint' gradient of CE(DefendedModel) of ``steps`` steps
    at xg's batch, in the score model's dtype: the wall per step without
    the profiler and the tensor-map cache misses per step, then under the
    profiler the wall and device ms per step, the idle share, the device ms
    by kernel, and the attention blocks' plain autograd backward (the
    NCSN++'s only KernelFunction, #3)."""
    from torch.profiler import ProfilerActivity, profile
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.purify import PurifyConfig

    dmp = DefendedModel(score, clf, PurifyConfig(t=steps, grad_mode="checkpoint"), log_every=0)
    input_grad(torch, dmp, xg, yg, SEED + 5)
    torch.cuda.synchronize()
    miss0 = wg_map_misses(torch)
    t0 = time.time()
    input_grad(torch, dmp, xg, yg, SEED + 5)
    torch.cuda.synchronize()
    res = dict(wall_ms_per_step_unprofiled=(time.time() - t0) * 1e3 / steps)
    miss1 = wg_map_misses(torch)
    res["wg_map_misses_per_step"] = None if miss0 is None else (miss1 - miss0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        input_grad(torch, dmp, xg, yg, SEED + 5)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels, busy = [], 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if str(e.device_type).endswith("CUDA") and us > 0:
            kernels.append((e.key, us / 1e3 / steps, e.count / steps))
            busy += us / 1e3
    kernels.sort(key=lambda r: -r[1])
    res.update(wall_ms_per_step_profiled=wall_ms / steps, device_ms_per_step=busy / steps,
               idle_share=max(0.0, 1.0 - busy / wall_ms), top_kernels=kernels[:30],
               attn_bwd_ms_per_step=range_device_ms(prof, "KernelFunctionBackward") / steps)
    return res


def grad_step_parts(torch, dev, score, clf, xg, yg, step, census, dtype_name):
    """The gradient step's device ms by part, each measured on its own at
    xg's batch: two forward evaluations (the step and its recompute; #1/#2
    and #3 by chain step), one evaluation's backward of the blocks (#4/#5,
    by chain step: phase_bwd_kernels in one profiler session), the
    attention blocks' plain autograd backward (from ``step``,
    grad_step_profile's), the classifier's forward and backward (once per
    gradient), the rest."""
    n = xg.shape[0]
    log(f"== profile: one evaluation's backward (#4 + #5), batch {n}, {dtype_name}")
    recs = phase_bwd_kernels(torch, dev, census, n=n, dtypes=(dtype_name,), forbid=(),
                             plain_timing=False, one_session=True)
    per_eval = {"device_ms": 0.0, "steps": {}}
    for r in recs:
        per_eval["device_ms"] += r["device_ms"] * r["calls_per_eval"]
        for k, v in r["device_steps"].items():
            per_eval["steps"][k] = per_eval["steps"].get(k, 0.0) + v * r["calls_per_eval"]
    log(f"  #4 + #5 device {per_eval['device_ms']:.3f} ms per evaluation's backward")
    for k, v in sorted(per_eval["steps"].items(), key=lambda kv: -kv[1]):
        log(f"    chain step {k:40s} {v:8.3f} ms")
    fwd = profile_eval(torch, score, xg * 2 - 1, torch.full((n,), 99.9, device=dev))
    fwd_attn = fwd["chain_steps"].get("attention block (#3)", 0.0)
    fwd_blocks = sum(fwd["chain_steps"].values()) - fwd_attn

    def clf_grad():
        input_grad(torch, lambda x, noise: clf(x), xg, yg, 0)
    clf_ms = device_ms(torch, clf_grad, reps=5)["total"]
    parts = {"#1/#2 forward, twice (the step and its recompute)": 2 * fwd_blocks,
             "#3 attention forward, twice": 2 * fwd_attn,
             "#4/#5 backward": per_eval["device_ms"],
             "attention block backward (plain autograd)": step["attn_bwd_ms_per_step"],
             "classifier forward + backward (once per gradient)":
                 clf_ms / GRAD_PROFILE_T}
    parts["rest (the score model's plain ops, the solver's arithmetic, casts)"] = \
        step["device_ms_per_step"] - sum(parts.values())
    return dict(parts_ms_per_step=parts, bwd_per_eval=per_eval, bwd_shapes=recs,
                forward_eval=fwd, classifier_ms=clf_ms)


def log_grad_step(step, parts=None):
    log(f"  t*={GRAD_PROFILE_T}: wall {step['wall_ms_per_step_unprofiled']:.2f} ms per step; "
        f"under the profiler: wall {step['wall_ms_per_step_profiled']:.2f} ms, device "
        f"{step['device_ms_per_step']:.2f} ms per step, idle share {step['idle_share']:.3f}; "
        f"tensor-map cache misses per step {step['wg_map_misses_per_step']}")
    for label, ms in sorted((parts or {}).items(), key=lambda kv: -kv[1]):
        log(f"  {label:68s} {ms:8.3f} ms per step")
    for name, ms, calls in step["top_kernels"][:15]:
        log(f"  {ms:8.3f} ms x{calls:<6.1f} {name[:100]}")


def timed_grads(torch, score, clf, xg, yg):
    """Phase 5's 'checkpoint' gradient at t*=100 at xg's batch, cold and
    warm: wall seconds."""
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.purify import PurifyConfig

    dm = DefendedModel(score, clf, PurifyConfig(t=EVALS, grad_mode="checkpoint"), log_every=0)
    walls = {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.time()
        input_grad(torch, dm, xg, yg, SEED + 5)
        torch.cuda.synchronize()
        walls[run] = time.time() - t0
        log(f"  t*={EVALS} {run}: {walls[run]:.3f} s ({walls[run] / EVALS * 1e3:.1f} ms per "
            f"step, {xg.shape[0] / walls[run]:.3f} gradient-images/s)")
    return walls


def profile_grad_f32(torch, dev, smi, score, clf, census):
    """--profile-grad's fp32 leg (the run scripts' precision): phase 5's
    fp32 'checkpoint' gradient at batch GRAD_N timed cold and warm at
    t*=100, then at GRAD_N and F32_BIG_N (the run scripts' batch) a warm
    gradient of GRAD_PROFILE_T steps (grad_step_profile) and the step's
    device ms by part (grad_step_parts)."""
    import numpy as np

    score.dtype = torch.float32
    rng = np.random.default_rng(SEED + 13)
    res = {}
    for n in (GRAD_N, F32_BIG_N):
        xg = torch.from_numpy(rng.uniform(size=(n, 32, 32, 3)).astype(np.float32)).to(dev)
        yg = torch.from_numpy(rng.integers(0, 10, n)).to(dev)
        log(f"== profile: gradient of CE(DefendedModel), CIFAR NCSN++ fp32, batch {n}, "
            f"checkpoint, on {smi}")
        r = res[f"batch_{n}"] = {}
        if n == GRAD_N:
            r["wall_s"] = timed_grads(torch, score, clf, xg, yg)
        r["step"] = grad_step_profile(torch, dev, score, clf, xg, yg)
        r.update(grad_step_parts(torch, dev, score, clf, xg, yg, r["step"], census, "float32"))
        log_grad_step(r["step"], r["parts_ms_per_step"])
    score.dtype = torch.bfloat16
    return res


def profile_grad(torch, dev, smi):
    """--profile-grad: phase 5's gradient (CE of DefendedModel, CIFAR NCSN++
    bf16 + WRN-28-10, batch 16, 'checkpoint') timed cold and warm at
    t*=100, then a warm gradient of GRAD_PROFILE_T steps under the
    profiler: per step the device time by kernel and the idle share, and
    the step's parts, each measured on its own (grad_step_parts; #4/#5 by
    chain step also at batch 8); the tensor-map cache misses per step; the
    same in fp32 at batch 16 and 64 (profile_grad_f32); the host time per
    backward call in each dtype; the ImageNet step."""
    import numpy as np

    score, clf = build_models(torch, dev, torch.bfloat16)
    for m in (score, clf):
        m.requires_grad_(False)
    rng = np.random.default_rng(SEED + 12)
    xg = torch.from_numpy(rng.uniform(size=(GRAD_N, 32, 32, 3)).astype(np.float32)).to(dev)
    yg = torch.from_numpy(rng.integers(0, 10, GRAD_N)).to(dev)
    res = dict(card=smi, batch=GRAD_N, mode="checkpoint", profiled_steps=GRAD_PROFILE_T)
    log(f"== profile: gradient of CE(DefendedModel), CIFAR NCSN++ bf16, batch {GRAD_N}, "
        f"checkpoint, on {smi}")
    res["wall_s"] = timed_grads(torch, score, clf, xg, yg)
    step = grad_step_profile(torch, dev, score, clf, xg, yg)
    census = shape_census(torch, score, xg[:N] * 2 - 1)
    log(f"== profile: one evaluation's backward (#4 + #5), batch {N}, bf16")
    recs8 = phase_bwd_kernels(torch, dev, census, n=N, dtypes=("bfloat16",), forbid=(),
                              plain_timing=False, one_session=True)
    res["bwd_batch_8"] = bwd_per_eval(recs8, f"batch {N}")
    parts = grad_step_parts(torch, dev, score, clf, xg, yg, step, census, "bfloat16")
    res.update(step, wall_ms_per_step=res["wall_s"]["warm"] * 1e3 / EVALS, **parts)
    log_grad_step(step, parts["parts_ms_per_step"])
    res["fp32"] = profile_grad_f32(torch, dev, smi, score, clf, census)
    for tag, name, dtype in (("host_us", "bf16", torch.bfloat16),
                             ("fp32_host_us", "fp32", torch.float32)):
        res[tag] = host_us_bwd(torch, dev, dtype)
        for k, v in res[tag].items():
            log(f"  host {name} {k:36s} {v['host_us']:8.1f} us per call (CUDA events "
                f"{v['cuda_event_ms'] * 1e3:8.1f} us)")
    del score, clf
    res["imagenet"] = profile_adm_grad(torch, dev, smi)
    (OUT / "profile_grad.json").write_text(json.dumps(res, indent=1))


def imagenet_classifier(torch, dev, name="imagenet-resnet50"):
    import numpy as np
    from diffpure_tpu_torch.classifiers import get_classifier
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    clf = get_classifier(name).eval()
    clf.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                         seeded_normal_state_dict(clf, SEED + 11).items()})
    return clf.requires_grad_(False).to(dev)


def profile_adm_grad(torch, dev, smi):
    """--profile-grad's ImageNet step: phase 16's gradient (CE of
    DefendedModel(resize_to=256), bf16 ADM + ResNet-50, batch ADM_GRAD_N,
    'checkpoint') at GRAD_PROFILE_T steps, warm, under the profiler: per
    step the wall and device time, the idle share, the device time by
    kernel family and by part: the four kernels' forwards (the step and
    its recompute), their Functions' backward (autograd of the plain
    versions, recomputed), the classifier's forward and backward (once per
    gradient, timed on its own), the rest (the ADM's plain ops, the
    solver)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    adm, rn50 = build_adm(torch, dev), imagenet_classifier(torch, dev)
    rng = np.random.default_rng(SEED + 44)
    xg = torch.from_numpy(rng.uniform(size=(ADM_GRAD_N, 224, 224, 3)).astype(np.float32)).to(dev)
    yg = torch.from_numpy(rng.integers(0, 1000, ADM_GRAD_N)).to(dev)
    steps = GRAD_PROFILE_T
    log(f"== profile: gradient of CE(DefendedModel(resize_to=256)), bf16 ADM + ResNet-50, "
        f"batch {ADM_GRAD_N}, checkpoint, t*={steps}, on {smi}")
    dm = defended(torch, adm, rn50, steps, "checkpoint", True)
    input_grad(torch, dm, xg, yg, SEED + 45)
    torch.cuda.synchronize()
    t0 = time.time()
    input_grad(torch, dm, xg, yg, SEED + 45)
    torch.cuda.synchronize()
    res = dict(batch=ADM_GRAD_N, steps=steps,
               wall_ms_per_step_unprofiled=(time.time() - t0) * 1e3 / steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        input_grad(torch, dm, xg, yg, SEED + 45)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by, kernels, busy = {}, [], 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if str(e.device_type).endswith("CUDA") and us > 0:
            kernels.append((e.key, us / 1e3 / steps, e.count / steps))
            by[family(e.key)] = by.get(family(e.key), 0.0) + us / 1e3 / steps
            busy += us / 1e3
    kernels.sort(key=lambda r: -r[1])
    clf_ms = device_ms(torch, lambda: input_grad(torch, lambda x, noise: rn50(x), xg, yg, 0),
                       reps=5)["total"]
    parts = {"#6-#9 forward kernels (the step and its recompute)":
             sum(by.get(f, 0.0) for f in ADM_FAMILIES),
             "#6-#9 backward (autograd of the plain versions, recomputed)":
             range_device_ms(prof, "KernelFunctionBackward") / steps,
             "classifier forward + backward (once per gradient)": clf_ms / steps}
    parts["rest (the ADM's plain ops, the solver's arithmetic, casts)"] = \
        busy / steps - sum(parts.values())
    res.update(wall_ms_per_step=wall_ms / steps, device_ms_per_step=busy / steps,
               idle_share=max(0.0, 1.0 - busy / wall_ms), parts_ms_per_step=parts,
               by_family_ms_per_step=by, top_kernels=kernels[:30], classifier_ms=clf_ms)
    log(f"  wall {res['wall_ms_per_step_unprofiled']:.2f} ms per step; under the profiler: "
        f"wall {wall_ms / steps:.2f} ms, device {busy / steps:.2f} ms per step, idle share "
        f"{res['idle_share']:.3f}")
    for label, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        log(f"  {label:68s} {ms:8.3f} ms per step")
    for fam, ms in sorted(by.items(), key=lambda kv: -kv[1]):
        log(f"  family {fam:61s} {ms:8.3f} ms per step")
    for name, ms, calls in kernels[:15]:
        log(f"  {ms:8.3f} ms x{calls:<6.1f} {name[:100]}")
    return res


def build_ddpm(torch, dev):
    """The full-width score_sde DDPM (fp32) from the model registry, with
    seeded random-normal weights, built on the meta device."""
    from diffpure_tpu_torch.models.registry import create_model
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    with torch.device("meta"):
        ddpm = create_model("ddpm")
    sd = seeded_normal_state_dict(ddpm, SEED + 20)
    ddpm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, assign=True)
    n_params = sum(p.numel() for p in ddpm.parameters())
    if n_params != DDPM_PARAMS:
        raise AssertionError(f"DDPM has {n_params} params, expected {DDPM_PARAMS}")
    return ddpm.eval().requires_grad_(False).to(dev)


def ddpm_census(torch, ddpm, x):
    """(H, C) -> calls over one DDPM evaluation at x's batch, of GNSiLU (#10)
    and of the attention block (#3), from forward pre-hooks; and the
    evaluation's FLOPs: the convs and matmuls PyTorch runs, as
    FlopCounterMode counts them, plus the attention blocks' (block_cost)."""
    from collections import Counter
    from torch.utils.flop_counter import FlopCounterMode
    from diffpure_tpu_torch.models.layers import AttnBlockpp, GNSiLU

    gn, attn = Counter(), Counter()

    def hook(mod, args):
        h = args[0]
        (attn if isinstance(mod, AttnBlockpp) else gn)[(h.shape[1], h.shape[3])] += 1

    handles = [m.register_forward_pre_hook(hook) for m in ddpm.modules()
               if isinstance(m, (GNSiLU, AttnBlockpp))]
    try:
        with torch.inference_mode(), FlopCounterMode(display=False) as counter:
            ddpm(x, torch.full((x.shape[0],), 99.9, device=x.device))
    finally:
        for h in handles:
            h.remove()
    flops = counter.get_total_flops() + sum(
        n * block_cost("fused_attnblock", "none", H, C, 0, C, x.shape[0], 4)[0]
        for (H, C), n in attn.items())
    return dict(gn), dict(attn), flops


def gn_yardstick(torch, x, scale, bias, groups):
    """F.silu(F.group_norm(.)) on the NCHW view of the NHWC map, in its
    dtype: #10's yardstick (two PyTorch calls, on no path of the port), as
    a function whose output is NHWC."""
    import torch.nn.functional as F

    xc = x.permute(0, 3, 1, 2)
    s, b = scale.to(x.dtype), bias.to(x.dtype)
    return lambda: F.silu(F.group_norm(xc, groups, s, b, 1e-6)).permute(0, 2, 3, 1)


def phase_gn_act_kernels(torch, dev, gn_shapes):
    """#10 at every (H, C) of the DDPM census, batch N, and at
    GN_OFF_CENSUS, each against its plain version on the card, bf16 and
    fp32; per-shape records with kernel (CUDA events), device (profiler,
    back-to-back calls, every case in one session) and plain times, the
    bound, the launched kernels' names, its plan's route and the yardstick
    F.silu(F.group_norm(.)) (gn_yardstick). It computes in fp32 (FMA units)
    whatever the dtype, ~10 operations per element (sum, squared deviation,
    normalise, affine, SiLU). A #10 call that launches a kernel of
    OLD_GN_KERNELS fails, and so does a shape off the census whose kernel
    is not the L2 route's (GN_L2_FRAGMENT). Then #11 (phase_flr_kernels);
    returns the records of both."""
    import numpy as np
    from diffpure_tpu_torch.ops import fused_act, groupnorm

    cases = [((N, H, H, C), calls) for (H, C), calls in sorted(gn_shapes.items())]
    cases += [(shape, 0) for shape in GN_OFF_CENSUS]
    records, timed = [], []
    for i, (shape, calls) in enumerate(cases):
        rng = np.random.default_rng(3000 + i)
        C = shape[-1]
        x32 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 2 + 0.5).to(dev)
        s = torch.from_numpy(1 + 0.1 * rng.standard_normal(C).astype(np.float32)).to(dev)
        b = torch.from_numpy(0.1 * rng.standard_normal(C).astype(np.float32)).to(dev)
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            esize = 2 if dtype_name == "bfloat16" else 4
            x = x32.to(dtype)
            elems = x.numel()
            kern = functools.partial(groupnorm.group_norm_silu_fused, x, s, b, 32, 1e-6)
            plain = functools.partial(groupnorm.group_norm_silu_fused_reference,
                                      x, s, b, 32, 1e-6)
            yard = gn_yardstick(torch, x, s, b, 32)
            flops, nbytes = 10 * elems, 2 * elems * esize + 2 * C * 4
            with torch.inference_mode():
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                ygot = yard()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            ok = bool(torch.isfinite(got.float()).all()) and got.dtype == dtype \
                and err <= REL[dtype_name] * scale
            t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES
            rec = dict(kernel="group_norm_silu_fused", shape=list(shape), bias=True,
                       calls_per_eval=calls, dtype=dtype_name, max_abs_err=err,
                       rel_err=err / scale, rel_tol=REL[dtype_name],
                       ms=cuda_ms(torch, kern, 50, 5), plain_ms=cuda_ms(torch, plain, 50, 5),
                       library_ms=None, flops=flops, bytes=nbytes,
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes", ok=ok,
                       yardstick_ms=cuda_ms(torch, yard, 50, 5),
                       yardstick_rel_err=float((ygot.float() - want.float()).abs().max())
                       / scale,
                       route=groupnorm.gn_silu_plan(shape[0], shape[1] * shape[2], C, 32,
                                                    dtype).route)
            records.append(rec)
            timed.append((rec, kern, yard))
    # the kernels' and the yardsticks' device time, all in one session
    fns = [f for _, kern, yard in timed for f in (kern, yard)]
    with torch.inference_mode():
        dev_times = iter(device_ms_many(torch, fns))
    for rec, kern, yard in timed:
        rec["device_ms"], rec["device_kernels"] = next(dev_times)
        rec["yardstick_device_ms"] = next(dev_times)[0]
        names = rec["device_kernels"]
        line = ""
        if any(f in k for k in names for f in OLD_GN_KERNELS) or (
                rec["calls_per_eval"] == 0 and not any(GN_L2_FRAGMENT in k for k in names)):
            rec["ok"] = False
            line = f" KERNELS {names}"
        log(f"  {rec['kernel']:21s} {str(tuple(rec['shape'])):18s} "
            f"x{rec['calls_per_eval']:<2d} {rec['dtype']:8s} rel err {rec['rel_err']:.2e} <= "
            f"{rec['rel_tol']:.0e} kernel {rec['ms']:.4f} ms device "
            f"{rec['device_ms'] * 1e3:.2f} us plain {rec['plain_ms']:.4f} ms bound "
            f"{rec['bound_ms'] * 1e3:.2f} us yardstick device "
            f"{rec['yardstick_device_ms'] * 1e3:.2f} us {rec['route']}{line} "
            f"{'ok' if rec['ok'] else 'FAIL'}")
    for dtype_name in ("float32", "bfloat16"):
        mine = [r for r in records if r["dtype"] == dtype_name and r["calls_per_eval"]]
        log(f"  group_norm_silu_fused {dtype_name}: device "
            f"{sum(r['device_ms'] * r['calls_per_eval'] for r in mine):.4f} ms, bound "
            f"{sum(r['bound_ms'] * r['calls_per_eval'] for r in mine):.4f} ms per DDPM "
            f"evaluation (batch 8)")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} GroupNorm+SiLU checks failed: {bad}")
    return records + phase_flr_kernels(torch, dev, fused_act)


# #11's yardstick's slope and gain; its back-to-back device-time
# repetitions; and past L2 (steady_device_ms) the rounds timed a case, the
# bytes that a case's rotating input copies and their outputs span at least
# (three times the 50 MB L2) and the spin that lets the host queue a case's
# calls before the card runs them (cycles: ≈ 20 ms)
FLR_SLOPE, FLR_GAIN = 0.2, 2.0 ** 0.5
FLR_REPS, FLR_STEADY_ROUNDS = 20, 21
FLR_SPAN_BYTES = 150 << 20
FLR_SPIN_CYCLES = 40_000_000


def flr_inputs(torch, dev, i, shape, dtype):
    """Seeded x (normal, 2 x + 0.5) and bias (0.5 x normal) for #11's i-th
    case, made on the card (the largest is 67 M elements)."""
    g = torch.Generator(device=dev).manual_seed(3100 + i)
    x = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
    b = torch.randn(shape[-1], generator=g, device=dev) * 0.5
    return x.to(dtype), b.to(dtype)


def steady_device_ms(torch, cases, rounds=FLR_STEADY_ROUNDS):
    """The device time per call (ms) of each of ``cases`` in steady state
    past L2. A case is a list of functions, one per copy of its inputs, the
    copies and their outputs spanning FLR_SPAN_BYTES or more; a round calls
    each once, in turn, and holds each output until its slot comes round
    again. So no call finds its operands or its output's lines in L2, and
    each writes back, inside its own time, the dirty lines that the call
    before it left, as it leaves its own. ``rounds`` rounds a case, queued
    behind a spin kernel so that the card runs them back to back (fails if
    the spin ended before the host had queued them); CUDA events around
    all but the first round, which starts from another state. The time
    holds the card's gap between two queued launches (the launch floor is
    timed alike, flr_records); the profiler is not used, since late in a
    run its sessions drop kernels."""
    out = []
    for case in cases:
        held = [None] * len(case)
        start, end, spun = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        for _ in range(2):  # the allocator's blocks, so no cudaMalloc waits on the spin
            for j, f in enumerate(case):
                held[j] = f()
        torch.cuda.synchronize()
        torch.cuda._sleep(FLR_SPIN_CYCLES)
        spun.record()
        for r in range(rounds):
            if r == 1:
                start.record()
            for j, f in enumerate(case):
                held[j] = f()
        end.record()
        if spun.query():
            raise AssertionError("the spin ended before the host had queued the calls")
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / ((rounds - 1) * len(case)))
        del held
    return out


def flr_records(torch, dev, fa):
    """#11 (``fa.fused_leaky_relu``, the module of any tree of the repo:
    scripts/torch_flr_compare.py times a parent's too) against its plain
    version on the card at every shape of FLR_CASES and FLR_LARGE, bf16 and
    fp32, with and without a bias (fp32 bit for bit, recorded): per case
    CUDA-event ms, device ms back to back, plain ms, the bound, and the
    yardstick F.leaky_relu(x + b, slope) * scale (three PyTorch calls, on
    no path) timed alike; at FLR_LARGE also both in steady state past L2
    (steady_device_ms), beside a copy of x (x.clone(): the card's own
    copy, which moves the same bytes, as a ceiling). GB/s and the share of
    the bound from the steady state past L2, else back to back. A last
    record holds the launch floor (a 1-element call), back to back and
    queued as past L2. Fails if a case disagrees with the plain version."""
    import torch.nn.functional as F

    shapes = list(dict.fromkeys([s for s, _ in FLR_CASES] + list(FLR_LARGE)))
    kern_fn = lambda x, b: functools.partial(fa.fused_leaky_relu, x, b)  # noqa: E731
    yard_fn = lambda x, b: (lambda: F.leaky_relu(x if b is None else x + b,  # noqa: E731
                                                 FLR_SLOPE) * FLR_GAIN)
    records, timed, steady = [], [], []
    for i, shape in enumerate(shapes):
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            esize = 2 if dtype_name == "bfloat16" else 4
            x, b0 = flr_inputs(torch, dev, i, shape, dtype)
            large = tuple(shape) in FLR_LARGE
            # copies of x whose calls span FLR_SPAN_BYTES with their outputs
            copies = [x] + [x.clone() for _ in range(
                -(-FLR_SPAN_BYTES // (2 * x.numel() * esize)) - 1 if large else 0)]
            for with_bias in (True, False):
                b = b0 if with_bias else None
                C, elems = shape[-1], x.numel()
                kern, yard = kern_fn(x, b), yard_fn(x, b)
                plain = functools.partial(fa.fused_leaky_relu_reference, x, b)
                with torch.inference_mode():
                    got = kern()
                    torch.cuda.synchronize()
                    want = plain()
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                flops = 3 * elems
                nbytes = 2 * elems * esize + (C * esize if with_bias else 0)
                t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES
                rec = dict(kernel="fused_leaky_relu", shape=list(shape), bias=with_bias,
                           calls_per_eval=0, dtype=dtype_name,
                           toy=(tuple(shape), with_bias) in FLR_CASES, large=large,
                           max_abs_err=err, rel_err=err / scale, rel_tol=REL[dtype_name],
                           bitwise=bool(torch.equal(got, want)),
                           ms=cuda_ms(torch, kern, 50, 5), plain_ms=cuda_ms(torch, plain, 20, 3),
                           yardstick_ms=cuda_ms(torch, yard, 20, 3), library_ms=None,
                           flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
                           bound_by="operations" if t_ops >= t_bytes else "bytes",
                           ok=bool(torch.isfinite(got.float()).all()) and got.dtype == dtype
                           and err <= REL[dtype_name] * scale)
                del got, want
                records.append(rec)
                timed.append((rec, kern, yard))
                if large:
                    steady.append((rec, [kern_fn(c, b) for c in copies],
                                   [yard_fn(c, b) for c in copies],
                                   [c.clone for c in copies]))
            del copies
    # the launch floor: one element (and its bias)
    one, one_b = flr_inputs(torch, dev, len(shapes), (1,), torch.float32)
    floor = kern_fn(one, one_b)
    fns = [f for _, kern, yard in timed for f in (kern, yard)] + [floor]
    with torch.inference_mode():
        dev_times = device_ms_many(torch, fns, FLR_REPS)
        steady_ms = steady_device_ms(torch, [c for _, *cases in steady for c in cases])
        floor_rec = dict(kernel="fused_leaky_relu_floor", shape=[1],
                         ms=cuda_ms(torch, floor, 50, 5), device_ms=dev_times[-1][0],
                         queued_ms=steady_device_ms(torch, [[floor]])[0])
    for j, (rec, _, _) in enumerate(timed):
        rec["device_ms"], rec["device_kernels"] = dev_times[2 * j]
        rec["yardstick_device_ms"] = dev_times[2 * j + 1][0]
    for j, (rec, *_) in enumerate(steady):
        rec["steady_device_ms"], rec["yardstick_steady_device_ms"], \
            rec["copy_steady_device_ms"] = steady_ms[3 * j:3 * j + 3]
    for rec in records:
        t = rec["steady_device_ms"] if rec["large"] else rec["device_ms"]
        rec["gb_s"] = rec["bytes"] / t / 1e6
        rec["share"] = rec["bound_ms"] / t
        past = (f", steady past L2 {rec['steady_device_ms'] * 1e3:.2f} us" if rec["large"]
                else "")
        ypast = (f", steady {rec['yardstick_steady_device_ms'] * 1e3:.2f} us; x.clone() "
                 f"steady {rec['copy_steady_device_ms'] * 1e3:.2f} us" if rec["large"] else "")
        log(f"  fused_leaky_relu {str(tuple(rec['shape'])):18s} "
            f"{'bias' if rec['bias'] else 'none':4s} {rec['dtype']:8s} rel err "
            f"{rec['rel_err']:.2e}{' (bitwise)' if rec['bitwise'] else ''} kernel "
            f"{rec['ms'] * 1e3:.2f} us device {rec['device_ms'] * 1e3:.2f} us{past} "
            f"({rec['gb_s']:.0f} GB/s, {rec['share']:.2f} of the bound "
            f"{rec['bound_ms'] * 1e3:.2f} us) plain {rec['plain_ms'] * 1e3:.2f} us yardstick "
            f"device {rec['yardstick_device_ms'] * 1e3:.2f} us{ypast} "
            f"{'ok' if rec['ok'] else 'FAIL'}")
    log(f"  fused_leaky_relu launch floor (1 element): kernel {floor_rec['ms'] * 1e3:.2f} us, "
        f"device {floor_rec['device_ms'] * 1e3:.2f} us, queued as past L2 "
        f"{floor_rec['queued_ms'] * 1e3:.2f} us")
    for dtype_name in ("float32", "bfloat16"):
        toys = [r for r in records if r["toy"] and r["dtype"] == dtype_name]
        log(f"  fused_leaky_relu {dtype_name}: the six FLR_CASES device "
            f"{sum(r['device_ms'] for r in toys) * 1e3:.2f} us, bound "
            f"{sum(r['bound_ms'] for r in toys) * 1e3:.2f} us (6 x the floor "
            f"{6 * floor_rec['device_ms'] * 1e3:.2f} us)")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} fused bias + leaky ReLU checks failed: {bad}")
    return records + [floor_rec]


def phase_flr_kernels(torch, dev, fa):
    """Phase 2d's #11 part: flr_records, each case's route (fa.flr_plan)
    and the gradient on the card, the kernel route against the plain one
    (flr_grad_checks); returns the records and one of the gradient
    checks."""
    records = flr_records(torch, dev, fa)
    for rec in records[:-1]:
        rec["route"] = fa.flr_plan(tuple(rec["shape"]), getattr(torch, rec["dtype"])).route
    log("  fused_leaky_relu routes: " + ", ".join(
        f"{tuple(r['shape'])} {r['dtype']} {r['route']}" for r in records[:-1] if r["bias"]))
    grad = flr_grad_checks(torch, dev, fa)
    for g in grad:
        log(f"  fused_leaky_relu gradient {str(tuple(g['shape'])):18s} {g['dtype']:8s} kernel "
            f"route against plain: dx {g['dx_rel']:.2e} dbias {g['db_rel']:.2e} <= "
            f"{g['rel_tol']:.0e}, launches {g['launches']} {'ok' if g['ok'] else 'FAIL'}")
    bad = [g for g in grad if not g["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} fused bias + leaky ReLU gradient checks failed: {bad}")
    return records + [dict(kernel="fused_leaky_relu_grad", grad=grad)]


def flr_grad_checks(torch, dev, fa):
    """The gradient of sum(w * fused_leaky_relu(x, bias)) in x and bias
    through the kernel route (one kernel launch, the closed-form backward)
    against autograd of the plain version, on the card, bf16 and fp32:
    max abs error <= REL x max |plain|."""
    from diffpure_tpu_torch.ops import launch_counts

    checks = []
    for i, shape in enumerate(((N, 16, 16, 256), (7, 9, 11, 13))):
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            x0, b0 = flr_inputs(torch, dev, 50 + i, shape, dtype)
            w = flr_inputs(torch, dev, 60 + i, shape, dtype)[0]
            grads = []
            for fn in (fa.fused_leaky_relu, fa.fused_leaky_relu_reference):
                x, b = x0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
                before = launch_counts()["fused_leaky_relu"]
                loss = (fn(x, b, FLR_SLOPE, FLR_GAIN) * w).float().sum()
                grads.append((*torch.autograd.grad(loss, (x, b)),
                              launch_counts()["fused_leaky_relu"] - before))
            (kx, kb, launches), (px, pb, _) = grads
            dx = float((kx.float() - px.float()).abs().max()) / float(px.float().abs().max())
            db = float((kb.float() - pb.float()).abs().max()) / float(pb.float().abs().max())
            checks.append(dict(shape=list(shape), dtype=dtype_name, dx_rel=dx, db_rel=db,
                               rel_tol=REL[dtype_name], launches=launches,
                               ok=max(dx, db) <= REL[dtype_name] and launches == 1))
    return checks


def input_grad(torch, model, x01, y, noise):
    """d/dx of the summed cross-entropy of model(x01, noise) (the APGD-CE
    objective); returns (gradient, logits)."""
    from diffpure_tpu_torch.attacks.losses import ce_loss

    x = x01.detach().clone().requires_grad_(True)
    logits = model(x, noise)
    (gx,) = torch.autograd.grad(ce_loss(logits.float(), y).sum(), x)
    return gx, logits.detach()


def purify_grad(torch, dm, x01, w, noise):
    """d/dx of sum(w * dm.purify(x01, noise))."""
    x = x01.detach().clone().requires_grad_(True)
    (gx,) = torch.autograd.grad((w.to(x.device) * dm.purify(x, noise)).sum(), x)
    return gx


def purify_grads(torch, score, x, w, dtypes):
    """Phase 6's gradients on the device of ``x``: purify_grad at t*=5 in
    each of ``dtypes``, each GRAD_MODES mode, the same noise; {(dtype,
    mode): gradient on the CPU}. Leaves ``score`` bf16."""
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.purify import PurifyConfig

    out = {}
    for dtype_name, dtype in dtypes:
        score.dtype = dtype
        for m in GRAD_MODES:
            dm = DefendedModel(score, None, PurifyConfig(t=5, grad_mode=m), log_every=0)
            out[dtype_name, m] = purify_grad(torch, dm, x, w, FixedNoise(SEED + 6)).cpu()
    score.dtype = torch.bfloat16
    return out


def check_purify_grads(torch, got, plain):
    """Phase 6's checks: each of the card's gradients (``got``, fp32 and
    bf16) against the CPU's plain fp32 one (``plain``) at GRAD_REL; the
    card's bf16 gradient's gap to its fp32 one is recorded beside it."""
    checks = {}
    for (dtype_name, m), g in got.items():
        want = plain["float32", m]
        err, scale = float((g - want).abs().max()), float(want.abs().max())
        ok = bool(torch.isfinite(g).all()) and err <= GRAD_REL[dtype_name] * scale
        rec = dict(max_abs_err=err, rel_err=err / scale, rel_tol=GRAD_REL[dtype_name], ok=ok)
        if dtype_name == "bfloat16":  # the card's bf16 gradient against its fp32 one
            ref = got["float32", m]
            rec["card_gap"] = float((g - ref).abs().max() / ref.abs().max())
        checks[f"{dtype_name}/{m}"] = rec
        log(f"  {dtype_name:8s} {m:10s}: max |kernel - plain fp32| {err:.3e} (rel "
            f"{err / scale:.2e} <= {GRAD_REL[dtype_name]:.1e}) "
            f"{'ok' if ok else 'FAIL'}" + (f"; card bf16 vs card fp32 {rec['card_gap']:.2e}"
                                           if "card_gap" in rec else ""))
        if not ok:
            raise AssertionError(f"gradient {dtype_name}/{m}: kernel and plain disagree")
    return checks


def adm_outputs(torch, adm, x, t, xp, cfg, dtypes):
    """Phase 9's outputs on the device of ``x``: one evaluation of ``adm``
    at (x, t) in each of ``dtypes``, and the fp32 purification of ``xp``
    under ``cfg`` with FixedNoise(SEED + 13); on the CPU. Leaves ``adm``
    bf16."""
    from diffpure_tpu_torch.eval import DefendedModel

    out = {}
    with torch.inference_mode():
        for dtype_name, dtype in dtypes:
            adm.dtype = dtype
            out[dtype_name] = adm(x, t).float().cpu()
        adm.dtype = torch.float32
        out["purify"] = DefendedModel(adm, None, cfg, log_every=0).purify(
            xp, FixedNoise(SEED + 13)).cpu()
    adm.dtype = torch.bfloat16
    return out


def check_adm_outputs(torch, card9, cpu9):
    """Phase 9's checks: the card's evaluation in fp32 and bf16 against the
    CPU's fp32 one (ADM_EVAL_REL), its purification against the CPU's
    (ADM_PURIFY_REL)."""
    checks = {}
    for what, ref, bound in (("float32", "float32", ADM_EVAL_REL["float32"]),
                             ("bfloat16", "float32", ADM_EVAL_REL["bfloat16"]),
                             ("purify", "purify", ADM_PURIFY_REL)):
        got, want = card9[what], cpu9[ref]
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= bound * scale
        checks[what] = dict(max_abs_err=err, rel_err=err / scale, rel_tol=bound, ok=ok)
        log(f"  {what:8s}: max |card - cpu{' fp32' if what == 'bfloat16' else ''}| "
            f"{err:.3e} (rel {err / scale:.2e} <= {bound:.0e}) {'ok' if ok else 'FAIL'}")
    bad = [k for k, v in checks.items() if isinstance(v, dict) and not v["ok"]]
    if bad:
        raise AssertionError(f"ImageNet card against CPU: {bad} disagree")
    return checks


class CpuSide:
    """The CPU's side of the card-against-CPU checks, computed in a thread
    of its own while the main thread drives the card (PyTorch's CPU
    operators release the GIL). A job works on CPU copies of the models
    (``copy``) and on inputs made before it is submitted, so it shares no
    module with the card's phases, and the NFE ledger is per thread, so
    its purifications land in no ledger of the main thread's. Jobs run one
    at a time, in the order submitted, on two intra-op threads fewer than
    torch's default, which leaves the main thread a core. No job calls what
    a phase patches (phase 20(c)'s reversible solver is patched before
    phase 20's job is submitted; phase 22's grid_sample is in no job), and
    none reads a counter of the main thread's. ``result`` joins a job; its
    check then runs in the main thread."""

    def __init__(self, torch):
        from concurrent.futures import ThreadPoolExecutor

        self.torch = torch
        self.threads = max(1, torch.get_num_threads() - 2)
        self.pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="cpu_side")
        self.models = {}
        self.seconds = {}

    def copy(self, name, model):
        """The CPU copy of ``model`` kept under ``name`` (made at the first
        call, from the model as it is then)."""
        if name not in self.models:
            self.models[name] = copy.deepcopy(model).cpu()
        return self.models[name]

    def submit(self, name, fn):
        def job():
            self.torch.set_num_threads(self.threads)
            t0 = time.time()
            try:
                return fn()
            finally:
                self.seconds[name] = time.time() - t0

        return name, self.pool.submit(job)

    def result(self, handle):
        name, future = handle
        t0 = time.time()
        out = future.result()
        log(f"  the CPU's side of {name}: {self.seconds[name]:.1f} s in its thread "
            f"({self.threads} intra-op threads), {time.time() - t0:.1f} s waited for here")
        return out

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


def build_models(torch, dev, dtype):
    import numpy as np
    from diffpure_tpu_torch.classifiers import get_classifier
    from diffpure_tpu_torch.config import load_config
    from diffpure_tpu_torch.models import ncsnpp_from_config
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    score = ncsnpp_from_config(load_config(str(REPO / "configs" / "cifar10.yml")),
                               dtype=dtype).eval()
    n_params = sum(p.numel() for p in score.parameters())
    if n_params != CIFAR_PARAMS:
        raise AssertionError(f"NCSN++ has {n_params} params, expected {CIFAR_PARAMS}")
    clf = get_classifier("cifar10-wideresnet-28-10").eval()
    for m, seed in ((score, SEED), (clf, SEED + 1)):
        sd = seeded_normal_state_dict(m, seed)
        m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
        m.to(dev)
    return score, clf


def shape_census(torch, score, x):
    """(kernel, resample, H, c1, c2, cout) -> calls, over one evaluation of
    the score model, from forward pre-hooks on its blocks; H is the block's
    input size. For the CIFAR NCSN++ these are 19 shapes."""
    from collections import Counter
    from diffpure_tpu_torch.models.layers import AttnBlockpp, ResnetBlockBigGANpp

    seen = Counter()

    def hook(mod, args):
        h = args[0]
        if isinstance(mod, AttnBlockpp):
            seen[("fused_attnblock", "none", h.shape[1], h.shape[3], 0, h.shape[3])] += 1
            return
        cout = mod.Conv_0.out_channels
        if isinstance(h, tuple) and mod.has_proj and mod.resample == "none":
            seen[("fused_resblock_cat", "none", h[0].shape[1], h[0].shape[3],
                  h[1].shape[3], cout)] += 1
        else:
            c = sum(t.shape[3] for t in h) if isinstance(h, tuple) else h.shape[3]
            H = (h[0] if isinstance(h, tuple) else h).shape[1]
            seen[("fused_resblock", mod.resample, H, c, 0, cout)] += 1

    handles = [m.register_forward_pre_hook(hook) for m in score.modules()
               if isinstance(m, (AttnBlockpp, ResnetBlockBigGANpp))]
    try:
        with torch.inference_mode():
            score(x, torch.full((x.shape[0],), 99.9, device=x.device))
    finally:
        for h in handles:
            h.remove()
    return dict(seen)


class FixedNoise:
    """Seeded noise drawn once on the CPU and served on any device, so the
    kernel run and the plain run purify with the same numbers."""

    def __init__(self, seed):
        from diffpure_tpu_torch.purify import SeededNoise
        self.src = SeededNoise(seed)

    def forward_eps(self, it, shape, like):
        return self.src.forward_eps(it, shape, like.cpu()).to(like.device)

    def brownian(self, it, i, like, dt):
        return self.src.brownian(it, i, like.cpu(), dt).to(like.device)


class FixedDiscreteNoise:
    """The discrete loops' seeded draws (DiscreteNoise), made once on the CPU
    and served on any device."""

    def __init__(self, seed):
        from diffpure_tpu_torch.purify import DiscreteNoise
        self.src = DiscreteNoise(seed)

    def forward_eps(self, it, shape, like):
        return self.src.forward_eps(it, shape, like.cpu().float()).to(like.device, like.dtype)

    def step_eps(self, it, i, like):
        return self.src.step_eps(it, i, like.cpu().float()).to(like.device, like.dtype)


def expected_counts(per_eval_scale):
    """Launch counts of a run of ``per_eval_scale`` CIFAR NCSN++ score
    evaluations with no gradient: 40 / 36 / 10 each, every other kernel 0."""
    return {**{k: v[2] * per_eval_scale for k, v in KERNELS.items()},
            **{k: 0 for k in (*BWD_KERNELS, *ADM_KERNELS, *DDPM_KERNELS)}}


def phase_bpda(torch, score, clf, x, smi):
    """Phase 12: BPDA+EOT (eval_bpda) through the main path's bf16 defence,
    then one PGD step with the attack reps one a call (the chunked seeds
    7000 + r). The labels are the defence's own vote (timed: the vote's
    purified images per second), so every example starts defended. Fails
    unless x_adv lies in the eps-ball and in [0, 1], class_batch has the
    shape (steps + 2, batch) and never turns from false to true, and the
    launch counters read 40 / 36 / 10 x the NFE ledger's total (the
    backward kernels 0: BPDA cuts the purifier's gradient)."""
    from diffpure_tpu_torch.attacks import BPDAEOTConfig, bpda_eot_attack, defense_predict
    from diffpure_tpu_torch.eval import DefendedModel, eval_bpda
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import PurifyConfig
    from diffpure_tpu_torch.utils.prng import fold_in
    from diffpure_tpu_torch.utils.profiling import count_nfe

    score.dtype = torch.bfloat16
    dm = DefendedModel(score, clf, PurifyConfig(t=BPDA_T, grad_mode="none"), log_every=0)
    cfg = BPDAEOTConfig(**BPDA_CFG)
    n = x.shape[0]
    torch.cuda.synchronize()
    t0 = time.time()
    with count_nfe() as vote_nfe:
        y = defense_predict(dm.purify, dm.classify, x, fold_in(SEED + 30, 10_000), cfg)
    torch.cuda.synchronize()
    vote_s = time.time() - t0
    images = cfg.eot_defense_reps * n
    log(f"  the defence vote: {vote_s:.3f} s, NFE {vote_nfe.total()}, "
        f"{images / vote_s:.3f} purified images/s on {smi}")
    runs = dict(vote=dict(wall_s=vote_s, nfe=vote_nfe.total(),
                          purified_images_per_s=images / vote_s))

    def check(tag, x_adv, class_batch, steps, nfe, counts):
        dist = float((x_adv - x).abs().max())
        log(f"  {tag}: max |x_adv - x| {dist:.5f} <= eps {cfg.adv_eps:.5f}; defended per "
            f"step {class_batch.sum(1).tolist()}; {nfe.report()}; launches {counts}")
        if tuple(x_adv.shape) != tuple(x.shape) or not bool(torch.isfinite(x_adv).all()) \
                or dist > cfg.adv_eps + 1e-6 or float(x_adv.min()) < 0 \
                or float(x_adv.max()) > 1:
            raise AssertionError(f"{tag}: x_adv leaves the eps-ball or [0, 1]")
        if class_batch.shape != (steps + 2, n) or bool(
                (class_batch[1:] & ~class_batch[:-1]).any()):
            raise AssertionError(f"{tag}: class_batch {class_batch.astype(int).tolist()} has "
                                 f"the wrong shape or turns from false to true")
        want = expected_counts(nfe.total())
        if nfe.total() <= 0 or counts != want:
            raise AssertionError(f"{tag}: launch counts {counts} != 40/36/10 x the NFE "
                                 f"ledger's {nfe.total()}: {want}")

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    with count_nfe() as nfe:
        res = eval_bpda(dm, x, y, SEED + 30, cfg, log=lambda s: log(f"  {s}"))
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    check("eval_bpda", res["x_adv"], res["class_batch"], cfg.adv_steps, nfe, counts)
    log(f"  eval_bpda: {wall:.3f} s on {smi}; init / robust accuracy {res['init_acc']:.3f} / "
        f"{res['robust_acc']:.3f} (random weights: these numbers mean nothing)")
    runs["eval_bpda"] = dict(wall_s=wall, nfe=dict(nfe.counts), counts=counts,
                             class_batch=res["class_batch"].astype(int).tolist())

    cfg1 = BPDAEOTConfig(**{**BPDA_CFG, "adv_steps": 1, "attack_batch": 1})
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    with count_nfe() as nfe:
        x_adv, class_batch = bpda_eot_attack(dm.purify, dm.classify, x, y, SEED + 31, cfg1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    check("one PGD step, attack reps one a call", x_adv, class_batch, 1, nfe, counts)
    runs["chunked"] = dict(wall_s=wall, nfe=dict(nfe.counts), counts=counts)

    # Flip verification (tests/test_torch_bpda.py::test_bpda_flips_are_verified's
    # construction over the card's defence): the attack reps' purifications
    # (calls of eot_attack_reps x n images) answer with a probe image the
    # classifier puts in another class than some label, the defence vote's
    # (calls of defense_batch x n) with the purified images, so flip
    # candidates appear and the fold_in(k_step, 555) vote verifies them
    # through the kernels.
    probes = [torch.full_like(x[:1], v) for v in (0.0, 0.5, 1.0)] + [
        torch.rand(x[:1].shape, generator=torch.Generator().manual_seed(SEED + 32 + i)
                   ).to(x.device) for i in range(5)]
    with torch.no_grad():
        probe = next((p for p in probes if bool((clf(p).argmax(-1) != y).any())), None)
    if probe is None:
        raise AssertionError("no probe image is classified off the labels: the flip "
                             "verification cannot be driven")
    attack_call = cfg.eot_attack_reps * n

    def flipping(xx, seed):
        out = dm.purify(xx, seed)
        return out * 0 + probe if xx.shape[0] == attack_call else out

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    with count_nfe() as nfe:
        x_adv, class_batch = bpda_eot_attack(flipping, dm.classify, x, y, SEED + 33, cfg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    check("flip verification", x_adv, class_batch, cfg.adv_steps, nfe, counts)
    verified = nfe.total() // BPDA_T - 1 - (cfg.adv_steps + 1)  # past the vote and the steps
    log(f"  flip verification: {wall:.3f} s on {smi}; {verified} verification vote(s) of "
        f"{cfg.eot_defense_reps} reps through the kernels")
    if verified < 1:
        raise AssertionError(f"flip verification: no verification vote ran ({nfe.report()})")
    runs["flips"] = dict(wall_s=wall, nfe=dict(nfe.counts), counts=counts, verified=verified,
                         class_batch=class_batch.astype(int).tolist())
    return runs


def phase_dpm(torch, dev, score, clf, x01, x2, w2, smi, cpu):
    """Phase 13: DefendedModel with DPM-Solver++(2M) purification at t*=100
    in DPM_STEPS steps, bf16, cold and warm (launch counters 40 / 36 / 10 x
    DPM_STEPS, the NFE ledger dpm_solver_pp = DPM_STEPS); then t*=5 in 3
    steps and the input gradient of sum(w2 * purified) at batch 2, kernels
    (card) against plain (CPU, a job of ``cpu``) with the same noise, fp32
    and bf16, at phase 4's and phase 6's tolerances. Returns the runs and
    the function that joins the CPU's side and checks."""
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import PurifyConfig
    from diffpure_tpu_torch.utils.profiling import count_nfe

    score.dtype = torch.bfloat16
    n = x01.shape[0]
    dm = DefendedModel(score, clf, PurifyConfig(diffusion_type="dpm", t=EVALS,
                                                n_steps=DPM_STEPS, grad_mode="none"),
                       log_every=0)
    runs = []
    for run in ("cold", "warm"):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode(), count_nfe() as nfe:
            logits = dm(x01, SEED + 32)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        runs.append(dict(run=run, wall_s=wall, images_per_s=n / wall, counts=counts,
                         nfe=dict(nfe.counts)))
        log(f"  {run}: {wall:.3f} s, {n / wall:.3f} images/s on {smi}; {nfe.report()}; "
            f"launches {counts}")
        want = expected_counts(DPM_STEPS)
        if counts != want or dict(nfe.counts) != {"dpm_solver_pp": DPM_STEPS}:
            raise AssertionError(f"DPM: launch counts {counts} != {want} or NFE "
                                 f"{dict(nfe.counts)}")
    if tuple(logits.shape) != (n, 10) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"DPM: bad logits, shape {tuple(logits.shape)}")
    got = dpm_outputs(torch, score, x2, w2)
    score_cpu, x2_cpu = cpu.copy("score", score), x2.cpu()
    job = cpu.submit("phase 13", lambda: dpm_outputs(torch, score_cpu, x2_cpu, w2))
    log("  the card's side of t*=5 done; the CPU's runs beside phase 14")

    def finish():
        want = cpu.result(job)
        checks = {}
        for (dtype_name, what), g in got.items():
            bound = (SLICE_REL if what == "purify" else GRAD_REL)[dtype_name]
            w = want[dtype_name, what]
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            ok = bool(torch.isfinite(g).all()) and err <= bound * scale
            checks[f"{dtype_name}/{what}"] = dict(max_abs_err=err, rel_err=err / scale,
                                                  rel_tol=bound, ok=ok)
            log(f"  {dtype_name:8s} {what:8s}: max |kernel - plain| {err:.3e} (rel "
                f"{err / scale:.2e} <= {bound:.1e}) {'ok' if ok else 'FAIL'}")
        bad = [k for k, v in checks.items() if not v["ok"]]
        if bad:
            raise AssertionError(f"DPM kernel against plain: {bad} disagree")
        return checks

    return runs, finish


def dpm_outputs(torch, score, x2, w2):
    """Phase 13's t*=5 outputs on the device of ``x2``: the purification in 3
    DPM steps and the checkpointed input gradient of sum(w2 * purified), fp32
    and bf16; {(dtype, "purify" or "gradient"): tensor on the CPU}. Leaves
    ``score`` bf16."""
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.purify import PurifyConfig

    out = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        score.dtype = dtype
        cfg = dict(diffusion_type="dpm", t=5, n_steps=3)
        dm_f = DefendedModel(score, None, PurifyConfig(**cfg, grad_mode="none"), log_every=0)
        dm_g = DefendedModel(score, None, PurifyConfig(**cfg, grad_mode="checkpoint"),
                             log_every=0)
        with torch.inference_mode():
            out[dtype_name, "purify"] = dm_f.purify(x2, FixedNoise(SEED + 33)).cpu()
        out[dtype_name, "gradient"] = purify_grad(torch, dm_g, x2, w2,
                                                  FixedNoise(SEED + 34)).cpu()
    score.dtype = torch.bfloat16
    return out


def imagenet_fixture(rng, root):
    """IMAGENET_FIXTURE seeded JPEGs in root/dataset/imagenet/val/<class>/, and
    the same bytes keyed by path in a second root's
    val_faster_imagefolder.lmdb (tests/lmdb_fixture.write_lmdb), beside the
    same folder: (folder root, LMDB root)."""
    import importlib.util
    import io

    from PIL import Image

    spec = importlib.util.spec_from_file_location("lmdb_fixture",
                                                  REPO / "tests" / "lmdb_fixture.py")
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    entries = {}
    for i in range(IMAGENET_FIXTURE):
        cls = f"n0{i % 3:07d}"
        h, w = (int(v) for v in rng.integers(230, 400, 2))
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype="uint8")).save(buf, "JPEG")
        entries[f"val/{cls}/{i}.JPEG".encode("ascii")] = buf.getvalue()
    roots = [root.parent / f"{root.name}_{kind}" for kind in ("folder", "lmdb")]
    for r in roots:
        for key, data in entries.items():
            path = r / "dataset" / "imagenet" / key.decode()
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(data)
    fixture.write_lmdb(str(roots[1] / "dataset" / "imagenet" / "val_faster_imagefolder.lmdb"),
                       entries)
    return roots


def phase_cli(rng):
    """Phase 14: write a seeded cifar-10-batches-py/test_batch and the repo's
    configs/cifar10.yml into a fresh directory under chip_smoke_out/, run
    ``python -m diffpure_tpu_torch.cli`` there once per CLI_RUNS entry (the
    script's default fp32 precision, --device cuda by default); then the
    ImageNet rand scripts' flags (IMAGENET_CLI_RUNS) on a seeded image
    folder and the same images in an LMDB (imagenet_fixture) with the
    repo's configs/imagenet.yml (the YAML-built ADM, bf16 torso by its
    use_fp16), as the CLI with the launch counters printed after it; all
    runs at once, as processes of their own. Fails
    unless each exits 0 and prints its NFE report and results line, the
    BPDA run saved x_adv_bpda.npy, the ImageNet runs launched #6-#8 and
    not #9 (YAML-built ADMs never take flash), and the folder and the LMDB
    gave the same images."""
    import pickle
    import shutil
    import tempfile

    import numpy as np

    OUT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="cli_", dir=OUT))
    (work / "dataset" / "cifar-10-batches-py").mkdir(parents=True)
    with open(work / "dataset" / "cifar-10-batches-py" / "test_batch", "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (64, 3072), dtype=np.uint8),
                     b"labels": rng.integers(0, 10, 64).tolist()}, f)
    roots = imagenet_fixture(rng, work)
    for root in (work, *roots):
        (root / "configs").mkdir()
        for yml in ("cifar10.yml", "imagenet.yml"):
            shutil.copy(REPO / "configs" / yml, root / "configs" / yml)
    jobs = [(v, work, [*(["-c", TINY_AA_CLI_CODE] if v.startswith("rand") else
                         ["-m", "diffpure_tpu_torch.cli"]), *CLI_COMMON, *flags],
             "cifar10-wideresnet-28-10") for v, flags in CLI_RUNS.items()]
    jobs += [(v, roots[kind == "lmdb"], ["-c", CLI_WITH_COUNTS, *IMAGENET_CLI_COMMON,
                                         "--classifier_name", clf], clf)
             for v, (clf, kind) in IMAGENET_CLI_RUNS.items()]
    # all runs at once (each process mostly builds its models on the host)
    meta = {version: (cwd, clf) for version, cwd, _, clf in jobs}
    done = run_children([(version, cwd, args) for version, cwd, args, _ in jobs],
                        CLI_TIMEOUT_S)
    runs = {}
    for version, (returncode, stdout, stderr, wall) in done.items():
        cwd, clf = meta[version]
        proc = subprocess.CompletedProcess([], returncode, stdout, stderr)
        (OUT / f"cli_{version}.log").write_text(proc.stdout + "\n---- stderr\n" + proc.stderr)
        lines = proc.stdout.splitlines()
        nfe = [ln for ln in lines if ln.startswith("NFE total=")]
        results = [ln for ln in lines if ln.startswith("results: {")]
        data = [ln for ln in lines if ln.startswith("x: (")]
        counts = [json.loads(ln[len("launches: "):]) for ln in lines
                  if ln.startswith("launches: ")]
        attack = "sde_bpda" if version == "bpda" else "sde_rand"
        log_dir = cwd / "exp_results" / "images" / clf / attack / "seed0" / "data0"
        saved = sorted(p.name for p in log_dir.glob("*.npy"))
        runs[version] = dict(rc=proc.returncode, wall_s=wall, nfe=nfe, results=results,
                             saved=saved, data=data, counts=counts[-1] if counts else None)
        log(f"  {version}: rc {proc.returncode}, done {wall:.1f} s after the runs started "
            f"together on the card; {nfe[-1] if nfe else 'no NFE report'}; "
            f"{results[-1][:160] if results else 'no results line'}; saved {saved}"
            + (f"; {data[-1]}; launches {counts[-1]}" if counts else ""))
        bad = proc.returncode != 0 or not nfe or not results or (
            version == "bpda" and "x_adv_bpda.npy" not in saved)
        if version in IMAGENET_CLI_RUNS:
            bad = bad or not counts or counts[-1]["flash_attention"] != 0 or min(
                counts[-1][k] for k in ADM_KERNELS if k != "flash_attention") == 0
        if bad:
            log(proc.stderr[-3000:])
            raise AssertionError(f"the CLI's {version} run failed (chip_smoke_out/"
                                 f"cli_{version}.log)")
    folder, lmdb = ({tuple(runs[v]["data"])} for v in ("rn50", "wrn50_2"))
    if folder != lmdb:
        raise AssertionError(f"the image folder gave {folder}, the LMDB {lmdb}")
    return runs


def defended(torch, score, clf, t, grad_mode, imagenet=False):
    """DefendedModel at t*, the ImageNet form (resize_to=256, the
    guided-diffusion purify_sde) where ``imagenet``."""
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.purify import PurifyConfig

    kw = dict(score_type="guided_diffusion") if imagenet else {}
    return DefendedModel(score, clf, PurifyConfig(t=t, grad_mode=grad_mode, **kw),
                         log_every=0, resize_to=256 if imagenet else None)


def rel_check(torch, got, want, bound):
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    ok = bool(torch.isfinite(got).all()) and tuple(got.shape) == tuple(want.shape) \
        and err <= bound * scale
    return dict(max_abs_err=err, rel_err=err / scale, rel_tol=bound, ok=ok)


def phase_adm_grad_parity(torch, dev, adm, clf, rng, smi, cpu):
    """Phase 15: the input gradient of sum(w * purified) through
    DefendedModel(resize_to=256).purify, guided purify_sde at
    t*=ADM_GRAD_PARITY_T, the full-width imagenet256_config ADM (flash on),
    batch 1, a seeded cotangent w, both grad modes: the kernels (card) in
    fp32 and bf16 against the plain fp32 path (CPU, a job of ``cpu`` on its
    copy of the ADM), the same noise, at ADM_GRAD_REL; the card's bf16
    gradient's gap to its fp32 one is recorded beside it. The CPU runs fp32
    only: its bf16 gradients took 250 of the 387 s the four took on the
    card machine's CPU, which has no bf16 matrix units (ADM_GRAD_REL's
    note). The card's gradients must launch #6-#9. Returns the function
    that starts the CPU's side and the one that joins it and checks."""
    import numpy as np
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts

    x = torch.from_numpy(rng.uniform(size=(1, 224, 224, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 256, 256, 3)).astype(np.float32))

    def gradients(model, device, dtypes, launched=None):
        out = {}
        for dtype_name, dtype in dtypes:
            model.dtype = dtype
            for mode in GRAD_MODES:
                if launched is not None:  # the card's side (the counters are global)
                    reset_launch_counts()
                out[dtype_name, mode] = purify_grad(
                    torch, defended(torch, model, None, ADM_GRAD_PARITY_T, mode, True),
                    x.to(device), w, FixedNoise(SEED + 40)).cpu()
                if launched is not None:
                    launched[dtype_name, mode] = {k: launch_counts()[k] for k in ADM_KERNELS}
        model.dtype = torch.bfloat16
        return out

    launched = {}
    adm.to(dev)
    t0 = time.time()
    got = gradients(adm, dev, (("float32", torch.float32), ("bfloat16", torch.bfloat16)),
                    launched)
    card_s = time.time() - t0
    log(f"  card: {card_s:.1f} s for {len(got)} gradients; the CPU's run beside phases 17-19")
    jobs = []

    def start():
        adm_cpu = cpu.copy("adm", adm)
        jobs.append(cpu.submit("phase 15", lambda: gradients(adm_cpu, torch.device("cpu"),
                                                              (("float32", torch.float32),))))

    def finish():
        want = cpu.result(jobs[0])
        checks = {}
        for dtype_name in ("float32", "bfloat16"):
            for mode in GRAD_MODES:
                rec = rel_check(torch, got[dtype_name, mode], want["float32", mode],
                                ADM_GRAD_REL[dtype_name])
                rec["launches"] = launched[dtype_name, mode]
                if dtype_name == "bfloat16":  # the card's bf16 gradient against its fp32 one
                    ref = got["float32", mode]
                    rec["card_gap"] = float((got[dtype_name, mode] - ref).abs().max()
                                            / ref.abs().max())
                rec["ok"] = rec["ok"] and min(rec["launches"].values()) > 0
                checks[f"{dtype_name}/{mode}"] = rec
                log(f"  {dtype_name:8s} {mode:10s}: max |card - cpu fp32| "
                    f"{rec['max_abs_err']:.3e} (rel {rec['rel_err']:.2e} <= "
                    f"{rec['rel_tol']:.1e}) launches {rec['launches']} "
                    f"{'ok' if rec['ok'] else 'FAIL'}"
                    + (f"; card bf16 vs card fp32 {rec['card_gap']:.2e}" if "card_gap" in rec
                       else ""))
        bad = [k for k, v in checks.items() if not v["ok"]]
        if bad:
            raise AssertionError(f"ImageNet gradient card against CPU: {bad} disagree")
        return dict(checks=checks, seconds=dict(card=card_s, cpu=cpu.seconds["phase 15"]))

    return start, finish


def phase_adm_grad_rate(torch, dev, adm, clf, adm_per_eval, rng, smi):
    """Phase 16: the ImageNet gradient-image rate. The input gradient of the
    cross-entropy of DefendedModel(resize_to=256) (guided purify_sde at
    t*=ADM_GRAD_T through the bf16 ADM, ResNet-50) at batch ADM_GRAD_N, both grad
    modes, once each (phase 15's gradients warmed both paths): wall time,
    gradient-images/s, peak device memory; the launch counters must read
    the forward census (adm_per_eval) times the mode's forward evaluations
    (GRAD_EVALS), every other kernel 0 (the backward is autograd of the
    plain versions)."""
    import numpy as np
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts

    adm.dtype = torch.bfloat16
    runs = []

    def one(mode, n, run):
        xg = torch.from_numpy(rng.uniform(size=(n, 224, 224, 3)).astype(np.float32)).to(dev)
        yg = torch.from_numpy(rng.integers(0, 1000, n)).to(dev)
        dm = defended(torch, adm, clf, ADM_GRAD_T, mode, True)
        want = {**{k: 0 for k in launch_counts()},
                **{k: v * ADM_GRAD_T * GRAD_EVALS[mode][0] for k, v in adm_per_eval.items()}}
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        t0 = time.time()
        gx, _ = input_grad(torch, dm, xg, yg, SEED + 41)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs.append(dict(mode=mode, run=run, batch=n, wall_s=wall,
                         grad_images_per_s=n / wall, counts=counts, peak_gib=peak,
                         held_gib=held, grad_abs_max=float(gx.abs().max())))
        log(f"  {mode:10s} batch {n} {run}: {wall:.3f} s, {n / wall:.4f} gradient-images/s on "
            f"{smi}; peak device memory {peak:.2f} GiB ({held:.2f} GiB held before); "
            f"launches {counts}")
        if tuple(gx.shape) != (n, 224, 224, 3) or not bool(torch.isfinite(gx).all()) \
                or not bool((gx != 0).any()):
            raise AssertionError(f"{mode}: bad ImageNet input gradient, shape {tuple(gx.shape)}")
        if counts != want:
            raise AssertionError(f"{mode}: launch counts {counts} != {want}")

    for mode in GRAD_MODES:
        one(mode, ADM_GRAD_N, "warm")
    return runs


def phase_adm_attack(torch, dev, adm, clf, rng, smi):
    """Phase 17: the entry point on the ImageNet defence: eval_autoattack,
    version 'rand' (APGD-CE and APGD-DLR with EOT), then APGD-DLR alone
    (version 'custom'), through
    DefendedModel(resize_to=256) (guided purify_sde, bf16 ADM, ResNet-50,
    grad_mode 'checkpoint') at the budget AA_IMAGENET. The labels are the
    defence's own prediction under the noise of the suite's clean
    evaluation, so APGD runs through the defence on every example. x_adv
    must lie in the eps-ball and in [0, 1], and #6-#9 must have launched."""
    import numpy as np
    from diffpure_tpu_torch.attacks import AutoAttackConfig
    from diffpure_tpu_torch.eval import eval_autoattack
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.utils.prng import fold_in

    b = AA_IMAGENET
    adm.dtype = torch.bfloat16
    x = torch.from_numpy(rng.uniform(size=(b["batch"], 224, 224, 3)).astype(np.float32)).to(dev)
    dm = defended(torch, adm, clf, b["t"], "checkpoint", True)
    with torch.no_grad():
        y = dm(x, fold_in(fold_in(SEED + 42, 1), 7)).argmax(-1)
    runs = {}
    # the rand suite, then APGD-DLR alone on every example (with random
    # weights APGD-CE may flip them all, and DLR then attacks none)
    for tag, kw in (("rand", dict(version="rand")),
                    ("apgd-dlr", dict(version="custom", attacks_to_run=("apgd-dlr",)))):
        cfg = AutoAttackConfig(eps=b["eps"], eot_iter=b["eot_iter"], n_iter=b["n_iter"], **kw)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        res = eval_autoattack(dm, x, y, SEED + 42, cfg, log=lambda s: log(f"  {s}"))
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        x_adv = res["x_adv"]
        dist = float((x_adv - x).abs().max())
        log(f"  {tag}: {wall:.1f} s on {smi}; robust accuracy: classifier "
            f"{res['classifier_robust_acc']:.3f}, defended {res['defended_robust_acc']:.3f} "
            f"(random weights: these numbers mean nothing); max |x_adv - x| {dist:.5f} <= eps "
            f"{cfg.eps:.5f}; launches {counts}")
        if tuple(x_adv.shape) != tuple(x.shape) or not bool(torch.isfinite(x_adv).all()) \
                or dist > cfg.eps + 1e-6 or float(x_adv.min()) < 0 or float(x_adv.max()) > 1:
            raise AssertionError(f"ImageNet {tag}: x_adv leaves the eps-ball or [0, 1]")
        idle = [k for k in ADM_KERNELS if counts[k] == 0]
        if idle:
            raise AssertionError(f"ImageNet {tag}: kernels of the path never launched: {idle}")
        runs[tag] = dict(seconds=wall, counts=counts, max_dist=dist,
                         classifier_robust_acc=res["classifier_robust_acc"],
                         defended_robust_acc=res["defended_robust_acc"])
    return dict(budget=b, runs=runs)


def phase_gn_silu_grad(torch, dev, ddpm, ncsn_ddpm, clf, rng, smi):
    """Phase 18: #10's gradient, card (the kernel's forward, the plain
    chain's autograd backward) against CPU (plain): the input gradient of
    sum(w * purified) through the score_sde DDPM (fp32) at t*=5, batch 2,
    both grad modes, with exact launch counters (the DDPM's census times
    the mode's forward evaluations); and the input gradient of
    sum(w * score) of one NCSN++ resblock_type='ddpm' evaluation in bf16."""
    import numpy as np
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts

    x = torch.from_numpy(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32) * 0.5)
    ts = torch.tensor([99.9, 500.0])
    gn_per_eval, attn_per_eval = DDPM_GRAD_CENSUS

    def score_grad(device):
        xx = xs.to(device).requires_grad_(True)
        (g,) = torch.autograd.grad((w.to(device) * ncsn_ddpm(xx, ts.to(device)).float()).sum(),
                                   xx)
        return g.cpu()

    got, want, counts = {}, {}, {}
    ncsn_ddpm.dtype = torch.bfloat16
    for where, device, out in (("card", dev, got), ("cpu", torch.device("cpu"), want)):
        for m in (ddpm, ncsn_ddpm):
            m.to(device)
        for mode in GRAD_MODES:
            dm = defended(torch, ddpm, clf, 5, mode)
            reset_launch_counts()
            out[mode] = purify_grad(torch, dm, x.to(device), w, FixedNoise(SEED + 43)).cpu()
            if where == "card":
                counts[mode] = launch_counts()
        reset_launch_counts()
        out["ncsnpp_ddpm_bf16"] = score_grad(device)
        if where == "card":
            counts["ncsnpp_ddpm_bf16"] = launch_counts()
    for m in (ddpm, ncsn_ddpm):
        m.to(dev)
    checks = {}
    for what, bound in (("checkpoint", GRAD_REL["float32"]), ("adjoint", GRAD_REL["float32"]),
                        ("ncsnpp_ddpm_bf16", NCSN_DDPM_GRAD_REL)):
        rec = rel_check(torch, got[what], want[what], bound)
        c = counts[what]
        if what in GRAD_MODES:
            fwd = 5 * GRAD_EVALS[what][0]
            expect = {**{k: 0 for k in c}, "group_norm_silu_fused": gn_per_eval * fwd,
                      "fused_attnblock": attn_per_eval * fwd}
            rec["ok"] = rec["ok"] and c == expect
        else:
            rec["ok"] = rec["ok"] and c["group_norm_silu_fused"] > 0
        rec["launches"] = c
        checks[what] = rec
        log(f"  {what:16s}: max |card - cpu| {rec['max_abs_err']:.3e} (rel {rec['rel_err']:.2e} "
            f"<= {bound:.1e}); #10 launches {c['group_norm_silu_fused']} "
            f"{'ok' if rec['ok'] else 'FAIL'}")
    bad = [k for k, v in checks.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"#10 gradient card against CPU: {bad} disagree ({checks})")
    return checks


def seeded_classifier(torch, name, seed=1):
    """A registry classifier with seeded normal weights (the CLI's classifier
    seed by default), eval mode, frozen, on the CPU."""
    import numpy as np
    from diffpure_tpu_torch.classifiers import get_classifier
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    m = get_classifier(name).eval()
    m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                       seeded_normal_state_dict(m, seed).items()})
    return m.requires_grad_(False)


def phase_classifiers(torch, dev, score, x01, rng, smi):
    """Phase 19: the CIFAR classifier zoo. ResNet-50, WRN-70-16 with dropout
    and the DeepMind WRN-70-16 at full width (ZOO's parameter counts), fp32:
    card against CPU at batch ZOO_N (ZOO_REL), CUDA-event and device
    (profiler) ms per forward at batch ZOO_RATE_N; then the bf16 NCSN++
    DefendedModel + WRN-70-16-dropout at t*=EVALS on ``x01`` under
    inference_mode, whose launch counters must read 40 / 36 / 10 per
    evaluation. Returns (records, the WRN-70-16-dropout on the card)."""
    import numpy as np
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import PurifyConfig

    x4 = torch.from_numpy(rng.uniform(size=(ZOO_N, 32, 32, 3)).astype(np.float32))
    x64 = torch.from_numpy(rng.uniform(size=(ZOO_RATE_N, 32, 32, 3)).astype(np.float32)).to(dev)
    records, keep = {}, None
    for name, n_want in ZOO.items():
        t0 = time.time()
        m = seeded_classifier(torch, name)
        build_s = time.time() - t0
        n_params = sum(p.numel() for p in m.parameters())
        with torch.inference_mode():
            t0 = time.time()
            want = m(x4)
            cpu_s = time.time() - t0
            m.to(dev)
            got = m(x4.to(dev)).cpu()
            ms = cuda_ms(torch, lambda: m(x64), reps=10)
            dev_ms = device_ms(torch, lambda: m(x64), reps=5)["total"]
        rec = dict(params=n_params, seeded_build_s=build_s, cpu_batch4_s=cpu_s,
                   batch=ZOO_RATE_N, ms=ms, device_ms=dev_ms, **rel_check(torch, got, want, ZOO_REL))
        rec["ok"] = rec["ok"] and n_params == n_want and tuple(got.shape) == (ZOO_N, 10)
        records[name] = rec
        log(f"  {name}: {n_params:,} parameters (seeded in {build_s:.1f} s); max |card - cpu| "
            f"{rec['max_abs_err']:.3e} (rel {rec['rel_err']:.2e} <= {ZOO_REL:.0e}) "
            f"{'ok' if rec['ok'] else 'FAIL'}; batch {ZOO_RATE_N}: {ms:.3f} ms a forward "
            f"(events), {dev_ms:.3f} ms of device time on {smi}")
        if not rec["ok"]:
            raise AssertionError(f"classifier {name}: card against CPU failed ({rec})")
        if name == "cifar10-wrn-70-16-dropout":
            keep = m
        else:
            m.cpu()
    score.dtype = torch.bfloat16
    dm = DefendedModel(score, keep, PurifyConfig(t=EVALS, grad_mode="none"), log_every=0)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.inference_mode():
        logits = dm(x01, SEED + 31)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    n = x01.shape[0]
    log(f"  bf16 NCSN++ + WRN-70-16-dropout, t*={EVALS}, batch {n}: {wall:.3f} s, "
        f"{n / wall:.3f} images/s on {smi}; launches {counts}")
    if counts != expected_counts(EVALS):
        raise AssertionError(f"launch counts {counts} != {expected_counts(EVALS)}")
    if tuple(logits.shape) != (n, 10) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    records["defended_wrn_70_16_dropout"] = dict(wall_s=wall, images_per_s=n / wall,
                                                 counts=counts)
    return records, keep


def purify_steps(kind, t):
    """The solver steps of one purification at t* (purify/runners.py, the
    PurifyConfig defaults): the ODE's round(t / 1000 / step_size), the
    LDSDE's round((t1 - t0) / ldsde_dt) of at least 1, the SDE's t."""
    if kind == "ode":
        return max(int(round(t / 1000.0 / 1e-3)), 1)
    if kind == "ldsde":
        return max(int(round(((1.0 - 1e-5) - (1.0 - t / 1000.0)) / 1e-2)), 1)
    return t


def purify_evals(kind, mode, t):
    """(forward, backward) score evaluations of one purification's input
    gradient: 'checkpoint' runs each step forward twice (the recompute),
    'adjoint' three times (the rebuild without a graph, then the VJP's),
    reversible Heun n + 1 forward, then four a step in the backward (two
    to rebuild, two in the local VJP) and two backward."""
    n = purify_steps(kind, t)
    return {"checkpoint": (2 * n, n), "adjoint": (3 * n, n),
            "reversible": (5 * n + 1, 2 * n)}[mode]


def grad_counts(fwd, bwd):
    """Launch counts of ``fwd`` CIFAR NCSN++ forward and ``bwd`` backward
    evaluations (phase 5's derivation)."""
    return {**expected_counts(fwd),
            **{k: KERNELS[v[2]][2] * bwd for k, v in BWD_KERNELS.items()}}


def reversible_heun_unrolled(drift, diffusion, x0, t0, t1, n_steps, dw, params=()):
    """sdeint_reversible_heun's solve, the drift at the same times, with
    autograd through its steps (each checkpointed): the exact gradient of
    the same discrete solve, which the algebraic reversal reproduces only
    as far as its rebuilt trajectory lands on the forward's."""
    import numpy as np
    from torch.utils.checkpoint import checkpoint
    from diffpure_tpu_torch.solvers.reversible import _grid, _local_step

    dt, t_at = _grid(t0, t1, n_steps)
    y = yhat = x0
    for i in range(n_steps):
        # the forward evaluates step i's first drift where step i - 1 ended
        t_n = t_at(0) if i == 0 else np.float32(t_at(i - 1) + dt)
        y, yhat = checkpoint(_local_step, drift, diffusion, y, yhat, t_n,
                             np.float32(t_at(i) + dt), float(dt), dw(i), use_reentrant=False)
    return y


def purify_value_grad(torch, dm, x01, w, noise):
    """(dm.purify(x01, noise), d/dx of sum(w * that))."""
    x = x01.detach().clone().requires_grad_(True)
    out = dm.purify(x, noise)
    (gx,) = torch.autograd.grad((w.to(x.device) * out).sum(), x)
    return out.detach(), gx


def phase_purifiers(torch, dev, score, clf, x01, rng, smi, cpu, sde_rate=None,
                    grad_runs=()):
    """Phase 20: the other purifiers. (a) purify_ode at t*=EVALS (EVALS Euler
    steps), bf16, batch 8, cold and warm, counters 40 / 36 / 10 per step,
    beside phase 3's SDE rate (``sde_rate``); (b) each PURIFY_MODES entry at
    t*=PURIFY_T, batch PURIFY_N: the purified images and their input gradient
    (seeded cotangent), card against CPU with the same noise (the bounds at
    PURIFY_MODES), fp32 and bf16, with the launch counters each mode derives
    (purify_evals), #4 / #5 included; (c) whether the score model returns
    the same bits twice (the reversal needs it), and reversible Heun's
    gradient at batch GRAD_N, t*=REV_T: wall, gradient-images/s, peak
    memory and the reconstruction error, beside phase 5's ``grad_runs``,
    and its gap to the exact gradient of the same solve on the same inputs
    and noise (reversible_heun_unrolled), max |rev - exact| / max |exact|.
    (b)'s CPU side is a job of ``cpu``, submitted after (c) (whose patch of
    the reversible solver it must not see); returns the records and the
    function that joins it and checks (b)."""
    import numpy as np
    from diffpure_tpu_torch.eval import DefendedModel, get_accuracy
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import PurifyConfig, runners
    from diffpure_tpu_torch.solvers.reversible import last_reconstruction_error

    out = dict(ode_runs=[], checks={}, determinism={})
    score.dtype = torch.bfloat16
    n = x01.shape[0]
    y = torch.from_numpy(rng.integers(0, 10, n)).to(dev)
    dm = DefendedModel(score, clf, PurifyConfig(diffusion_type="ode", t=EVALS, grad_mode="none"),
                       log_every=0)
    for run in ("cold", "warm"):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            get_accuracy(dm, x01, y, seed=SEED + 32, bs=n)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        out["ode_runs"].append(dict(run=run, wall_s=wall, images_per_s=n / wall, counts=counts))
        log(f"  ODE t*={EVALS} ({EVALS} Euler steps) {run}: {wall:.3f} s, {n / wall:.3f} "
            f"purified images/s on {smi} (the SDE's, phase 3 warm: "
            f"{sde_rate if sde_rate is None else f'{sde_rate:.3f}'}); launches {counts}")
        if counts != expected_counts(EVALS):
            raise AssertionError(f"ODE launch counts {counts} != {expected_counts(EVALS)}")

    x2 = x01[:PURIFY_N]
    w = torch.from_numpy(rng.standard_normal((PURIFY_N, 32, 32, 3)).astype(np.float32))
    dms = {(k, m): DefendedModel(score, clf, PurifyConfig(diffusion_type=k, t=PURIFY_T,
                                                           grad_mode=m), log_every=0)
           for k, m in PURIFY_MODES}
    card, counts_b, recon = {}, {}, {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        score.dtype = dtype
        for key, d in dms.items():
            reset_launch_counts()
            card[dtype_name, key] = [v.cpu() for v in purify_value_grad(
                torch, d, x2, w, FixedNoise(SEED + 33))]
            counts_b[dtype_name, key] = launch_counts()
            if key[1] == "reversible":
                recon[dtype_name, key] = last_reconstruction_error()
    xg = torch.from_numpy(rng.uniform(size=(GRAD_N, 32, 32, 3)).astype(np.float32)).to(dev)
    yg = torch.from_numpy(rng.integers(0, 10, GRAD_N)).to(dev)
    ts = torch.full((GRAD_N,), 99.9, device=dev)
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        score.dtype = dtype
        with torch.inference_mode():
            a, b = score(xg * 2 - 1, ts), score(xg * 2 - 1, ts)
        out["determinism"][dtype_name] = dict(same_bits=bool(torch.equal(a, b)),
                                              max_abs_diff=float((a - b).abs().max()))
        log(f"  the score model twice on the same input, {dtype_name}: "
            f"{'the same bits' if torch.equal(a, b) else 'DIFFERENT bits'} (max |diff| "
            f"{out['determinism'][dtype_name]['max_abs_diff']:.3e})")
    score.dtype = torch.bfloat16
    dmr = DefendedModel(score, clf, PurifyConfig(t=REV_T, grad_mode="reversible"), log_every=0)
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.time()
    gx, _ = input_grad(torch, dmr, xg, yg, SEED + 34)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = launch_counts()
    want = grad_counts(*purify_evals("sde", "reversible", REV_T))
    err = last_reconstruction_error()
    with mock.patch.object(runners, "sdeint_reversible_heun", reversible_heun_unrolled):
        gx_exact, _ = input_grad(torch, dmr, xg, yg, SEED + 34)
    gap = float((gx - gx_exact).abs().max() / gx_exact.abs().max())
    out["reversible"] = dict(wall_s=wall, grad_images_per_s=GRAD_N / wall, peak_gib=peak,
                             held_gib=held, counts=counts, reconstruction_error=err,
                             gap_to_exact=gap)
    others = "; ".join(f"{r['mode']} {r['run']} {r['grad_images_per_s']:.3f}, peak "
                       f"{r['peak_gib']:.2f} GiB" for r in grad_runs)
    log(f"  reversible, t*={REV_T}, bf16, batch {GRAD_N}: {wall:.3f} s, "
        f"{GRAD_N / wall:.3f} gradient-images/s on {smi}; peak device memory {peak:.2f} GiB "
        f"({held:.2f} held before); reconstruction error {err:.3e}; gradient against the "
        f"exact one of the same solve: rel {gap:.3e}; launches {counts} (phase 5: {others})")
    if tuple(gx.shape) != tuple(xg.shape) or not bool(torch.isfinite(gx).all()) \
            or not bool((gx != 0).any()) or not np.isfinite(gap):
        raise AssertionError(f"reversible: bad input gradient, shape {tuple(gx.shape)}")
    if counts != want:
        raise AssertionError(f"reversible: launch counts {counts} != {want}")

    score_cpu, x2_cpu = cpu.copy("score", score), x2.cpu()
    job = cpu.submit("phase 20(b)", lambda: purifier_outputs_plain(torch, score_cpu, x2_cpu, w))
    log("  the CPU's side of (b) runs beside phase 21")

    def finish():
        plain = cpu.result(job)
        for (dtype_name, key), (got_x, got_g) in card.items():
            fwd, bwd = purify_evals(*key, PURIFY_T)
            want_counts = grad_counts(fwd, bwd)
            rx = rel_check(torch, got_x, plain[dtype_name, key][0], SLICE_REL[dtype_name])
            rg = rel_check(torch, got_g, plain["float32", key][1], GRAD_REL[dtype_name])
            ok = rx["ok"] and rg["ok"] and counts_b[dtype_name, key] == want_counts
            rec = dict(purified=rx, gradient=rg, evals=(fwd, bwd),
                       counts=counts_b[dtype_name, key], ok=ok)
            if (dtype_name, key) in recon:
                rec["reconstruction_error"] = recon[dtype_name, key]
            out["checks"][f"{dtype_name}/{key[0]}/{key[1]}"] = rec
            launched = counts_b[dtype_name, key]
            log(f"  {dtype_name:8s} {key[0]:5s} {key[1]:10s}: purified rel {rx['rel_err']:.2e} "
                f"(<= {rx['rel_tol']:.0e}), gradient rel {rg['rel_err']:.2e} (<= "
                f"{rg['rel_tol']:.0e}, against the CPU's fp32); {fwd} / {bwd} evaluations, "
                f"launches {'as derived' if launched == want_counts else launched}"
                + (f"; reconstruction error {recon[dtype_name, key]:.3e}"
                   if (dtype_name, key) in recon else "") + f" {'ok' if ok else 'FAIL'}")
        bad = [k for k, v in out["checks"].items() if not v["ok"]]
        if bad:
            raise AssertionError(f"purifiers card against CPU: {bad} failed")
        return out

    return out, finish


def purifier_outputs_plain(torch, score, x2, w):
    """Phase 20(b)'s CPU side: each PURIFY_MODES entry's purified images and
    input gradient (purify_value_grad) in fp32, and its purified images in
    bf16, at t*=PURIFY_T with FixedNoise(SEED + 33). Leaves ``score``
    bf16."""
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.purify import PurifyConfig

    plain = {}
    for kind, mode in PURIFY_MODES:
        d = DefendedModel(score, None, PurifyConfig(diffusion_type=kind, t=PURIFY_T,
                                                    grad_mode=mode), log_every=0)
        score.dtype = torch.float32
        plain["float32", (kind, mode)] = purify_value_grad(torch, d, x2, w,
                                                           FixedNoise(SEED + 33))
        score.dtype = torch.bfloat16
        with torch.inference_mode():
            plain["bfloat16", (kind, mode)] = (d.purify(x2, FixedNoise(SEED + 33)), None)
    return plain


def run_children(jobs, timeout_s):
    """Start every (tag, cwd, argv) job as a ``python`` process of its own,
    all at once; return {tag: (returncode, stdout, stderr, seconds since
    the start)}. Every child is waited for, or killed when the time is up."""
    t0 = time.time()
    procs = [(tag, subprocess.Popen([sys.executable, *argv], cwd=cwd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True,
                                    env={**os.environ, "PYTHONPATH": str(REPO)}))
             for tag, cwd, argv in jobs]
    done = {}
    try:
        for tag, proc in procs:
            stdout, stderr = proc.communicate(timeout=max(1.0, timeout_s - (time.time() - t0)))
            done[tag] = (proc.returncode, stdout, stderr, time.time() - t0)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return done


def script_flags(path, budget):
    """The ``--flag value`` pairs of a run script, ``budget``'s in place of
    its own, and the seeds fixed at 0."""
    import re

    flags = dict(re.findall(r"^\s+(--\w+) (\S+)", path.read_text(), re.M))
    flags.update({"--seed": "0", "--data_seed": "0", **dict(zip(budget[::2], budget[1::2]))})
    return [t for kv in flags.items() for t in kv]


def cifar_fixture(root, data, clf, dev):
    """root/dataset/cifar-10-batches-py/test_batch of ``data`` (uint8, N x
    3072), labelled by ``clf``'s own predictions, and the repo's configs."""
    import pickle
    import shutil

    import numpy as np
    import torch

    x = torch.from_numpy(data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32)
                         / 255.0).to(dev)
    with torch.inference_mode():
        labels = clf(x).argmax(-1).cpu().tolist()
    (root / "dataset" / "cifar-10-batches-py").mkdir(parents=True)
    with open(root / "dataset" / "cifar-10-batches-py" / "test_batch", "wb") as f:
        pickle.dump({b"data": data, b"labels": labels}, f)
    (root / "configs").mkdir()
    shutil.copy(REPO / "configs" / "cifar10.yml", root / "configs" / "cifar10.yml")


def phase_standard(torch, dev, score, clf, wrn70, x01, rng, smi):
    """Phase 21: eval_autoattack 'standard' (APGD-CE, APGD-T, FAB-T, Square)
    through the bf16 CIFAR defence (WRN-28-10, grad_mode 'checkpoint') at
    the budget AA_STANDARD, in Linf and L2 (STANDARD_EPS). The labels are
    the defence's own prediction under the noise of the suite's clean
    evaluation, so every example starts robust. An attack that the suite
    left no example to (the earlier ones flipped them all) runs alone on
    every example ('custom'), so that each of the four attacks attacks a
    non-empty set through the defence. x_adv must lie in the ball and in
    [0, 1], and #1-#5 must launch. Then the CLI on STAND_CLI_RUNS's scripts
    at once (processes of their own, the suite cut to AA_STANDARD's
    budget), on a seeded CIFAR-10 fixture labelled by each script's
    classifier (the CLI's seeds: WRN-28-10 is ``clf``, WRN-70-16 ``wrn70``)
    and an ImageNet image folder; each must exit 0, print its NFE report and
    results line and launch its path's kernels."""
    import shutil
    import tempfile

    import numpy as np
    from diffpure_tpu_torch.attacks import AutoAttackConfig
    from diffpure_tpu_torch.eval import DefendedModel, eval_autoattack
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import PurifyConfig
    from diffpure_tpu_torch.utils.prng import fold_in

    b = AA_STANDARD
    score.dtype = torch.bfloat16
    x = x01[:b["batch"]]
    dm = DefendedModel(score, clf, PurifyConfig(t=b["t"], grad_mode="checkpoint"), log_every=0)
    budget = {k: v for k, v in b.items() if k not in ("batch", "t")}
    suites = {}
    for norm, eps in STANDARD_EPS.items():
        seed = SEED + 50 + len(suites)
        with torch.no_grad():
            y = dm(x, fold_in(fold_in(seed, 1), 7)).argmax(-1)
        cfg = AutoAttackConfig(version="standard", norm=norm, eps=eps, **budget)
        done = []  # the defended suite's phase_results, by its on_phase hook
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        res = eval_autoattack(dm, x, y, seed, cfg, log=lambda s: log(f"  {s}"),
                              on_phase=lambda r: done.__setitem__(slice(None), r))
        torch.cuda.synchronize()
        wall = time.time() - t0
        phases = {name: dict(attacked=n, seconds=sec, robust_acc=acc, alone=False)
                  for name, acc, n, sec in done}
        x_adv = res["x_adv"]
        for name in STANDARD_ATTACKS:
            if name in phases:
                continue
            alone = AutoAttackConfig(version="custom", attacks_to_run=(name,), norm=norm,
                                     eps=eps, **budget)
            more = eval_autoattack(dm, x, y, seed, alone, log=lambda s: log(f"  {s}"),
                                   on_phase=lambda r: done.__setitem__(slice(None), r))
            for nm, acc, n, sec in done:
                phases[nm] = dict(attacked=n, seconds=sec, robust_acc=acc, alone=True)
            x_adv = torch.cat([x_adv, more["x_adv"]])
        torch.cuda.synchronize()
        counts = launch_counts()
        d = (x_adv - x.repeat(x_adv.shape[0] // x.shape[0], 1, 1, 1)).reshape(x_adv.shape[0], -1)
        dist = float(d.abs().max(-1).values.max() if norm == "Linf" else d.norm(dim=-1).max())
        suites[norm] = dict(wall_s=wall, eps=eps, phases=phases, counts=counts, max_dist=dist,
                            classifier_robust_acc=res["classifier_robust_acc"],
                            defended_robust_acc=res["defended_robust_acc"])
        log(f"  standard {norm}: {wall:.1f} s on {smi} (the suite, with its classifier-only "
            f"baseline); per attack (attacked, s): "
            + ", ".join(f"{k} ({v['attacked']}, {v['seconds']:.1f}"
                        f"{', alone' if v['alone'] else ''})" for k, v in phases.items())
            + f"; max |x_adv - x| {dist:.5f} <= {eps}; launches {counts}")
        empty = [k for k in STANDARD_ATTACKS if phases.get(k, {}).get("attacked", 0) == 0]
        if empty:
            raise AssertionError(f"standard {norm}: {empty} attacked no example")
        if not bool(torch.isfinite(x_adv).all()) or dist > eps + 1e-5 \
                or float(x_adv.min()) < 0 or float(x_adv.max()) > 1:
            raise AssertionError(f"standard {norm}: x_adv leaves the ball or [0, 1]")
        idle = [k for k in (*KERNELS, *BWD_KERNELS) if counts[k] == 0]
        if idle:
            raise AssertionError(f"standard {norm}: kernels of the path never launched: {idle}")

    OUT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="stand_", dir=OUT))
    data = rng.integers(0, 256, (64, 3072), dtype=np.uint8)
    roots = {"cifar10-wideresnet-28-10": work / "wrn28", "cifar10-wrn-70-16-dropout": work / "wrn70"}
    for name, m in (("cifar10-wideresnet-28-10", clf), ("cifar10-wrn-70-16-dropout", wrn70)):
        cifar_fixture(roots[name], data, m, dev)
    folder = imagenet_fixture(rng, work / "in")[0]
    (folder / "configs").mkdir()
    shutil.copy(REPO / "configs" / "imagenet.yml", folder / "configs" / "imagenet.yml")
    jobs, where = [], {}
    for tag, (script, budget_flags) in STAND_CLI_RUNS.items():
        argv = script_flags(REPO / "run_scripts" / "torch" / script, budget_flags)
        clf_name = argv[argv.index("--classifier_name") + 1]
        cwd = folder if script.startswith("imagenet") else roots[clf_name]
        where[tag] = (cwd, clf_name, argv)
        jobs.append((tag, cwd, ["-c", TINY_AA_CLI_CODE, *argv, "--random_weights"]))
    runs = {}
    for tag, (rc, stdout, stderr, secs) in run_children(jobs, CLI_TIMEOUT_S).items():
        (OUT / f"cli_{tag}.log").write_text(stdout + "\n---- stderr\n" + stderr)
        lines = stdout.splitlines()
        nfe = [ln for ln in lines if ln.startswith("NFE total=")]
        results = [ln for ln in lines if ln.startswith("results: {")]
        counts = [json.loads(ln[len("launches: "):]) for ln in lines if ln.startswith("launches: ")]
        cwd, clf_name, argv = where[tag]
        version = argv[argv.index("--attack_version") + 1]
        kind = argv[argv.index("--diffusion_type") + 1]
        log_dir = cwd / "exp_results" / "images" / clf_name / f"{kind}_{version}" / "seed0" / "data0"
        saved = sorted(p.name for p in log_dir.glob("*.npy"))
        runs[tag] = dict(rc=rc, wall_s=secs, nfe=nfe, results=results, saved=saved,
                         counts=counts[-1] if counts else None)
        log(f"  {tag}: rc {rc}, done {secs:.1f} s after the runs started together on the card; "
            f"{nfe[-1] if nfe else 'no NFE report'}; {results[-1][:200] if results else 'no results'}"
            f"; saved {saved}; launches {counts[-1] if counts else None}")
        path = ADM_KERNELS if tag.startswith("in_") else KERNELS
        bad = rc != 0 or not nfe or not results or not counts or \
            f"x_adv_defended_{version}.npy" not in saved or \
            min(counts[-1][k] for k in path if k != "flash_attention") == 0
        if bad:
            log(stderr[-3000:])
            raise AssertionError(f"the CLI's {tag} run failed (chip_smoke_out/cli_{tag}.log)")
    return dict(budget=b, suites=suites, cli_runs=runs)


def stadv_counts(nfe_total, grad_calls, t):
    """Launch counts of a StAdv run through the CIFAR defence: each gradient
    call's t steps run forward, again when their checkpoints are recomputed,
    and backward once; the NFE ledger counts each purification once."""
    fwd, bwd = nfe_total + grad_calls * t, grad_calls * t
    return {**{k: v[2] * fwd for k, v in KERNELS.items()},
            **{k: KERNELS[f][2] * bwd for k, (_, _, f) in BWD_KERNELS.items()},
            **{k: 0 for k in (*ADM_KERNELS, *DDPM_KERNELS)}}


def phase_stadv(torch, dev, score, rng, smi):
    """Phase 22: StAdv (stadv_attack) through the CIFAR defence at the run
    script's fp32 (NCSN++, ResNet-50 with the CLI's seed, grad_mode
    'checkpoint') at STADV's budget, on 4 seeded images labelled by the
    defence itself: every grid the attack samples with lies in [-1, 1] and
    within ``bound`` of the identity grid, x_adv in [0, 1], the launch
    counters exactly stadv_counts of the NFE ledger; then grid_sample on the
    card against the CPU at seeded grids (near the identity, and past
    [-1, 1]), values and both gradients, at GRID_REL."""
    import numpy as np
    from diffpure_tpu_torch.attacks import StAdvConfig, stadv
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.ops.grid_sample import grid_sample, identity_grid
    from diffpure_tpu_torch.purify import PurifyConfig
    from diffpure_tpu_torch.utils.prng import fold_in
    from diffpure_tpu_torch.utils.profiling import count_nfe

    b = STADV
    score.dtype = torch.float32
    rn50 = seeded_classifier(torch, "cifar10-resnet-50").to(dev)
    dm = DefendedModel(score, rn50, PurifyConfig(t=b["t"], grad_mode="checkpoint"), log_every=0)
    x = torch.from_numpy(rng.uniform(size=(b["batch"], 32, 32, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        y = dm(x, fold_in(SEED + 60, 1)).argmax(-1)
    ident = identity_grid(*x.shape[:3], device=dev)
    grids = []

    def sample(img, grid):
        grids.append(grid.detach())
        return grid_sample(img, grid)

    cfg = StAdvConfig(bound=b["bound"], n_iter=b["n_iter"], eot_iter=b["eot_iter"])
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    with mock.patch.object(stadv, "grid_sample", sample), count_nfe() as nfe:
        x_adv, found = stadv.stadv_attack(dm, x, y, SEED + 61, cfg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    grad_calls = b["n_iter"] * b["eot_iter"]
    want = stadv_counts(nfe.total(), grad_calls, b["t"])
    g = torch.stack(grids)
    off = float((g - ident).abs().max())
    rec = dict(wall_s=wall, nfe=dict(nfe.counts), counts=counts, grids=len(grids),
               max_offset=off, grid_range=[float(g.min()), float(g.max())],
               found=found.tolist(), x_adv_range=[float(x_adv.min()), float(x_adv.max())])
    log(f"  stadv_attack t*={b['t']}, batch {b['batch']}, {b['n_iter']} iterations x "
        f"{b['eot_iter']} EOT: {wall:.2f} s on {smi}; {nfe.report()}; {len(grids)} grids, "
        f"max |grid - identity| {off:.5f} <= {b['bound']}, grids in [{rec['grid_range'][0]:.4f}, "
        f"{rec['grid_range'][1]:.4f}]; found {rec['found']}; launches {counts}")
    if nfe.total() != (grad_calls + 1) * b["t"] or len(grids) != grad_calls + 1:
        raise AssertionError(f"StAdv ran {nfe.total()} evaluations, {len(grids)} samplings")
    if off > b["bound"] + 1e-6 or float(g.min()) < -1 or float(g.max()) > 1:
        raise AssertionError("StAdv's grid leaves the bound or [-1, 1]")
    if not bool(torch.isfinite(x_adv).all()) or rec["x_adv_range"][0] < 0 \
            or rec["x_adv_range"][1] > 1 or tuple(x_adv.shape) != tuple(x.shape):
        raise AssertionError("StAdv's x_adv is not a batch of images in [0, 1]")
    if counts != want:
        raise AssertionError(f"StAdv launch counts {counts} != {want}")

    checks = {}
    img = torch.from_numpy(rng.uniform(size=(b["batch"], 32, 32, 3)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((b["batch"], 32, 32, 3)).astype(np.float32))
    near = ident.cpu() + torch.from_numpy(
        rng.uniform(-0.1, 0.1, ident.shape).astype(np.float32))
    far = torch.from_numpy(rng.uniform(-1.5, 1.5, ident.shape).astype(np.float32))
    for kind, grid in (("identity", ident.cpu().clone()), ("near", near), ("past [-1, 1]", far)):
        outs = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            xi = img.to(device).requires_grad_(True)
            gi = grid.to(device).requires_grad_(True)
            v = grid_sample(xi, gi)
            dx, dg = torch.autograd.grad(v, (xi, gi), ct.to(device))
            outs[where] = [t.detach().cpu() for t in (v, dx, dg)]
        recs = [rel_check(torch, a, c, GRID_REL) for a, c in zip(outs["card"], outs["cpu"])]
        checks[kind] = dict(value=recs[0], d_image=recs[1], d_grid=recs[2],
                            ok=all(r["ok"] for r in recs))
        log(f"  grid_sample {kind:13s}: max |card - cpu| / max |cpu| value "
            f"{recs[0]['rel_err']:.2e}, d/dimage {recs[1]['rel_err']:.2e}, d/dgrid "
            f"{recs[2]['rel_err']:.2e} (<= {GRID_REL:.0e}; d/dgrid max |cpu| "
            f"{float(outs['cpu'][2].abs().max()):.1f}) "
            f"{'ok' if checks[kind]['ok'] else 'FAIL'}")
    bad = [k for k, v in checks.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"grid_sample card against CPU: {bad} disagree")
    rec["grid_sample_checks"] = checks
    return rec


def discrete_purify(torch, adm, x, noise, t, use_ddim, grad_mode="none"):
    """purify_guided_ddpm at t: ancestral steps on the 1000-step process, or
    DDIM steps on the DDIM_RESPACING respacing."""
    from diffpure_tpu_torch.purify import PurifyConfig, make_imagenet_diffusion, \
        purify_guided_ddpm

    diffusion = make_imagenet_diffusion(DDIM_RESPACING) if use_ddim else None
    return purify_guided_ddpm(adm, x, noise, PurifyConfig(t=t, grad_mode=grad_mode),
                              diffusion=diffusion, use_ddim=use_ddim)


def phase_guided_ddpm(torch, dev, adm, clf, adm_per_eval, rng, smi, cpu, plain_side):
    """Phase 23: the discrete guided DDPM through imagenet256_config's ADM
    (flash on) and ResNet-50. (a) DefendedModel(resize_to=256) with
    diffusion_type 'ddpm' at t=GUIDED_T, bf16, batch ADM_N, cold and warm,
    purified images/s, the counters the census times GUIDED_T; (b) DDIM at
    t=DDIM_T on the DDIM_RESPACING respacing, batch ADM_N, the census times
    DDIM_T; (c) t=DISCRETE_PARITY_T, batch 1, ancestral and DDIM, fp32 and
    bf16 on the card against the CPU's fp32 (the same ADM moved there, the
    same seeded draws), and the ADM's output through the DDIM_RESPACING
    process's wrapped model at respaced index GUIDED_EPS_INDEX (a float32
    timestep), fp32 and bf16 against the CPU's fp32; (d) the input gradient of sum(w * purified) at
    t=DISCRETE_PARITY_T, bf16, grad_mode 'checkpoint': finite, non-zero,
    the forward kernels launched for the loop and its recomputation. (c)'s
    CPU side is ``plain_side``, the job start_guided_plain submitted to
    ``cpu`` (with its inputs); it is joined after (d)."""
    import numpy as np
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import PurifyConfig, make_imagenet_diffusion
    from diffpure_tpu_torch.utils.profiling import count_nfe

    out = dict(runs=[], checks={})
    adm.to(dev)
    seen_t = []

    def adm_seen(x, t):
        seen_t.append(t)
        return adm(x, t)

    eps_model = make_imagenet_diffusion(DDIM_RESPACING)._wrap_model(adm_seen)
    x1, xe, te, job = plain_side
    adm.dtype = torch.bfloat16
    zero = {k: 0 for k in launch_counts()}

    def census_times(n):
        return {**zero, **{k: v * n for k, v in adm_per_eval.items()}}

    dm = DefendedModel(adm, clf, PurifyConfig(diffusion_type="ddpm", t=GUIDED_T,
                                              grad_mode="none"), log_every=0, resize_to=256)
    x224 = torch.from_numpy(rng.uniform(size=(ADM_N, 224, 224, 3)).astype(np.float32)).to(dev)
    x256 = torch.from_numpy(rng.uniform(-1, 1, (ADM_N, 256, 256, 3)).astype(np.float32)).to(dev)
    for what, t, fn in (
            ("ancestral", GUIDED_T, lambda run: dm(x224, SEED + 70 + run)),
            ("ddim", DDIM_T, lambda run: discrete_purify(torch, adm, x256, SEED + 72 + run,
                                                         DDIM_T, True))):
        for run in ("cold", "warm"):
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            with torch.inference_mode(), count_nfe() as nfe:
                res = fn(run == "warm")
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = launch_counts()
            out["runs"].append(dict(what=what, t=t, run=run, wall_s=wall,
                                    images_per_s=ADM_N / wall, ms_per_eval=wall / t * 1e3,
                                    counts=counts, nfe=dict(nfe.counts)))
            log(f"  {what:9s} t={t} {run}: {wall:.3f} s, {ADM_N / wall:.4f} purified images/s "
                f"({wall / t * 1e3:.1f} ms per evaluation) on {smi}; {nfe.report()}; "
                f"launches {counts}")
            if counts != census_times(t) or nfe.counts != {"guided_ddpm": t}:
                raise AssertionError(f"{what}: launch counts {counts} != {census_times(t)} "
                                     f"or NFE {dict(nfe.counts)}")
            shape = (ADM_N, 1000) if what == "ancestral" else (ADM_N, 256, 256, 3)
            if tuple(res.shape) != shape or not bool(torch.isfinite(res).all()):
                raise AssertionError(f"{what}: bad output, shape {tuple(res.shape)}")

    card = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        adm.dtype = dtype
        for ddim in (False, True):
            reset_launch_counts()
            with torch.inference_mode():
                card[dtype_name, ddim] = discrete_purify(
                    torch, adm, x1.to(dev), FixedDiscreteNoise(SEED + 74), DISCRETE_PARITY_T,
                    ddim).cpu()
            if launch_counts() != census_times(DISCRETE_PARITY_T):
                raise AssertionError(f"t={DISCRETE_PARITY_T} {dtype_name}: launches "
                                     f"{launch_counts()}")
        reset_launch_counts()
        with torch.inference_mode():
            card[dtype_name, "eps"] = eps_model(xe.to(dev), te.to(dev)).float().cpu()
        if launch_counts() != census_times(1):
            raise AssertionError(f"the ADM at a float timestep, {dtype_name}: launches "
                                 f"{launch_counts()}")
    adm.dtype = torch.bfloat16
    w = torch.from_numpy(rng.standard_normal((1, 256, 256, 3)).astype(np.float32)).to(dev)
    xg = x1.to(dev).requires_grad_(True)
    reset_launch_counts()
    purified = discrete_purify(torch, adm, xg, FixedDiscreteNoise(SEED + 75),
                               DISCRETE_PARITY_T, False, grad_mode="checkpoint")
    (gx,) = torch.autograd.grad((w * purified.float()).sum(), xg)
    torch.cuda.synchronize()
    grad_counts_ = launch_counts()
    want_grad = census_times(2 * DISCRETE_PARITY_T)  # the loop, then its recomputation
    out["gradient"] = dict(counts=grad_counts_, abs_max=float(gx.abs().max()),
                           finite=bool(torch.isfinite(gx).all()))
    log(f"  input gradient, t={DISCRETE_PARITY_T}, bf16, checkpoint: max |grad| "
        f"{out['gradient']['abs_max']:.3e}; launches {grad_counts_}")
    if not out["gradient"]["finite"] or out["gradient"]["abs_max"] == 0 \
            or grad_counts_ != want_grad:
        raise AssertionError(f"guided DDPM gradient: finite {out['gradient']['finite']}, "
                             f"launches {grad_counts_} != {want_grad}")

    plain, cpu_seen_t = cpu.result(job)
    want_t = float(make_imagenet_diffusion(DDIM_RESPACING).timestep_map[GUIDED_EPS_INDEX])
    for t in seen_t + cpu_seen_t:
        if t.dtype != torch.float32 or t.tolist() != [want_t]:
            raise AssertionError(f"the ddim50 process gave the ADM {t} (want [{want_t}], "
                                 f"float32)")
    bounds = {("float32", False): ADM_PURIFY_REL, ("float32", True): ADM_PURIFY_REL,
              ("float32", "eps"): ADM_EVAL_REL["float32"],
              ("bfloat16", False): GUIDED_T2_BF16_REL, ("bfloat16", True): GUIDED_T2_BF16_REL,
              ("bfloat16", "eps"): GUIDED_EPS_BF16_REL}
    for (dtype_name, ddim), got in card.items():
        bound = bounds[dtype_name, ddim]
        rec = rel_check(torch, got, plain[ddim], bound)
        key = f"{dtype_name}/" + (f"eps at t={want_t}" if ddim == "eps"
                                   else "ddim" if ddim else "ancestral")
        out["checks"][key] = rec
        log(f"  {key:24s}: max |card - cpu fp32| {rec['max_abs_err']:.3e} (rel "
            f"{rec['rel_err']:.2e} <= {bound:.0e}) {'ok' if rec['ok'] else 'FAIL'}")
    bad = [k for k, v in out["checks"].items() if not v["ok"]]
    if bad:
        raise AssertionError(f"guided DDPM card against CPU: {bad} disagree")
    return out


def start_guided_plain(torch, cpu, adm, rng):
    """Draw phase 23(c)'s inputs and submit its CPU side to ``cpu`` on the
    CPU copy of the ADM: (x1, xe, te, job)."""
    import numpy as np

    te = torch.tensor([GUIDED_EPS_INDEX], dtype=torch.int32)
    xe = torch.from_numpy(rng.standard_normal((1, 256, 256, 3)).astype(np.float32) * 0.5)
    x1 = torch.from_numpy(rng.uniform(-0.9, 0.9, (1, 256, 256, 3)).astype(np.float32))
    adm_cpu = cpu.copy("adm", adm)
    return x1, xe, te, cpu.submit("phase 23", lambda: guided_outputs_plain(
        torch, adm_cpu, x1, xe, te))


def guided_outputs_plain(torch, adm, x1, xe, te):
    """Phase 23(c)'s CPU side, fp32: the t=DISCRETE_PARITY_T purifications
    of x1, ancestral and DDIM, with FixedDiscreteNoise(SEED + 74), and the
    ADM's output at (xe, respaced index te) through the DDIM_RESPACING
    process's wrapped model; ({False, True, "eps"}: tensor), and the
    timesteps the ADM saw there."""
    from diffpure_tpu_torch.purify import make_imagenet_diffusion

    seen_t = []

    def adm_seen(x, t):
        seen_t.append(t)
        return adm(x, t)

    eps_model = make_imagenet_diffusion(DDIM_RESPACING)._wrap_model(adm_seen)
    out = {}
    adm.dtype = torch.float32
    with torch.inference_mode():
        for ddim in (False, True):
            out[ddim] = discrete_purify(torch, adm, x1, FixedDiscreteNoise(SEED + 74),
                                        DISCRETE_PARITY_T, ddim)
        out["eps"] = eps_model(xe, te)
    adm.dtype = torch.bfloat16
    return out, seen_t


def build_celebahq(torch, dev):
    """The full-width SDEdit DDPM UNet (fp32 parameters) and the
    celebahq__Smiling attribute classifier, seeded normal weights (the
    CLI's seeds), built on the meta device."""
    from diffpure_tpu_torch.models import DDPMUNet
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    with torch.device("meta"):
        unet = DDPMUNet()
    sd = seeded_normal_state_dict(unet, SEED)
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, assign=True)
    n_params = sum(p.numel() for p in unet.parameters())
    if n_params != CELEBAHQ_PARAMS:
        raise AssertionError(f"DDPMUNet has {n_params} params, expected {CELEBAHQ_PARAMS}")
    clf = seeded_classifier(torch, "celebahq__Smiling")
    return unet.eval().requires_grad_(False).to(dev), clf.to(dev)


def celebahq_kernel_census(census):
    """ddpm_unet.halo_census's stages as phase_adm_kernels' census: each
    stage one group_stats call at (H, C, "pre_shift" or "plain") and one
    halo conv at (H, cin, cout, skip kind, skip channels)."""
    from collections import Counter

    out = Counter()
    for ((_, H, _, cin), cout, cr, proj, pre), calls in census.items():
        out["group_stats", (H, cin, "pre_shift" if pre else "plain")] += calls
        kind = "none" if cr == 0 else ("proj" if proj else "identity")
        out["gn_silu_conv3x3_halo", (H, cin, cout, kind, cr)] += calls
    return dict(out)


def phase_celebahq(torch, dev, rng, smi, cpu):
    """Phase 24: the CelebA-HQ defence. The UNet's halo census
    (ddpm_unet.halo_census) at batch CELEBAHQ_N and 1 in both dtypes, every
    stage a shape check_halo_shape takes, and #6 and #8 against their plain
    versions at each shape of the batch-CELEBAHQ_N census (the same in both
    dtypes), bf16 and fp32, at REL (phase_adm_kernels); (a) DefendedModel with
    diffusion_type 'celebahq-ddpm' at t=CELEBAHQ_T, batch CELEBAHQ_N, bf16
    then fp32, cold and warm, ms per evaluation, #6 and #8 exactly
    CELEBAHQ_STAGES a step and every other kernel 0, and one evaluation's
    device time by kernel family (profile_eval); (b) one evaluation at
    batch 1 and the t=DISCRETE_PARITY_T purification, fp32 and bf16 on the
    card against the CPU's fp32; (c) the attribute classifier, card against
    CPU, fp32. The CPU's side of (b) and (c) is a job of ``cpu`` on copies of
    the two models, submitted after the timed runs; returns the records and
    the function that joins it and checks."""
    import numpy as np
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.models.ddpm_unet import halo_census
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.ops.halo_conv import check_halo_shape
    from diffpure_tpu_torch.purify import PurifyConfig
    from diffpure_tpu_torch.utils.profiling import count_nfe

    unet, clf = build_celebahq(torch, dev)
    out = dict(runs=[], checks={}, census={})
    for dtype_name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        for n in (CELEBAHQ_N, 1):
            census = halo_census(n, dtype)
            for (x_shape, cout, cr, proj, _), _ in census.items():
                check_halo_shape(dtype or torch.float32, x_shape, (3, 3, x_shape[3], cout), cr,
                                 proj)
            stages, pre = sum(census.values()), sum(c for k, c in census.items() if k[4])
            out["census"][f"{dtype_name}/{n}"] = dict(stages=stages, pre_shift=pre,
                                                      shapes=len(census))
            if stages != CELEBAHQ_STAGES or 2 * pre != stages:
                raise AssertionError(f"halo census {dtype_name} batch {n}: {stages} stages, "
                                     f"{pre} with pre_shift")
    log(f"  halo census: {CELEBAHQ_STAGES} stages an evaluation (half with pre_shift), every "
        f"shape one the kernels take: {out['census']}")
    kernel_census = celebahq_kernel_census(halo_census(CELEBAHQ_N))
    if kernel_census != celebahq_kernel_census(halo_census(CELEBAHQ_N, torch.bfloat16)):
        raise AssertionError("the fp32 and bf16 UNets' halo stages differ")
    log(f"  #6 and #8 against plain at the census's {len(kernel_census)} shapes, bf16 and "
        f"fp32, batch {CELEBAHQ_N}:")
    out["kernel_shapes"] = phase_adm_kernels(torch, dev, kernel_census, n=CELEBAHQ_N,
                                             device_time=False)
    want = {**{k: 0 for k in launch_counts()},
            "group_stats": CELEBAHQ_STAGES * CELEBAHQ_T,
            "gn_silu_conv3x3_halo": CELEBAHQ_STAGES * CELEBAHQ_T}
    x = torch.from_numpy(rng.uniform(size=(CELEBAHQ_N, 256, 256, 3)).astype(np.float32)).to(dev)
    dm = DefendedModel(unet, clf, PurifyConfig(diffusion_type="celebahq-ddpm", t=CELEBAHQ_T,
                                               grad_mode="none"), log_every=0)
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        unet.dtype = dtype
        for run in ("cold", "warm"):
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            with torch.inference_mode(), count_nfe() as nfe:
                logits = dm(x, SEED + 80)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = launch_counts()
            out["runs"].append(dict(dtype=dtype_name, run=run, wall_s=wall,
                                    ms_per_eval=wall / CELEBAHQ_T * 1e3,
                                    images_per_s=CELEBAHQ_N / wall, counts=counts))
            log(f"  celebahq-ddpm t={CELEBAHQ_T} {dtype_name} {run}: {wall:.3f} s, "
                f"{wall / CELEBAHQ_T * 1e3:.2f} ms per evaluation, {CELEBAHQ_N / wall:.3f} "
                f"purified images/s on {smi}; {nfe.report()}; launches {counts}")
            if counts != want or nfe.counts != {"celebahq_ddpm": CELEBAHQ_T}:
                raise AssertionError(f"CelebA-HQ launch counts {counts} != {want}")
            if tuple(logits.shape) != (CELEBAHQ_N, 2) or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"bad attribute logits, shape {tuple(logits.shape)}")

    # one evaluation's device time by kernel family and the idle share
    # (profile_eval), at the timed runs' batch, in each dtype
    out["profile"] = {}
    tp = torch.full((CELEBAHQ_N,), CELEBAHQ_T - 1, dtype=torch.int32, device=dev)
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        unet.dtype = dtype
        prof = profile_eval(torch, unet, x * 2 - 1, tp)
        prof.pop("chain_steps", None)
        out["profile"][dtype_name] = prof
        log(f"  one evaluation, {dtype_name}, batch {CELEBAHQ_N}: wall "
            f"{prof['wall_ms_per_eval']:.2f} ms, device {prof['device_ms_per_eval']:.2f} ms, "
            f"idle share {prof['idle_share']:.3f}; by family "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(prof["by_family"].items(),
                                                             key=lambda kv: -kv[1])))

    x1 = torch.from_numpy(rng.uniform(size=(1, 256, 256, 3)).astype(np.float32))
    xe = torch.from_numpy(rng.standard_normal((1, 256, 256, 3)).astype(np.float32) * 0.5)
    te = torch.tensor([400], dtype=torch.int32)
    cfg = PurifyConfig(diffusion_type="celebahq-ddpm", t=DISCRETE_PARITY_T, grad_mode="none")
    unet_cpu, clf_cpu = cpu.copy("celebahq unet", unet), cpu.copy("attribute net", clf)
    job = cpu.submit("phase 24", lambda: celebahq_outputs(
        torch, unet_cpu, clf_cpu, x1, xe, te, cfg, (("float32", torch.float32),)))
    t0 = time.time()
    card = celebahq_outputs(torch, unet, clf, x1.to(dev), xe.to(dev), te.to(dev), cfg,
                            (("float32", torch.float32), ("bfloat16", torch.bfloat16)))
    log(f"  card: {time.time() - t0:.1f} s; the CPU's side runs beside the CLI runs")

    def finish():
        plain = cpu.result(job)
        check_celebahq_outputs(torch, card, plain, out)
        return out

    return out, finish


def celebahq_outputs(torch, unet, clf, x1, xe, te, cfg, dtypes):
    """Phase 24(b)'s and (c)'s outputs on the device of ``x1``: the UNet's
    evaluation at (xe, te) and the purification of x1 under ``cfg`` with
    FixedDiscreteNoise(SEED + 81) in each of ``dtypes``, and the attribute
    net's logits of x1 (fp32); on the CPU. Leaves ``unet`` fp32."""
    from diffpure_tpu_torch.eval import DefendedModel

    res = {}
    with torch.inference_mode():
        for dtype_name, dtype in dtypes:
            unet.dtype = dtype
            res["eval", dtype_name] = unet(xe, te).float().cpu()
            res["purify", dtype_name] = DefendedModel(unet, clf, cfg, log_every=0).purify(
                x1, FixedDiscreteNoise(SEED + 81)).cpu()
        res["attribute"] = clf(x1).cpu()
    unet.dtype = torch.float32
    return res


def check_celebahq_outputs(torch, card, cpu, out):
    """Phase 24's card-against-CPU checks, into out["checks"]: the
    evaluation and the purification in each dtype against the CPU's fp32,
    and the attribute net at ZOO_REL."""
    bounds = {("eval", "float32"): ADM_EVAL_REL["float32"],
              ("eval", "bfloat16"): ADM_EVAL_REL["bfloat16"],
              ("purify", "float32"): ADM_PURIFY_REL, ("purify", "bfloat16"): SLICE_REL["bfloat16"]}
    for (what, dtype_name), bound in bounds.items():
        rec = rel_check(torch, card[what, dtype_name], cpu[what, "float32"], bound)
        out["checks"][f"{what}/{dtype_name}"] = rec
        log(f"  {what:6s} {dtype_name:8s}: max |card - cpu fp32| {rec['max_abs_err']:.3e} (rel "
            f"{rec['rel_err']:.2e} <= {bound:.0e}) {'ok' if rec['ok'] else 'FAIL'}")
    rec = rel_check(torch, card["attribute"], cpu["attribute"], ZOO_REL)
    out["checks"]["attribute"] = rec
    log(f"  attribute net fp32: max |card - cpu| {rec['max_abs_err']:.3e} (rel "
        f"{rec['rel_err']:.2e} <= {ZOO_REL:.0e}) {'ok' if rec['ok'] else 'FAIL'}")
    bad = [k for k, v in out["checks"].items() if not v["ok"]]
    if bad:
        raise AssertionError(f"CelebA-HQ card against CPU: {bad} disagree")
    return out


def celebahq_fixture(rng, root):
    """CELEBAHQ_FIXTURE seeded JPEGs in root/dataset/celebahq/images/, the
    CelebA attribute list (Eyeglasses, Male, Smiling) and the partition list
    beside them (every third image in the val partition), and the repo's
    configs/celeba.yml."""
    import shutil

    from PIL import Image

    d = root / "dataset" / "celebahq"
    (d / "images").mkdir(parents=True)
    names = [f"{i:06d}.jpg" for i in range(CELEBAHQ_FIXTURE)]
    for name in names:
        Image.fromarray(rng.integers(0, 256, (300, 300, 3), dtype="uint8")).save(
            d / "images" / name)
    attrs = rng.choice([-1, 1], size=(len(names), 3))
    (d / "list_attr_celeba.txt").write_text(
        f"{len(names)}\nEyeglasses Male Smiling\n"
        + "".join(f"{n} {' '.join(str(v) for v in a)}\n" for n, a in zip(names, attrs)))
    (d / "list_eval_partition.txt").write_text(
        "".join(f"{n} {i % 3}\n" for i, n in enumerate(names)))
    (root / "configs").mkdir()
    shutil.copy(REPO / "configs" / "celeba.yml", root / "configs" / "celeba.yml")


def phase_new_cli(torch, dev, rng, smi):
    """Phases 22 and 24's CLI runs: ``python -m diffpure_tpu_torch.cli`` on
    NEW_CLI_RUNS's scripts at once (processes of their own, tiny budgets,
    random weights, each script's fp32): StAdv on a seeded CIFAR-10 fixture
    labelled by the CLI's ResNet-50, the two CelebA-HQ BPDA scripts on a
    seeded CelebA-HQ fixture. Each must exit 0, print its NFE report and
    results line, save its adversarial images and launch its path's
    kernels (StAdv #1-#5; CelebA-HQ #6 and #8, not #7, #9 or #10)."""
    import tempfile

    import numpy as np

    OUT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="new_cli_", dir=OUT))
    rn50 = seeded_classifier(torch, "cifar10-resnet-50")
    cifar_fixture(work / "stadv", rng.integers(0, 256, (64, 3072), dtype=np.uint8),
                  rn50.to(dev), dev)
    celebahq_fixture(rng, work / "celebahq")
    jobs, where = [], {}
    for tag, (script, budget) in NEW_CLI_RUNS.items():
        argv = script_flags(REPO / "run_scripts" / "torch" / script, budget)
        cwd = work / ("stadv" if tag.startswith("stadv") else "celebahq")
        code = TINY_STADV_CLI_CODE if tag.startswith("stadv") else CLI_WITH_COUNTS
        where[tag] = (cwd, argv)
        jobs.append((tag, cwd, ["-c", code, *argv, "--random_weights"]))
    runs = {}
    for tag, (rc, stdout, stderr, secs) in run_children(jobs, CLI_TIMEOUT_S).items():
        (OUT / f"cli_{tag}.log").write_text(stdout + "\n---- stderr\n" + stderr)
        lines = stdout.splitlines()
        nfe = [ln for ln in lines if ln.startswith("NFE total=")]
        results = [ln for ln in lines if ln.startswith("results: {")]
        counts = [json.loads(ln[len("launches: "):]) for ln in lines if ln.startswith("launches: ")]
        cwd, argv = where[tag]
        flag = dict(zip(argv[::2], argv[1::2]))
        version, kind = flag["--attack_version"], flag["--diffusion_type"]
        log_dir = cwd / "exp_results" / "images" / flag["--classifier_name"] / \
            f"{kind}_{version}" / "seed0" / "data0"
        saved = sorted(p.name for p in log_dir.glob("*.npy"))
        runs[tag] = dict(rc=rc, wall_s=secs, nfe=nfe, results=results, saved=saved,
                         counts=counts[-1] if counts else None)
        log(f"  {tag}: rc {rc}, done {secs:.1f} s after the runs started together on the card; "
            f"{nfe[-1] if nfe else 'no NFE report'}; {results[-1][:200] if results else 'no results'}"
            f"; saved {saved}; launches {counts[-1] if counts else None}")
        c = counts[-1] if counts else {}
        if version == "stadv":
            want_saved = "x_adv_defended_stadv.npy"
            path_ok = bool(c) and min(c[k] for k in (*KERNELS, *BWD_KERNELS)) > 0
        else:
            want_saved = "x_adv_bpda.npy"
            path_ok = bool(c) and c["group_stats"] > 0 and c["gn_silu_conv3x3_halo"] > 0 \
                and c["gn_film_silu_apply"] == c["flash_attention"] == \
                c["group_norm_silu_fused"] == 0
        if rc != 0 or not nfe or not results or want_saved not in saved or not path_ok:
            log(stderr[-3000:])
            raise AssertionError(f"the CLI's {tag} run failed (chip_smoke_out/cli_{tag}.log)")
    return runs


def train_recipe(torch):
    """The --large defence demo's configuration and its score model (the
    full-width configs/cifar10.yml NCSN++ at dropout 0), fp32, with seeded
    random-normal weights."""
    import numpy as np
    from diffpure_tpu_torch.experiments import defense_demo as demo
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    cfg = demo.config_from_args(demo.build_parser().parse_args(["--large"]))
    model = demo.demo_score_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != CIFAR_PARAMS:
        raise AssertionError(f"the --large score model has {n_params} params, expected "
                             f"{CIFAR_PARAMS}")
    sd = seeded_normal_state_dict(model, SEED + 40)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return cfg, model


def train_state(torch, model, cfg, warmup=None):
    """The recipe's optimizer (Adam, lr cfg.score_lr, its warmup, clip 1)
    and a fresh step state with its EMA."""
    from diffpure_tpu_torch.models.ema import ExponentialMovingAverage
    from diffpure_tpu_torch.training import get_optimizer

    opt = get_optimizer(lr=cfg.score_lr, warmup=cfg.score_warmup if warmup is None else warmup)
    params = list(model.parameters())
    return opt, dict(params=model, opt_state=opt.init(params), step=0,
                     ema=ExponentialMovingAverage(params, cfg.ema_rate, use_num_updates=False))


def train_parity_step(torch, model, cfg, x, draws):
    """One step of the recipe with the given draws, on x's device: the loss,
    every gradient by name, Adam's moments after the step, and whether the
    weights and the EMA still equal the weights before it (the warmup's
    first update has a learning rate of 0), all on the CPU."""
    from diffpure_tpu_torch.diffusion import VPSDE
    from diffpure_tpu_torch.training import get_sde_loss_fn, get_step_fn

    opt, state = train_state(torch, model, cfg)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    loss = get_sde_loss_fn(VPSDE(), True)(None, model, x, draws)
    grads = torch.autograd.grad(loss, params)
    state, step_loss = get_step_fn(VPSDE(), train=True, optimizer=opt)(state, x, draws=draws)
    return dict(
        loss=float(loss.detach()), step_loss=float(step_loss),
        grads={n: g.detach().cpu() for n, g in zip(names, grads)},
        mu={n: m.cpu() for n, m in zip(names, state["opt_state"]["mu"])},
        nu={n: v.cpu() for n, v in zip(names, state["opt_state"]["nu"])},
        weights_unchanged=all(torch.equal(p, b) for p, b in zip(params, before)),
        ema_unchanged=all(torch.equal(s, b) for s, b in zip(state["ema"].shadow_params, before)))


def optimizer_updates(torch, model, cfg, grads):
    """The recipe's optimizer without its warmup (lr cfg.score_lr from the
    first update) and its EMA, from a fresh state, fed the given gradients
    (one list, on the CPU, per update) in the order of the model's
    parameters: the weights before and after, and the EMA after, by name,
    on the CPU. Each update is get_step_fn's after its gradient: Adam's
    update (the clip included), apply_updates, the EMA."""
    from diffpure_tpu_torch.training.losses import apply_updates

    opt, state = train_state(torch, model, cfg, warmup=0)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    before = {n: p.detach().cpu().clone() for n, p in zip(names, params)}
    for g in grads:
        updates, state["opt_state"] = opt.update([t.to(params[0].device) for t in g],
                                                 state["opt_state"], params)
        apply_updates(params, updates)
        state["ema"].update(params)
    return dict(before=before,
                weights={n: p.detach().cpu().clone() for n, p in zip(names, params)},
                ema={n: s.cpu().clone() for n, s in zip(names, state["ema"].shadow_params)})


def update_grads(torch, grads):
    """Two updates' gradients from one gradient (by name): scaled to a global
    norm of 2 (the clip at 1 scales it) and of 0.5 (the clip leaves it)."""
    g = list(grads.values())
    norm = float(sum(float(t.double().square().sum()) for t in g)) ** 0.5
    return [[t * (2.0 / norm) for t in g], [t * (0.5 / norm) for t in g]]


def check_optimizer_parity(torch, card, cpu, zero):
    """The weights and the EMA after two updates on the same gradients, card
    against CPU, per tensor: within TRAIN_GRAD_REL of the largest change
    the CPU's update made to the tensor plus two float32 ulps of the
    tensor's largest value. A tensor must have moved on both sides (the
    EMA too) unless its gradient is zero but for rounding (named in
    ``zero``): Adam moves those by far less than its learning rate, and
    the EMA by less than an ulp."""
    worst = {}
    for what in ("weights", "ema"):
        worst[what] = (0.0, None)
        for name, want in cpu[what].items():
            got, start = card[what][name], cpu["before"][name]
            moved = float((want - start).abs().max())
            if name not in zero and not (
                    moved > 0 and float((got - start).abs().max()) > 0):
                raise AssertionError(f"optimizer: {what} {name} did not move")
            err = float((got - want).abs().max())
            bound = TRAIN_GRAD_REL * moved + 2 * F32_ULP * float(want.abs().max())
            if not err <= bound:
                raise AssertionError(f"optimizer: {what} {name} card against CPU {err:.3e} > "
                                     f"{bound:.3e} (the update moved it by {moved:.3e})")
            if moved > 0:
                worst[what] = max(worst[what], (err / moved, name), key=lambda r: r[0])
    log("  (iii) two Adam updates (lr 1e-3; clipped, then not) and the EMA on the same "
        "gradients, card against CPU, worst err / the update's largest change per tensor: "
        + ", ".join(f"{k} {v[0]:.2e} ({v[1]})" for k, v in worst.items()))
    return worst


def hold_grads(got, want, rel, what, zero=None, skip=()):
    """Each tensor of got within ``rel`` of the max of want's tensor of the
    same name, but those named in ``skip``. ``zero``: a list that collects
    the names of gradients that are zero but for rounding (under ZERO_GRAD
    of want's largest): those must stay under that bound on got's side and
    are left out of the relative check. Returns the worst (rel err,
    name)."""
    top = max(float(g.abs().max()) for g in want.values())
    worst = (0.0, None)
    for name, w in want.items():
        g = got[name]
        scale = float(w.abs().max())
        if name in skip:
            continue
        if zero is not None and scale < ZERO_GRAD * top:
            zero.append(name)
            if float(g.abs().max()) >= ZERO_GRAD * top:
                raise AssertionError(f"{what} {name}: {float(g.abs().max()):.3e} where the "
                                     f"yardstick's is zero but for rounding")
            continue
        rel_err = float((g - w).abs().max()) / scale
        if not rel_err <= rel:
            raise AssertionError(f"{what} {name}: rel {rel_err:.3e} > {rel}")
        worst = max(worst, (rel_err, name), key=lambda r: r[0])
    return worst


def check_train_parity(torch, card, cpu):
    """Card against CPU: the loss, each gradient (and Adam's first moment)
    within TRAIN_GRAD_REL of the CPU's max per tensor, the second moment
    within twice that (it squares the gradient); a gradient that is zero
    but for rounding stays under ZERO_GRAD of the largest on both sides."""
    out = dict(loss=(card["loss"], cpu["loss"]), weights_unchanged=card["weights_unchanged"],
               ema_unchanged=card["ema_unchanged"])
    zero = []
    worst = dict(grads=hold_grads(card["grads"], cpu["grads"], TRAIN_GRAD_REL,
                                  "grads, card against CPU", zero=zero))
    for what, rel in (("mu", TRAIN_GRAD_REL), ("nu", 2 * TRAIN_GRAD_REL)):
        worst[what] = hold_grads(card[what], cpu[what], rel, f"{what}, card against CPU",
                                 skip=zero)
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    log(f"  loss card {card['loss']:.6f} / CPU {cpu['loss']:.6f} (rel {loss_rel:.2e}); worst "
        f"rel err per tensor: " + ", ".join(f"{k} {v[0]:.2e} ({v[1]})" for k, v in worst.items())
        + f"; {len(zero)} gradients zero but for rounding ({', '.join(zero[:3])} ...)")
    if not (loss_rel <= TRAIN_FWD_REL
            and abs(card["step_loss"] - card["loss"]) <= 1e-6 * abs(card["loss"])
            and card["weights_unchanged"] and cpu["weights_unchanged"]
            and card["ema_unchanged"] and cpu["ema_unchanged"]):
        raise AssertionError(f"the training step: card {dict((k, card[k]) for k in ('loss', 'step_loss', 'weights_unchanged', 'ema_unchanged'))}, CPU loss {cpu['loss']}")
    out.update(loss_rel=loss_rel, worst=worst, zero_grads=zero)
    return out


def plain_blocks(torch):
    """A context in which the NCSN++'s residual and attention blocks take
    their plain PyTorch versions (autograd of plain ops, weight and input
    gradients alike) on CUDA tensors: the yardstick the kernels' path is
    held against on the card. CPU tensors keep the wrappers, so a CPU side
    running meanwhile is unaffected."""
    from diffpure_tpu_torch.models import layers
    from diffpure_tpu_torch.ops import fused_attnblock as fab
    from diffpure_tpu_torch.ops import fused_resblock as frb

    wrappers = dict(fused_resblock=layers.fused_resblock,
                    fused_resblock_cat=layers.fused_resblock_cat,
                    fused_attnblock=layers.fused_attnblock)

    def block(x, temb, params, *, packed=None, packed_bwd=None, **kw):
        if x.device.type != "cuda":
            return wrappers["fused_resblock"](x, temb, params, **kw)
        return frb.fused_resblock_reference(x, temb, params, **kw)

    def block_cat(x1, x2, temb, params, *, packed=None, packed_bwd=None, **kw):
        if x1.device.type != "cuda":
            return wrappers["fused_resblock_cat"](x1, x2, temb, params, **kw)
        return frb.fused_resblock_reference(torch.cat([x1, x2], dim=-1), temb, params, **kw)

    def attn(x, params, *, packed=None, **kw):
        if x.device.type != "cuda":
            return wrappers["fused_attnblock"](x, params, **kw)
        return fab.fused_attnblock_reference(x, params, **kw)

    return mock.patch.multiple(layers, fused_resblock=block, fused_resblock_cat=block_cat,
                               fused_attnblock=attn)


def kernels_against_plain(torch, model, what, fn, counts=None):
    """``fn() -> (value, {name: gradient})`` on the card twice: through the
    kernels, then with the blocks on their plain versions. The value at
    TRAIN_FWD_REL, each gradient at TRAIN_GRAD_REL of the plain one's max
    (a gradient zero but for rounding under ZERO_GRAD of the largest on
    both routes). The kernels' route must launch ``counts`` (or, without
    them, each of #1-#5 at least once, every backward kernel as often as
    its forward, nothing else); the plain route launches nothing."""
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts

    runs = {}
    for route in ("kernels", "plain"):
        reset_launch_counts()
        with plain_blocks(torch) if route == "plain" else contextlib.nullcontext():
            value, grads = fn()
        torch.cuda.synchronize()
        runs[route] = dict(value=value.detach().cpu(), launches=launch_counts(),
                           grads={n: g.detach().cpu() for n, g in grads.items()})
        del value, grads
    got, want = runs["kernels"], runs["plain"]
    c = got["launches"]
    if counts is None:
        counts = {k: 0 for k in c}
        for f, b in (("fused_resblock", "fused_resblock_bwd"),
                     ("fused_resblock_cat", "fused_resblock_cat_bwd")):
            counts[f] = counts[b] = max(c[f], 1)
        counts["fused_attnblock"] = max(c["fused_attnblock"], 1)
    if c != counts or any(want["launches"].values()):
        raise AssertionError(f"{what}: launches on the kernels' route {c} (want {counts}), "
                             f"on the plain route {want['launches']}")
    scale = float(want["value"].abs().max())
    value_rel = float((got["value"] - want["value"]).abs().max()) / scale
    if not value_rel <= TRAIN_FWD_REL:
        raise AssertionError(f"{what}: kernels against plain rel {value_rel:.3e} > "
                             f"{TRAIN_FWD_REL}")
    zero = []
    worst = hold_grads(got["grads"], want["grads"], TRAIN_GRAD_REL,
                       f"{what}, kernels against plain", zero=zero)
    log(f"  {what}: kernels against the plain blocks on the card: value rel {value_rel:.2e} "
        f"(<= {TRAIN_FWD_REL:.0e}), worst gradient rel {worst[0]:.2e} ({worst[1]}; <= "
        f"{TRAIN_GRAD_REL:.0e}), {len(zero)} zero but for rounding; launches {c}")
    return dict(value_rel=value_rel, worst_grad=worst, zero_grads=zero, launches=c)


def step_grads(torch, model, x, draws):
    """The recipe's loss at x with the given draws, and its gradient with
    respect to every parameter, by name."""
    from diffpure_tpu_torch.diffusion import VPSDE
    from diffpure_tpu_torch.training import get_sde_loss_fn

    names = [n for n, _ in model.named_parameters()]
    loss = get_sde_loss_fn(VPSDE(), True)(None, model, x, draws)
    return loss, dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


def seeded_draws(torch, rng, x):
    """t in [1e-5, 1) and z like x, from numpy's rng, on x's device."""
    import numpy as np

    n = x.shape[0]
    return dict(t=torch.from_numpy(rng.uniform(1e-5, 1.0, n).astype(np.float32)).to(x.device),
                z=torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32)
                                   ).to(x.device))


def phase_demo_shapes(torch, dev, rng):
    """Phase 25(c)'s shapes before the demo runs: its default score model
    (nf 32, 16x16, seeded weights) on the card, kernels against the plain
    blocks: one step's loss and every gradient at its score batch, and the
    forward and the input gradient of the frozen model at the batch it is
    purified and attacked at."""
    import numpy as np
    from diffpure_tpu_torch.data.synthetic import sample_batch
    from diffpure_tpu_torch.experiments import defense_demo as demo
    from diffpure_tpu_torch.utils.prng import generator
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    cfg = demo.DemoConfig()
    model = demo.demo_score_model(cfg)
    sd = seeded_normal_state_dict(model, SEED + 46)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    model.to(dev)
    xb, _ = sample_batch(generator(SEED + 47, device=dev), DEMO_SCORE_N, demo.demo_spec(cfg))
    draws = seeded_draws(torch, rng, xb)
    out = dict(step=kernels_against_plain(
        torch, model, f"the demo's score model, one step at batch {DEMO_SCORE_N}",
        lambda: step_grads(torch, model, xb, draws)))
    model.requires_grad_(False)
    xe = torch.from_numpy(rng.uniform(-1, 1, (DEMO_EVAL_N, cfg.size, cfg.size, 3))
                          .astype(np.float32)).to(dev)
    te = torch.from_numpy(rng.uniform(0, 999, DEMO_EVAL_N).astype(np.float32)).to(dev)
    cot = torch.from_numpy(rng.standard_normal(tuple(xe.shape)).astype(np.float32)).to(dev)

    def fwd_input_grad():
        x = xe.clone().requires_grad_(True)
        y = model(x, te)
        return y, dict(x=torch.autograd.grad(y, x, cot)[0])

    out["eval"] = kernels_against_plain(
        torch, model, f"the demo's score model, forward and input gradient at batch "
        f"{DEMO_EVAL_N}", fwd_input_grad)
    return out


def train_step_parts(prof, steps):
    """Device ms a step by part from a profiled training step: the custom
    kernels outside the backward (#1 / #2; #3), within the blocks'
    backward node (#4 / #5), the other kernels there (the weight
    cotangents: the plain block recomputed and differentiated by a nested
    autograd call), #3's backward node (its plain autograd), the foreach
    kernels (optimizer, EMA, global norm), and the rest (the model's plain
    ops and their backward, the loss). "Within" a node is by time on its
    thread: the nested autograd call's nodes are not its children in the
    profiler's tree."""
    attn = ("attn_", "gn_regs_kernel")
    spans = {"blocks_bwd": [], "attn_bwd": []}
    events = [e for e in prof.events() if not str(e.device_type).endswith("CUDA")]
    for e in events:
        for place, node in (("blocks_bwd", "_FusedResblockBackward"),
                            ("attn_bwd", "KernelFunctionBackward")):
            if "evaluate_function" in e.name and node in e.name:
                spans[place].append((e.thread, e.time_range.start, e.time_range.end))
    parts, rest = {}, {}

    def where(e):
        for place, ivs in spans.items():
            if any(th == e.thread and a <= e.time_range.start <= b for th, a, b in ivs):
                return place
        p = e
        while p is not None:
            if "evaluate_function" in p.name:
                return "bwd"
            p = p.cpu_parent
        return "fwd"

    def where_name(e):
        p = e
        while p is not None and "evaluate_function" not in p.name:
            p = p.cpu_parent
        return p.name.split(": ")[-1] if p is not None else e.name

    for e in events:
        if not e.kernels:
            continue
        place = where(e)
        for k in e.kernels:
            own = any(f in k.name for f in OWN_KERNELS)
            if place == "blocks_bwd":
                label = "#4 / #5 (block backward kernels)" if own else \
                    "weight cotangents (plain block recomputed and differentiated)"
            elif place == "attn_bwd":
                label = "#3 backward (plain autograd, recomputed)"
            elif own:
                label = "#3 forward" if any(f in k.name for f in attn) else "#1 / #2 forward"
            elif "multi_tensor" in k.name or "foreach" in k.name.lower():
                label = "optimizer, EMA, global norm (foreach kernels)"
            else:
                label = ("rest, backward (the plain ops' autograd)" if place == "bwd" else
                         "rest, forward (plain ops: temb rows, stem, head, loss; packs)")
                top = rest.setdefault(label, {})
                key = (k.name[:70], e.name if place == "fwd" else where_name(e))
                top[key] = top.get(key, 0.0) + k.duration / 1e3 / steps
            parts[label] = parts.get(label, 0.0) + k.duration / 1e3 / steps
    for label, top in rest.items():
        for (kname, op), ms in sorted(top.items(), key=lambda kv: -kv[1])[:6]:
            parts[f"  {label[:14]}: {op[:40]} / {kname}"] = ms
    return parts


def profile_train_step(torch, run):
    """One training step ``run() -> (state, loss)`` under the profiler:
    (state, (wall ms, device ms, device ms by part)); the part "device
    kernels launched" is a count, not ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        state, _ = run()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    busy = sum((getattr(e, "self_device_time_total", 0) or 0) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time for the training step")
    parts = train_step_parts(prof, 1)
    parts["sum of the parts"] = sum(v for k, v in parts.items() if not k.startswith("  "))
    parts["device kernels launched"] = sum(len(e.kernels) for e in prof.events())
    return state, (wall, busy, parts)


def phase_train_step(torch, dev, rng, smi, cpu):
    """Phase 25(a): the --large demo's score-matching step on the card; its
    loss and gradients at batch TRAIN_N against the plain blocks' on the
    card. Returns (records, finish): finish joins the CPU's side (submitted
    to ``cpu``) and checks the batch-2 step, the two optimizer updates on
    its gradients and the forwards after the weights moved against it."""
    import numpy as np
    from diffpure_tpu_torch.data.synthetic import sample_batch
    from diffpure_tpu_torch.diffusion import VPSDE
    from diffpure_tpu_torch.experiments.defense_demo import demo_spec
    from diffpure_tpu_torch.models.ema import ExponentialMovingAverage
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.training import get_step_fn
    from diffpure_tpu_torch.utils.prng import generator

    cfg, model = train_recipe(torch)
    model_cpu = cpu.copy("train score model", model)
    model.to(dev)
    spec = demo_spec(cfg)
    want = {**{k: 0 for k in launch_counts()}, **TRAIN_STEP_COUNTS}
    # (iii) the loss and every gradient at batch TRAIN_N, kernels against
    # the plain blocks on the card
    xk, _ = sample_batch(generator(SEED + 48, device=dev), TRAIN_N, spec)
    draws_k = seeded_draws(torch, rng, xk)
    full = kernels_against_plain(torch, model, f"the full-width step at batch {TRAIN_N}",
                                 lambda: step_grads(torch, model, xk, draws_k), counts=want)
    del xk, draws_k
    # (iii) one step at batch 2 with seeded draws, then two optimizer
    # updates on its gradients; the CPU's side later
    x2 = torch.from_numpy(rng.uniform(-1, 1, (TRAIN_PARITY_N, 32, 32, 3)).astype(np.float32))
    draws = dict(t=torch.from_numpy(rng.uniform(1e-5, 1.0, TRAIN_PARITY_N).astype(np.float32)),
                 z=torch.from_numpy(rng.standard_normal(x2.shape).astype(np.float32)))
    t0 = time.time()
    card_parity = train_parity_step(torch, model, cfg, x2.to(dev),
                                    {k: v.to(dev) for k, v in draws.items()})
    upd = update_grads(torch, card_parity["grads"])
    card_opt = optimizer_updates(torch, model, cfg, upd)
    log(f"  (iii) one step at batch {TRAIN_PARITY_N} and two optimizer updates on the card: "
        f"{time.time() - t0:.1f} s; the CPU's side runs beside (c)")
    job_parity = cpu.submit("phase 25(a) step", lambda: dict(
        train_parity_step(torch, model_cpu, cfg, x2, draws),
        optimizer=optimizer_updates(torch, model_cpu, cfg, upd)))

    # (i) / (ii) warm steps of the recipe at batch TRAIN_N
    opt, state = train_state(torch, model, cfg)
    step_fn = get_step_fn(VPSDE(), train=True, optimizer=opt)

    def step(i):
        xb, _ = sample_batch(generator(SEED + 41, i, device=dev), TRAIN_N, spec)
        return step_fn(state, xb, generator(SEED + 42, i, device=dev))

    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state, loss = step(0)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    counts = launch_counts()
    log(f"  (i) cold step at batch {TRAIN_N}: {cold_s:.3f} s, loss {float(loss):.4f}; "
        f"launches {counts}")
    if counts != want:
        raise AssertionError(f"launches a training step {counts} != {want}")
    t0 = time.time()
    losses = []
    for i in range(1, 1 + TRAIN_WARM_STEPS):
        state, loss = step(i)
        losses.append(loss)
    issue_ms = (time.time() - t0) * 1e3 / TRAIN_WARM_STEPS
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / TRAIN_WARM_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(bool(torch.isfinite(v)) for v in losses):
        raise AssertionError(f"non-finite training loss {[float(v) for v in losses]}")
    state, (prof_wall, busy, parts) = profile_train_step(torch, lambda: step(1 + TRAIN_WARM_STEPS))
    n_kernels = parts.pop("device kernels launched")
    rec = dict(batch=TRAIN_N, cold_s=cold_s, wall_ms_per_step=wall_ms,
               host_issue_ms_per_step=issue_ms, device_kernels_per_step=n_kernels,
               steps_per_s=1e3 / wall_ms, peak_gib=peak, launches=counts,
               losses=[float(v) for v in losses], profiled_wall_ms=prof_wall,
               device_ms_per_step=busy, idle_share=max(0.0, 1.0 - busy / prof_wall),
               parts_ms=parts, adam_state_gib=sum(
                   t.numel() * 4 for t in state["opt_state"]["mu"] + state["opt_state"]["nu"])
               / 2 ** 30)
    rec["idle_share_unprofiled"] = max(0.0, 1.0 - busy / wall_ms)
    rec["kernels_against_plain"] = full
    log(f"  (i) warm: {wall_ms:.1f} ms a step, {rec['steps_per_s']:.3f} steps/s at batch "
        f"{TRAIN_N} on {smi}; under the profiler {prof_wall:.1f} ms of wall, {busy:.1f} of "
        f"device, idle share {rec['idle_share']:.3f} ({rec['idle_share_unprofiled']:.3f} "
        f"against the unprofiled wall); peak device memory {peak:.2f} GiB (Adam's moments "
        f"{rec['adam_state_gib']:.2f}); the host issues a step in {issue_ms:.1f} ms "
        f"({n_kernels} device kernels)")
    for label, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        log(f"    {label:66s} {ms:9.2f} ms")

    # (iv) the weights move; the kernels must follow
    xv = torch.from_numpy(rng.uniform(-1, 1, (TRAIN_PARITY_N, 32, 32, 3)).astype(np.float32))
    tv = torch.tensor([99.9, 700.0])

    def card_fwd():
        with torch.no_grad():
            return model(xv.to(dev), tv.to(dev)).cpu()

    out_before = card_fwd()
    opt2, state2 = train_state(torch, model, cfg, warmup=0)  # lr 1e-3 from the first step
    step2 = get_step_fn(VPSDE(), train=True, optimizer=opt2)
    ema = ExponentialMovingAverage(model, 0.999, use_num_updates=False)
    for i in range(2):
        xb, _ = sample_batch(generator(SEED + 43, i, device=dev), TRAIN_PARITY_N, spec)
        state2, _ = step2(state2, xb, generator(SEED + 44, i, device=dev))
    moved = {"after two steps": card_fwd()}
    w2 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    ema.store(model)
    ema.copy_to(model)
    moved["after EMA copy_to"] = card_fwd()
    shadow = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    ema.restore(model)
    moved["after restore"] = card_fwd()
    model.requires_grad_(False).cpu()

    def plain_forwards():
        out = {}
        for what, sd in (("after two steps", w2), ("after EMA copy_to", shadow)):
            model_cpu.load_state_dict(sd)
            with torch.no_grad():
                out[what] = model_cpu(xv, tv)
        return out

    job_fwd = cpu.submit("phase 25(a) forwards", plain_forwards)
    def finish():
        log("== phase 25(a)'s checks: the batch-2 step, card against the CPU's plain step")
        cpu_parity = cpu.result(job_parity)
        parity = check_train_parity(torch, card_parity, cpu_parity)
        parity["optimizer"] = check_optimizer_parity(torch, card_opt, cpu_parity["optimizer"],
                                                     parity["zero_grads"])
        plain = cpu.result(job_fwd)
        plain["after restore"] = plain["after two steps"]
        checks = {}
        for what, got in moved.items():
            want = plain[what]
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            checks[what] = dict(rel_err=err / scale, ok=err <= TRAIN_FWD_REL * scale)
        shift = float((plain["after two steps"] - out_before).abs().max()) / float(
            plain["after two steps"].abs().max())
        log(f"  (iv) forwards, card against the plain forward on the weights as they stand: "
            + ", ".join(f"{k} rel {v['rel_err']:.2e}" for k, v in checks.items())
            + f" (<= {TRAIN_FWD_REL:.0e}); the two steps moved the output by rel {shift:.2e}")
        if not all(v["ok"] for v in checks.values()) or shift <= 100 * TRAIN_FWD_REL \
                or not torch.equal(moved["after restore"], moved["after two steps"]):
            raise AssertionError(f"forwards after the weights moved: {checks}, shift {shift}")
        return dict(parity=parity, forwards=checks, forward_shift=shift)

    return rec, finish


def phase_train_loop(torch, dev, smi):
    """Phase 25(b): TrainLoop on the full-width score_sde DDPM (fp32, linear
    betas 1e-4 -> 2e-2 over 1000 steps, eps objective) at batch
    DDPM_TRAIN_N: a cold step with its launch counts, warm steps timed, then
    save, one more step, and the same step from a loop resumed from the
    checkpoint: the loss, weights, Adam's moments and EMA bit for bit
    (cuDNN held to deterministic algorithms for the phase)."""
    import shutil
    from diffpure_tpu_torch.data.synthetic import SyntheticSpec, dataset_iterator
    from diffpure_tpu_torch.diffusion import GaussianDiffusion, linear_beta_schedule
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.training.train_loop import TrainLoop

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ckpt_dir = OUT / "train_loop"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        diffusion = GaussianDiffusion(linear_beta_schedule(1000, 1e-4, 2e-2))
        data = dataset_iterator(SEED + 50, DDPM_TRAIN_N, SyntheticSpec(size=32), device=dev)
        batches = [next(data)[0] for _ in range(DDPM_TRAIN_WARM + 3)]

        def loop_for(model, **kw):
            return TrainLoop(model=model, diffusion=diffusion, data=data,
                             batch_size=DDPM_TRAIN_N, lr=1e-4, ema_rate=(0.9999,),
                             log_interval=10 ** 9, save_interval=10 ** 9,
                             checkpoint_dir=str(ckpt_dir), seed=SEED + 51, **kw)

        loop = loop_for(build_ddpm(torch, dev).requires_grad_(True))
        want = {**{k: 0 for k in launch_counts()}, **DDPM_TRAIN_COUNTS}
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        loop.run_step(batches[0])
        torch.cuda.synchronize()
        cold_s = time.time() - t0
        counts = launch_counts()
        if counts != want:
            raise AssertionError(f"TrainLoop launches a step {counts} != {want}")
        t0 = time.time()
        losses = [loop.run_step(b) for b in batches[1:1 + DDPM_TRAIN_WARM]]
        issue_ms = (time.time() - t0) * 1e3 / DDPM_TRAIN_WARM
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / DDPM_TRAIN_WARM
        losses = [float(v) for v in losses]
        _, (prof_wall, busy, parts) = profile_train_step(
            torch, lambda: (None, loop.run_step(batches[1 + DDPM_TRAIN_WARM])))
        path = loop.save()
        loss_on = loop.run_step(batches[-1])
        resumed = loop_for(build_ddpm(torch, dev).requires_grad_(True), resume_checkpoint=path)
        loss_re = resumed.run_step(batches[-1])
        same = dict(
            step=resumed.step == loop.step, loss=torch.equal(loss_re, loss_on),
            weights=all(torch.equal(a, b) for a, b in zip(loop.params, resumed.params)),
            adam=all(torch.equal(a, b) for k in ("mu", "nu")
                     for a, b in zip(loop.opt_state[k], resumed.opt_state[k])),
            ema=all(torch.equal(a, b) for a, b in zip(loop.emas[0].shadow_params,
                                                       resumed.emas[0].shadow_params)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(ckpt_dir, ignore_errors=True)  # 0.5 GB of checkpoint
    n_kernels = parts.pop("device kernels launched")
    rec = dict(batch=DDPM_TRAIN_N, cold_s=cold_s, wall_ms_per_step=wall_ms,
               steps_per_s=1e3 / wall_ms, launches=counts, losses=losses,
               resume_bit_exact=same, profiled_wall_ms=prof_wall, device_ms_per_step=busy,
               idle_share=max(0.0, 1.0 - busy / wall_ms), parts_ms=parts,
               host_issue_ms_per_step=issue_ms, device_kernels_per_step=n_kernels)
    log(f"  cold step {cold_s:.3f} s; warm {wall_ms:.1f} ms a step, {rec['steps_per_s']:.3f} "
        f"steps/s at batch {DDPM_TRAIN_N} on {smi}; {busy:.1f} ms of device a step (idle "
        f"share {rec['idle_share']:.3f} against the unprofiled wall); the host issues a step "
        f"in {issue_ms:.1f} ms ({n_kernels} device kernels, "
        f"{issue_ms * 1e3 / n_kernels:.1f} us each); losses "
        f"{[round(v, 4) for v in losses]}; launches {counts}; resumed against uninterrupted: "
        f"{same}")
    if not all(same.values()) or not all(map(lambda v: v == v, losses)):
        raise AssertionError(f"TrainLoop resume is not bit for bit: {same}")
    return rec


def phase_demo(torch, smi):
    """Phase 25(c): the defence demo through its entry point on the card, in
    a process of its own, at its default distribution with DEMO_ARGS'
    budgets: it must end with 0, launch #1-#5 while its score model trains
    and #1-#3 while it purifies, and report its accuracies (not a gate:
    the budgets are cut)."""
    import shutil

    out = OUT / "demo"
    shutil.rmtree(out, ignore_errors=True)  # no cached weights: the run trains
    argv = ["-c", DEMO_CODE, "--device", "cuda", "--out", str(out), *DEMO_ARGS]
    rc, stdout, stderr, secs = run_children([("demo", str(REPO), argv)], DEMO_TIMEOUT_S)["demo"]
    (OUT / "demo.log").write_text(stdout + "\n--- stderr ---\n" + stderr)
    if rc != 0:
        raise AssertionError(f"the defence demo exited with {rc}: {stderr[-2000:]}")
    marks = json.loads([ln for ln in stdout.splitlines() if ln.startswith("launches: ")][-1]
                       [len("launches: "):])
    a, b, c = (marks[k] for k in ("before_score_training", "after_score_training", "end"))
    training = {k: b[k] - a[k] for k in a}
    purifying = {k: c[k] - b[k] for k in a}
    results = json.loads((out / "results.json").read_text())
    (out / "trained_weights.pt").unlink()
    accs = dict(clean_undefended=results["clean_acc_undefended"],
                robust_undefended=results["robust_acc_undefended"],
                **{f"{k}_defended": v for k, v in results["sde"].items()
                   if not isinstance(v, (list, dict))})
    log(f"  {secs:.1f} s (process start to end) on {smi}; launches while the score model "
        f"trained {training}, while purifying and attacking {purifying}")
    log("  accuracies (budgets cut, not a gate): " + ", ".join(
        f"{k} {v:.3f}" for k, v in accs.items()))
    bad = [k for k in TRAIN_STEP_COUNTS if training[k] == 0] + \
        [k for k in ("fused_resblock", "fused_resblock_cat", "fused_attnblock") if purifying[k] == 0]
    if bad:
        raise AssertionError(f"the demo on the card never launched {bad}")
    return dict(seconds=secs, launches_training=training, launches_purifying=purifying,
                accuracies=accs, args=DEMO_ARGS)


def build_ve(torch, dev):
    """score_sde's VE NCSN++ (configs/cifar10_ve.yml), fp32, seeded weights
    (the Fourier projection at its initial scale), on ``dev``."""
    import numpy as np
    from diffpure_tpu_torch.config import load_config
    from diffpure_tpu_torch.models import ncsnpp_from_config
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    model = ncsnpp_from_config(load_config(str(REPO / "configs" / "cifar10_ve.yml"))).eval()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != VE_PARAMS:
        raise AssertionError(f"the VE NCSN++ has {n_params} params, expected {VE_PARAMS}")
    sd = seeded_normal_state_dict(model, SEED + 60)
    sd["all_modules.0.W"] = VE_FOURIER_SCALE * np.random.default_rng(SEED + 61).standard_normal(
        sd["all_modules.0.W"].shape).astype(np.float32)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return model.requires_grad_(False).to(dev)


def build_ncsnv2(torch, dev):
    """NCSNv2 (ncsnv2_64) at NCSNV2_CFG, seeded weights, on ``dev``."""
    import numpy as np
    from diffpure_tpu_torch.models.registry import create_model
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    model = create_model("ncsnv2_64", **NCSNV2_CFG).eval()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != NCSNV2_PARAMS:
        raise AssertionError(f"NCSNv2 has {n_params} params, expected {NCSNV2_PARAMS}")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                           seeded_normal_state_dict(model, SEED + 62).items()})
    return model.requires_grad_(False).to(dev)


def ve_score(model):
    """The VE SDE (N = 1000) and the continuous VE score of ``model``:
    its output at the noise scale sigma(t) as the label."""
    from diffpure_tpu_torch.diffusion import VESDE, get_score_fn

    sde = VESDE(sigma_min=0.01, sigma_max=50.0, N=1000)
    return sde, get_score_fn(sde, model, continuous=True)


def ncsnv2_score(model):
    """The VE SDE with NCSNv2's 232 scales and its discrete score: the
    model at the label round((T - t)(N - 1))."""
    from diffpure_tpu_torch.diffusion import VESDE, get_score_fn

    sde = VESDE(sigma_min=NCSNV2_CFG["sigma_min"], sigma_max=NCSNV2_CFG["sigma_max"],
                N=NCSNV2_CFG["num_scales"])
    return sde, get_score_fn(sde, model, continuous=False)


def ve_outputs(torch, model, x, t, seed):
    """Phase 26(a)'s card-against-CPU values on ``model``'s device: one
    evaluation in fp32 and in bf16, and two PC steps (reverse_diffusion +
    langevin, snr 0.16, the VE SDE cut to N = 2) in fp32 with the draws of
    a CPU generator seeded ``seed``. On the CPU the bf16 evaluation also
    records every top-level module's inputs and output (module_io); on the
    card it is made again with every block plain."""
    from diffpure_tpu_torch.diffusion import VESDE, get_pc_sampler

    dev = next(model.parameters()).device
    _, score_fn = ve_score(model)
    out = {}
    with torch.inference_mode():
        model.dtype = None
        out["float32"] = score_fn(x.to(dev), t.to(dev)).float().cpu()
        model.dtype = torch.bfloat16
        bf16 = lambda: score_fn(x.to(dev), t.to(dev)).float().cpu()  # noqa: E731
        if dev.type == "cuda":
            out["bfloat16"] = bf16()
            # on the card only: the CPU's wrappers take the plain blocks
            # anyway, and a CPU side patches nothing
            with plain_blocks(torch):
                out["bfloat16_plain"] = bf16()
        else:
            out["bfloat16"], out["modules"] = module_io(torch, model, bf16)
        model.dtype = None
        sampler = get_pc_sampler(VESDE(N=2), tuple(x.shape), predictor="reverse_diffusion",
                                 corrector="langevin", snr=0.16, n_steps_each=1, device=dev)
        out["pc_2_steps"] = sampler(score_fn, torch.Generator().manual_seed(seed))[0].cpu()
    return out


def ncsnv2_output(torch, model, x, t):
    _, score_fn = ncsnv2_score(model)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        return score_fn(x.to(dev), t.to(dev)).cpu()


def moved(torch, obj, dev):
    """``obj`` with every tensor in it (tuples, lists, dicts) on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(dev)
    if isinstance(obj, (tuple, list)):
        return type(obj)(moved(torch, o, dev) for o in obj)
    if isinstance(obj, dict):
        return {k: moved(torch, v, dev) for k, v in obj.items()}
    return obj


def module_io(torch, model, fn):
    """fn()'s value, and [(index, args, kwargs, output)] of each call of
    one of ``model.all_modules`` while it ran, on the CPU."""
    calls = []

    def hook(i):
        return lambda mod, args, kwargs, out: calls.append(
            (i, moved(torch, args, "cpu"), moved(torch, kwargs, "cpu"), out.detach().cpu()))

    handles = [m.register_forward_hook(hook(i), with_kwargs=True)
               for i, m in enumerate(model.all_modules)]
    try:
        return fn(), calls
    finally:
        for h in handles:
            h.remove()


def module_gaps(torch, model, calls):
    """Each recorded module call made again on the card's ``model`` with
    the recorded (CPU) inputs, through the kernels and with the blocks
    plain: max |card - CPU| over max |CPU output|, per call."""
    dev = next(model.parameters()).device
    rows = []
    with torch.inference_mode():
        for i, args, kwargs, want in calls:
            m = model.all_modules[i]
            row = dict(index=i, module=type(m).__name__)
            for route in ("kernels", "plain"):
                with plain_blocks(torch) if route == "plain" else contextlib.nullcontext():
                    got = m(*moved(torch, args, dev), **moved(torch, kwargs, dev)).float().cpu()
                err = float((got - want.float()).abs().max())
                row[route] = err / max(float(want.float().abs().max()), 1e-30)
            rows.append(row)
    return rows


def rel_gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def bf16_checks(torch, model, card_a, cpu_a):
    """Phase 26(a)'s bf16 readings on one evaluation (max |a - b| over max
    |b|), held against the CPU's own bf16 distance from its fp32 (see
    BF16_SPREAD), and the per-module card-against-CPU gaps at REL."""
    noise = rel_gap(cpu_a["bfloat16"], cpu_a["float32"])
    r = dict(cpu_bf16_vs_cpu_fp32=noise,
             card_bf16_vs_card_fp32=rel_gap(card_a["bfloat16"], card_a["float32"]),
             card_bf16_plain_vs_card_fp32=rel_gap(card_a["bfloat16_plain"], card_a["float32"]),
             card_bf16_kernels_vs_card_bf16_plain=rel_gap(card_a["bfloat16"],
                                                          card_a["bfloat16_plain"]),
             card_bf16_vs_cpu_bf16=rel_gap(card_a["bfloat16"], cpu_a["bfloat16"]),
             card_bf16_plain_vs_cpu_bf16=rel_gap(card_a["bfloat16_plain"], cpu_a["bfloat16"]),
             card_bf16_vs_cpu_fp32=rel_gap(card_a["bfloat16"], cpu_a["float32"]))
    gates = dict(
        card_bf16_vs_card_fp32=(noise / BF16_SPREAD, noise * BF16_SPREAD),
        card_bf16_kernels_vs_card_bf16_plain=(0.0, noise * BF16_SPREAD),
        card_bf16_vs_cpu_bf16=(0.0, noise * BF16_SPREAD))
    finite = all(bool(torch.isfinite(card_a[k]).all()) for k in ("bfloat16", "bfloat16_plain"))
    for k, v in r.items():
        lo, hi = gates.get(k, (None, None))
        verdict = "" if lo is None else (
            f" (in [{lo:.2e}, {hi:.2e}]) " + ("ok" if lo <= v <= hi else "FAIL"))
        log(f"  (a) bf16 reading, {k.replace('_', ' ')}: rel {v:.3e}{verdict}")
    rows = module_gaps(torch, model, cpu_a["modules"])
    worst = {}
    for row in rows:
        for route in ("kernels", "plain"):
            key = (row["module"], route)
            worst[key] = max(worst.get(key, 0.0), row[route])
    log(f"  (a) bf16, each of {len(rows)} module calls on the card with the CPU's inputs, "
        f"worst max |card - CPU| / max |CPU| by module (kernels / plain blocks; <= "
        f"{REL['bfloat16']:.0e}): " + ", ".join(
            f"{m} {worst[(m, 'kernels')]:.2e} / {worst[(m, 'plain')]:.2e}"
            for m in sorted({m for m, _ in worst})))
    bad = [k for k, (lo, hi) in gates.items() if not lo <= r[k] <= hi]
    bad += [f"module {row['index']} ({row['module']})" for row in rows
            if max(row["kernels"], row["plain"]) > REL["bfloat16"]]
    if not finite:
        bad.append("non-finite bf16 output")
    return dict(readings=r, gates=gates, modules=rows, bad=bad)


class CountedScore:
    """A score function that counts evaluations and, with ``keep``, keeps
    each one's output on its device (moved to the CPU after the timed
    run: ``outputs_cpu``), so a timed run never waits on a copy."""

    def __init__(self, score_fn, keep=True):
        self.score_fn, self.keep, self.outputs, self.calls = score_fn, keep, [], 0

    def __call__(self, x, t):
        s = self.score_fn(x, t)
        self.calls += 1
        if self.keep:
            self.outputs.append(s.detach().clone())
        return s

    def outputs_cpu(self):
        return [o.float().cpu() for o in self.outputs]


def plain_block_counter(model):
    """Forward hooks counting the BigGAN blocks that run JAX's unfused
    graph (``plain``); returns (counter, handles)."""
    from collections import Counter
    from diffpure_tpu_torch.models.layers import ResnetBlockBigGANpp

    seen = Counter()
    handles = [m.register_forward_hook(lambda mod, a, o: seen.update(["plain"]))
               for m in model.modules() if isinstance(m, ResnetBlockBigGANpp) and m.plain]
    return seen, handles


def sampler_against_plain(torch, what, run, score_fn, per_eval, plain_per_eval=0, model=None):
    """``run(score) -> (x, nfe)`` on the card twice with the same seeded
    draws: through the kernels, then with the blocks on their plain
    versions (plain_blocks). Every evaluation's output and the sample at
    SAMPLER_REL of the plain one's largest value; the kernels' route must
    launch ``per_eval`` per evaluation (every other kernel 0) and run
    ``plain_per_eval`` FIR blocks plain, the plain route launch nothing.
    The wall is timed with the outputs kept on the card."""
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts

    runs = {}
    for route in ("kernels", "plain"):
        score = CountedScore(score_fn)
        fir, handles = plain_block_counter(model) if model is not None else ({}, [])
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        try:
            with plain_blocks(torch) if route == "plain" else contextlib.nullcontext(), \
                    torch.inference_mode():
                x, nfe = run(score)
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
        wall_s = time.time() - t0
        runs[route] = dict(x=x.float().cpu(), nfe=nfe, evals=score.outputs_cpu(),
                           launches=launch_counts(), plain_blocks=fir.get("plain", 0),
                           wall_s=wall_s)
    got, want = runs["kernels"], runs["plain"]
    n = len(got["evals"])
    counts = {k: per_eval.get(k, 0) * n for k in got["launches"]}
    if len(want["evals"]) != n or got["launches"] != counts or any(want["launches"].values()) \
            or got["plain_blocks"] != plain_per_eval * n:
        raise AssertionError(
            f"{what}: {n} evaluations (plain route {len(want['evals'])}), launches "
            f"{got['launches']} (want {counts}), plain route {want['launches']}, plain FIR "
            f"blocks {got['plain_blocks']} (want {plain_per_eval * n})")
    rels = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got["evals"], want["evals"])]
    final = float((got["x"] - want["x"]).abs().max() / want["x"].abs().max())
    ok = bool(torch.isfinite(got["x"]).all()) and max(rels) <= SAMPLER_REL \
        and final <= SAMPLER_REL
    log(f"  {what}: {n} evaluations (the sampler's nfe {got['nfe']}), kernels against the "
        f"plain blocks on the card: worst evaluation rel {max(rels):.2e}, sample rel "
        f"{final:.2e} (<= {SAMPLER_REL:.0e}) {'ok' if ok else 'FAIL'}; launches "
        f"{ {k: v for k, v in got['launches'].items() if v} }, plain FIR blocks "
        f"{got['plain_blocks']}; {got['wall_s']:.2f} s / {want['wall_s']:.2f} s of wall")
    if not ok:
        raise AssertionError(f"{what}: kernels and plain blocks disagree")
    return dict(evaluations=n, nfe=got["nfe"], worst_eval_rel=max(rels), sample_rel=final,
                launches=got["launches"], plain_fir_blocks=got["plain_blocks"],
                wall_s=got["wall_s"], plain_wall_s=want["wall_s"])


def ve_parts(torch, model, x, t):
    """Phase 26(a)'s cost at batch VE_PROFILE_N: the wall per evaluation
    (CUDA-synchronised, VE_PROFILE_EVALS warm evaluations), and under the
    profiler the device ms per evaluation by part (the kernels launched
    inside each wrapper's call, or inside a plain FIR block's) and the
    device's idle share."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    from diffpure_tpu_torch.models import layers

    _, score_fn = ve_score(model)
    with torch.inference_mode():
        for _ in range(2):
            score_fn(x, t)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(VE_PROFILE_EVALS):
            score_fn(x, t)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / VE_PROFILE_EVALS

    def ranged(fn, name):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    patches = dict(fused_resblock=ranged(layers.fused_resblock, "part:#1 / #2"),
                   fused_resblock_cat=ranged(layers.fused_resblock_cat, "part:#1 / #2"),
                   fused_attnblock=ranged(layers.fused_attnblock, "part:#3"))
    plain = layers.ResnetBlockBigGANpp._forward_plain
    with mock.patch.multiple(layers, **patches), \
            mock.patch.object(layers.ResnetBlockBigGANpp, "_forward_plain",
                              ranged(plain, "part:plain FIR blocks")), torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for _ in range(VE_PROFILE_EVALS):
                score_fn(x, t)
            torch.cuda.synchronize()
            prof_wall_ms = (time.time() - t0) * 1e3 / VE_PROFILE_EVALS
    by = {}
    for e in prof.key_averages():
        # the kernels' own events; the ranges' device-side annotations
        # ("part:...") span kernels counted already
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if str(e.device_type).endswith("CUDA") and dev_us > 0 and not e.key.startswith("part:"):
            by[family(e.key)] = by.get(family(e.key), 0.0) + dev_us / 1e3 / VE_PROFILE_EVALS
    total = sum(by.values())
    if total <= 0:
        raise AssertionError("the profiler recorded no device time")
    parts = {p: range_device_ms(prof, f"part:{p}") / VE_PROFILE_EVALS for p in VE_PARTS}
    parts["the rest"] = total - sum(parts.values())
    return dict(batch=int(x.shape[0]), wall_ms_per_eval=wall_ms, device_ms_per_eval=total,
                idle_share=max(0.0, 1.0 - total / prof_wall_ms), device_ms_by_part=parts,
                device_ms_by_family=by)


def phase_samplers(torch, dev, score, smi):
    """Phase 26: the score_sde samplers and the legacy score models on the
    card. (a) the VE NCSN++ (configs/cifar10_ve.yml) in fp32: one
    evaluation at batch VE_PARITY_N card against CPU (fp32; bf16 by
    bf16_checks), two PC steps card against CPU with the same draws; the PC sampler (reverse_diffusion + langevin) at batch
    SAMPLER_BATCH on the VE SDE cut to SAMPLER_N steps, kernels against the
    plain blocks, launches VE_COUNTS and VE_PLAIN_BLOCKS plain FIR blocks
    an evaluation; the wall and device ms per evaluation by part at batch
    VE_PROFILE_N. (b) ``score`` (configs/cifar10.yml's NCSN++) in fp32 under
    the VP SDE cut to SAMPLER_N: the PC sampler with the euler_maruyama
    predictor and the probability-flow ODE sampler, kernels against the
    plain blocks, 40 / 36 / 10 a evaluation. (c) NCSNv2 at full width: one
    evaluation card against CPU, then annealed Langevin dynamics over the
    first NCSNV2_LEVELS noise levels at batch NCSNV2_N (cold, warm, and
    profiled for device time and idle share), no kernel launched."""
    import numpy as np
    from diffpure_tpu_torch.diffusion import PCNoise, VESDE, VPSDE, get_corrector, \
        get_ode_sampler, get_pc_sampler, get_predictor, get_score_fn
    from diffpure_tpu_torch.diffusion.sampling import pc_timesteps
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts

    cpu = CpuSide(torch)
    rng = np.random.default_rng(SEED + 63)
    rec = {}
    # ---- (a) and (c): the card's side of the card-against-CPU checks ------
    ve = build_ve(torch, dev)
    ve_cpu = cpu.copy("VE NCSN++", ve)
    xa = torch.from_numpy(rng.uniform(size=(VE_PARITY_N, 32, 32, 3)).astype(np.float32))
    ta = torch.tensor([0.3, 0.9])
    sde_a, _ = ve_score(ve)
    xa = xa + sde_a.marginal_prob(xa, ta)[1][:, None, None, None] * torch.from_numpy(
        rng.standard_normal(xa.shape).astype(np.float32))
    t0 = time.time()
    card_a = ve_outputs(torch, ve, xa, ta, SEED + 64)
    v2 = build_ncsnv2(torch, dev)
    v2_cpu = cpu.copy("NCSNv2", v2)
    xc = torch.from_numpy(rng.uniform(size=(VE_PARITY_N, 32, 32, 3)).astype(np.float32))
    tc = torch.tensor([1.0, 0.6])
    card_c = ncsnv2_output(torch, v2, xc, tc)
    log(f"  (a), (c): the card's side {time.time() - t0:.1f} s; the CPU's runs beside the "
        f"samplers' kernel checks")
    job = cpu.submit("phase 26", lambda: (ve_outputs(torch, ve_cpu, xa, ta, SEED + 64),
                                          ncsnv2_output(torch, v2_cpu, xc, tc)))
    # ---- (a) the PC sampler on the VE SDE, kernels against plain ----------
    shape = (SAMPLER_BATCH, 32, 32, 3)
    sde_n = VESDE(N=SAMPLER_N)
    _, ve_fn = ve_score(ve)
    pc = get_pc_sampler(sde_n, shape, predictor="reverse_diffusion", corrector="langevin",
                        snr=0.16, n_steps_each=1, device=dev)
    rec["ve_pc"] = sampler_against_plain(
        torch, f"(a) VE PC sampler (reverse_diffusion + langevin, N = {SAMPLER_N}, batch "
        f"{SAMPLER_BATCH})", lambda s: pc(s, torch.Generator().manual_seed(SEED + 65)), ve_fn,
        VE_COUNTS, VE_PLAIN_BLOCKS, model=ve)
    # ---- (b) the VP DDPM++ under the PC and ODE samplers -------------------
    score.dtype = None
    vp = VPSDE(N=SAMPLER_N)
    vp_fn = get_score_fn(vp, score, continuous=True)
    per_eval_vp = {k: v[2] for k, v in KERNELS.items()}
    pc_vp = get_pc_sampler(vp, shape, predictor="euler_maruyama", corrector="none", device=dev)
    rec["vp_pc"] = sampler_against_plain(
        torch, f"(b) VP PC sampler (euler_maruyama, N = {SAMPLER_N}, batch {SAMPLER_BATCH})",
        lambda s: pc_vp(s, torch.Generator().manual_seed(SEED + 66)), vp_fn, per_eval_vp)
    ode_vp = get_ode_sampler(vp, shape, device=dev)
    rec["vp_ode"] = sampler_against_plain(
        torch, f"(b) VP probability-flow ODE sampler ({SAMPLER_N} Euler steps, batch "
        f"{SAMPLER_BATCH})", lambda s: ode_vp(s, torch.Generator().manual_seed(SEED + 67)),
        vp_fn, per_eval_vp)
    score.dtype = torch.bfloat16
    # ---- the CPU's side, then its checks -----------------------------------
    cpu_a, cpu_c = cpu.result(job)
    cpu.close()
    checks = {}
    for what, got, want in (
            ("(a) VE evaluation fp32", card_a["float32"], cpu_a["float32"]),
            ("(a) VE two PC steps fp32", card_a["pc_2_steps"], cpu_a["pc_2_steps"]),
            ("(c) NCSNv2 evaluation fp32", card_c, cpu_c)):
        c = checks[what] = rel_check(torch, got, want, SLICE_REL["float32"])
        log(f"  {what}: card against CPU, max abs err {c['max_abs_err']:.3e} (rel "
            f"{c['rel_err']:.2e} <= {SLICE_REL['float32']:.0e}) {'ok' if c['ok'] else 'FAIL'}")
    rec["bf16"] = bf16 = bf16_checks(torch, ve, card_a, cpu_a)
    del cpu_a["modules"]
    rec["checks"] = checks
    bad = [k for k, v in checks.items() if not v["ok"]] + bf16["bad"]
    if bad:
        raise AssertionError(f"phase 26 card against CPU: {bad} disagree")
    # ---- (a) timed: the wall and device ms by part at batch 64 -------------
    x64 = torch.from_numpy(rng.uniform(size=(VE_PROFILE_N, 32, 32, 3)).astype(np.float32)).to(dev)
    t64 = torch.full((VE_PROFILE_N,), 0.5, device=dev)
    x64 = x64 + sde_a.marginal_prob(x64, t64)[1][:, None, None, None] * torch.randn_like(x64)
    rec["ve_parts"] = parts = ve_parts(torch, ve, x64, t64)
    log(f"  (a) VE NCSN++ fp32 at batch {VE_PROFILE_N}: {parts['wall_ms_per_eval']:.2f} ms of "
        f"wall, {parts['device_ms_per_eval']:.2f} ms of device per evaluation (idle share "
        f"{parts['idle_share']:.3f}) on {smi}; by part: " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts["device_ms_by_part"].items()) + "; by kernel "
        "family: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
            parts["device_ms_by_family"].items(), key=lambda kv: -kv[1])))
    del x64, ve
    torch.cuda.empty_cache()
    # ---- (c) timed: annealed Langevin over the first noise levels ----------
    # cold, warm, then once under the profiler: the score only counts its
    # evaluations, so nothing waits on the device inside the run
    from torch.profiler import ProfilerActivity, profile

    sde_c, v2_fn = ncsnv2_score(v2)
    corr, pred = get_corrector("ald"), get_predictor("none")
    ald = []
    for run in ("cold", "warm", "profiled"):
        noise = PCNoise(torch.Generator().manual_seed(SEED + 68))
        score_c = CountedScore(v2_fn, keep=False)
        reset_launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
                if run == "profiled" else contextlib.nullcontext() as prof:
            t0 = time.time()
            with torch.inference_mode():
                x = noise.prior(sde_c, (NCSNV2_N, 32, 32, 3), dev)
                for i, t in enumerate(pc_timesteps(sde_c)[:NCSNV2_LEVELS]):
                    vec_t = torch.full((NCSNV2_N,), float(t), device=dev)
                    js = iter(range(NCSNV2_ALD["n_steps_each"]))
                    x, x_mean = corr(lambda: noise.corrector(i, next(js), x), sde_c, score_c,
                                     x, vec_t, NCSNV2_ALD["snr"], NCSNV2_ALD["n_steps_each"])
                    x, x_mean = pred(lambda: noise.predictor(i, x), sde_c, score_c, x, vec_t)
                torch.cuda.synchronize()
            wall = time.time() - t0
        counts = launch_counts()
        n = score_c.calls
        row = dict(run=run, wall_s=wall, evaluations=n, ms_per_eval=wall * 1e3 / n,
                   launches=counts)
        note = ""
        if prof is not None:
            device_ms = sum((getattr(e, "self_device_time_total", 0) or 0) / 1e3
                            for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
            row.update(device_ms_per_eval=device_ms / n,
                       idle_share=max(0.0, 1.0 - device_ms / (wall * 1e3)))
            note = (f" ({row['device_ms_per_eval']:.2f} ms of device each, idle share "
                    f"{row['idle_share']:.3f})")
        ald.append(row)
        log(f"  (c) NCSNv2 ALD, {NCSNV2_LEVELS} of {sde_c.N} levels x "
            f"{NCSNV2_ALD['n_steps_each']} steps, batch {NCSNV2_N}, {run}: {wall:.3f} s, "
            f"{n} evaluations, {wall * 1e3 / n:.2f} ms each{note} on {smi}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if n != NCSNV2_LEVELS * NCSNV2_ALD["n_steps_each"] or any(counts.values()) \
                or not bool(torch.isfinite(x_mean).all()) or tuple(x_mean.shape) != (
                    NCSNV2_N, 32, 32, 3):
            raise AssertionError(f"(c) NCSNv2 ALD: {n} evaluations, launches {counts}, "
                                 f"finite {bool(torch.isfinite(x_mean).all())}")
        if prof is not None and row["device_ms_per_eval"] <= 0:
            raise AssertionError("(c) NCSNv2 ALD: the profiler recorded no device time")
    rec["ncsnv2_ald"] = ald
    del v2
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def plain_adm(torch):
    """A context in which the ADM family's blocks take their plain routes on
    the card (no tiled GN, no halo conv, dense attention): the yardstick
    phase 27 holds the kernels' path against. Global, so no CPU side may
    run an ADM-family model meanwhile."""
    from diffpure_tpu_torch.models import adm_unet

    adm_unet.set_tiled_gn_min_bytes(1 << 62)
    try:
        with mock.patch.object(adm_unet, "attention_route", lambda *a: "dense"):
            yield
    finally:
        adm_unet.set_tiled_gn_min_bytes(None)


def adm_against_plain(torch, what, fn, counts, rel, outputs=None):
    """``fn() -> {name: tensor}`` on the card through the kernels, then
    with the ADM family on its plain routes: each tensor within ``rel``
    (a number or {name: number}) of the plain one's max; the kernels' route
    launches exactly ``counts``, the plain route nothing. ``outputs``: a
    dict that receives both routes' tensors (on the CPU)."""
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts

    runs = {}
    for route in ("kernels", "plain"):
        reset_launch_counts()
        with plain_adm(torch) if route == "plain" else contextlib.nullcontext():
            out = fn()
        torch.cuda.synchronize()
        runs[route] = ({k: v.detach().float().cpu() for k, v in out.items()}, launch_counts())
        del out
    (got, c), (want, c_plain) = runs["kernels"], runs["plain"]
    if outputs is not None:
        outputs.update(kernels=got, plain=want)
    if c != counts or any(c_plain.values()):
        raise AssertionError(f"{what}: launches {c} (want {counts}); plain route {c_plain}")
    checks = {k: rel_check(torch, got[k], want[k], rel[k] if isinstance(rel, dict) else rel)
              for k in want}
    log(f"  {what}: kernels against the plain routes on the card: " + ", ".join(
        f"{k} rel {v['rel_err']:.2e} (<= {v['rel_tol']:.0e})" for k, v in checks.items())
        + f"; launches {({k: n for k, n in c.items() if n})}")
    bad = [k for k, v in checks.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"{what}: {bad} disagree with the plain routes")
    return dict(checks=checks, launches=c)


def seeded_on(torch, model, seed, dev):
    """A model built on the meta device, filled with seeded random-normal
    weights and moved to ``dev`` (eval mode, no weight gradients)."""
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    sd = seeded_normal_state_dict(model, seed)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, assign=True)
    return model.eval().requires_grad_(False).to(dev)


def log_p_grad(torch, cls, x, t, y, scale=1.0):
    """(sum log p(y | x, t), scale * its gradient with respect to x): the
    classifier guidance's cond_fn (ref guided-diffusion's
    classifier_sample.py)."""
    xi = x.detach().requires_grad_(True)
    with torch.enable_grad():
        lp = cls(xi, t).float().log_softmax(-1).gather(-1, y[:, None]).sum()
        (g,) = torch.autograd.grad(lp, xi)
    return lp.detach(), g * scale


def phase_guidance(torch, dev, adm, rng, smi, cpu):
    """Phase 27(a): the guidance classifier. Its 256-px route census on the
    meta device; the forward at batch CLS_N in fp32 and bf16, card against
    the CPU's fp32 (CpuSide), launches exactly the census, CUDA-event and
    device ms; the input gradient of log p(y | x_t) in both dtypes, kernels
    against the plain routes; one classifier-guided DDIM step (ddim50,
    index DDIM_STEP) with the ImageNet ADM, fp32, kernels against plain."""
    import numpy as np
    from diffpure_tpu_torch.models import classifier_defaults, create_classifier
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import make_imagenet_diffusion

    with torch.device("meta"):
        cls = create_classifier(**dict(classifier_defaults(), image_size=256))
    n_params = sum(p.numel() for p in cls.parameters())
    if n_params != CLS_PARAMS:
        raise AssertionError(f"the classifier has {n_params} params, expected {CLS_PARAMS}")
    zero = {k: 0 for k in launch_counts()}
    want = {}
    for dtype_name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        cls.dtype = dtype
        want[dtype_name] = {**zero, **census_launches(
            adm_route_census(torch, cls, (CLS_N, 256, 256, 3)))}
    log(f"  classifier: {n_params} parameters; launches per evaluation at batch {CLS_N} by "
        f"the census: {want['float32']}")
    cls = seeded_on(torch, cls, SEED + 30, dev)
    x = torch.from_numpy(rng.standard_normal((CLS_N, 256, 256, 3)).astype(np.float32) * 0.5)
    t = torch.tensor([600, 40], dtype=torch.int32)
    y = torch.from_numpy(rng.integers(0, 1000, CLS_N))
    cls_cpu = cpu.copy("classifier", cls)
    cls_cpu.dtype = None

    def cpu_forward():
        with torch.inference_mode():
            return cls_cpu(x, t).float()

    job = cpu.submit("phase 27(a)", cpu_forward)
    xd, td, yd = x.to(dev), t.to(dev), y.to(dev)
    rec, fwd = {}, {}
    for dtype_name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        cls.dtype = dtype
        reset_launch_counts()
        with torch.inference_mode():
            out = cls(xd, td)
        torch.cuda.synchronize()
        c = launch_counts()
        if c != want[dtype_name] or tuple(out.shape) != (CLS_N, 1000) \
                or out.dtype != torch.float32:
            raise AssertionError(f"classifier {dtype_name}: launches {c} (want "
                                 f"{want[dtype_name]}), logits {tuple(out.shape)} {out.dtype}")
        rec[dtype_name] = dict(logits=out.cpu(), launches=c)

        def forward(dtype=dtype):
            cls.dtype = dtype
            with torch.inference_mode():
                return cls(xd, td)

        fwd[dtype_name] = forward
        rec[dtype_name]["ms"] = cuda_ms(torch, forward, reps=3, warmup=1)
    for (dtype_name, f), (ms, _) in zip(fwd.items(), device_ms_many(torch, list(fwd.values()),
                                                                    reps=3)):
        rec[dtype_name]["device_ms"] = ms
    ref = cpu.result(job)
    for dtype_name in fwd:
        chk = rel_check(torch, rec[dtype_name].pop("logits"), ref, ADM_EVAL_REL[dtype_name])
        rec[dtype_name]["card_vs_cpu"] = chk
        log(f"  classifier {dtype_name}, batch {CLS_N}: {rec[dtype_name]['ms']:.2f} ms a forward "
            f"(events), {rec[dtype_name]['device_ms']:.2f} of device on {smi}; card against the "
            f"CPU's fp32 rel {chk['rel_err']:.2e} (<= {chk['rel_tol']:.0e})")
        if not chk["ok"]:
            raise AssertionError(f"classifier {dtype_name}: card and CPU disagree")

    def grad():
        lp, g = log_p_grad(torch, cls, xd, td, yd)
        return {"log p": lp[None], "d/dx": g}

    grads = {}
    for dtype_name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        cls.dtype = dtype
        grads[dtype_name] = {}
        rec[dtype_name]["input_grad"] = adm_against_plain(
            torch, f"classifier input gradient, {dtype_name}", grad, want[dtype_name],
            CLS_GRAD_REL[dtype_name], outputs=grads[dtype_name])
    # bf16: the kernels' gradient no further from the plain fp32 one than
    # BF16_SPREAD x the plain bf16 one is
    ref = grads["float32"]["plain"]["d/dx"]
    spread = {route: rel_check(torch, grads["bfloat16"][route]["d/dx"], ref, 1.0)["rel_err"]
              for route in ("kernels", "plain")}
    rec["bfloat16"]["input_grad"]["from_plain_fp32"] = spread
    log(f"  bf16 input gradient from the plain fp32 one: kernels {spread['kernels']:.2e}, plain "
        f"{spread['plain']:.2e} (<= {BF16_SPREAD} x)")
    if not 0 < spread["kernels"] <= BF16_SPREAD * spread["plain"]:
        raise AssertionError(f"the bf16 input gradient: {spread}")

    # one guided DDIM step: the ImageNet ADM (fp32) as the model, the
    # classifier (fp32) as cond_fn at the model's timesteps
    home = next(adm.parameters()).device
    adm.to(dev)
    adm.dtype, cls.dtype = torch.float32, None
    adm_calls = {}
    for (name, _), n in adm_census(torch, adm, xd).items():
        adm_calls[name] = adm_calls.get(name, 0) + n
    step_counts = {k: v + adm_calls.get(k, 0) for k, v in want["float32"].items()}
    diffusion = make_imagenet_diffusion("ddim50")
    ts = torch.full((CLS_N,), DDIM_STEP, dtype=torch.int32, device=dev)

    def guided_step():
        with torch.no_grad():
            out = diffusion.ddim_sample(
                adm, xd, ts, clip_denoised=True, noise=torch.zeros_like(xd),
                cond_fn=lambda xx, tt: log_p_grad(torch, cls, xx, tt, yd, GUIDANCE_SCALE)[1])
        return {"sample": out["sample"], "pred_xstart": out["pred_xstart"]}

    rec["guided_ddim_step"] = adm_against_plain(
        torch, f"classifier-guided DDIM step (ddim50 index {DDIM_STEP}, ADM + classifier fp32)",
        guided_step, step_counts, ADM_EVAL_REL["float32"])
    adm.dtype = torch.bfloat16
    adm.to(home)
    del cls
    torch.cuda.empty_cache()
    return rec


def phase_upsampler(torch, dev, rng, smi):
    """Phase 27(b): the 64 -> 256 upsampler at guided-diffusion's width
    (bf16 torso), one forward at batch 1, kernels against the plain routes
    on the card, launches exactly its census (bf16's halo kernel takes
    cout % 128 == 0: its 192-channel stages take the tiled route)."""
    import numpy as np
    from diffpure_tpu_torch.models import sr_create_model
    from diffpure_tpu_torch.ops import launch_counts

    with torch.device("meta"):
        sr = sr_create_model(256, 64, **SR_FLAGS)
    n_params = sum(p.numel() for p in sr.parameters())
    if n_params != SR_PARAMS or sr.dtype != torch.bfloat16:
        raise AssertionError(f"the upsampler has {n_params} params ({sr.dtype}), expected "
                             f"{SR_PARAMS} (bf16)")
    low_meta = torch.empty(1, 64, 64, 3, device="meta")
    want = {**{k: 0 for k in launch_counts()},
            **census_launches(adm_route_census(torch, sr, (1, 256, 256, 3),
                                               low_res=low_meta))}
    sr = seeded_on(torch, sr, SEED + 31, dev)
    x = torch.from_numpy(rng.standard_normal((1, 256, 256, 3)).astype(np.float32) * 0.5).to(dev)
    low = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)).to(dev)
    t = torch.tensor([500], dtype=torch.int32, device=dev)

    def forward():
        with torch.inference_mode():
            return sr(x, t, low_res=low)

    rec = adm_against_plain(torch, f"upsampler ({n_params} parameters, bf16, batch 1)",
                            lambda: {"output": forward()}, want, ADM_EVAL_REL["bfloat16"])
    rec["ms"] = cuda_ms(torch, forward, reps=3, warmup=1)
    rec["device_ms"] = device_ms_many(torch, [forward], reps=3)[0][0]
    log(f"  upsampler: {rec['ms']:.2f} ms a forward (events), {rec['device_ms']:.2f} of device "
        f"on {smi}")
    del sr
    torch.cuda.empty_cache()
    return rec


def first_iterate_grad(torch, dm, what, leaves, image_of, head, seed):
    """The first iterate's gradient of an attack through the defence,
    kernels against the plain blocks: the classifier's part linearised at
    the purified image (its cotangent w there, one w for both routes, so
    that WRN-28-10's ReLU kinks do not enter), then d sum(w * purify(
    image_of(leaves))) / d leaves on both routes (kernels_against_plain)."""
    with torch.no_grad():
        p = dm.purify(image_of(leaves), seed)
    p.requires_grad_(True)
    with torch.enable_grad():
        (w,) = torch.autograd.grad(head(dm.classify(p)).sum(), p)

    def fn():  # the purified image, and the gradient of sum(w * it) by leaf
        ls = [leaf.detach().requires_grad_(True) for leaf in leaves]
        with torch.enable_grad():
            purified = dm.purify(image_of(ls), seed)
            grads = torch.autograd.grad((w * purified).sum(), ls)
        return purified, {f"leaf {i}": g for i, g in enumerate(grads)}

    return kernels_against_plain(torch, dm.score_model, f"{what}, the first iterate's gradient",
                                 fn, counts=grad_counts(2 * ME_T, ME_T))


def phase_mister_ed(torch, dev, score, clf, rng, smi):
    """Phase 27(c): the mister_ed attacks and PGD through the fp32 CIFAR
    defence (t* = ME_T, `checkpoint`, batch ME_N), ME_ITERS iterations
    each: perturbation_pgd with DeltaAddition, with ReColorAdv (LUT, YPbPr)
    and with ReColorAdv then FullSpatial; pgd_attack Linf; fgsm;
    carlini_wagner. Launches exactly the evaluations each makes; x_adv in
    [0, 1] and its threat model; the first iterate's gradient, kernels
    against the plain blocks; the discretized check and SSIM on each
    result."""
    import numpy as np
    from diffpure_tpu_torch.attacks import mister_ed as me
    from diffpure_tpu_torch.attacks.discretization import discretized_adversarial_check
    from diffpure_tpu_torch.attacks.losses import ce_loss, margin_loss
    from diffpure_tpu_torch.attacks.perturbations import DeltaAddition, \
        ParameterizedXformAdv, SequentialPerturbation, leaves, unflatten
    from diffpure_tpu_torch.attacks.pgd import PGDConfig, pgd_attack
    from diffpure_tpu_torch.attacks.recoloradv import FullSpatialColorTransform, ReColorAdv, \
        YPbPrColorSpace
    from diffpure_tpu_torch.attacks.spatial import FullSpatial
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.utils.prng import fold_in
    from diffpure_tpu_torch.utils.ssim import ssim

    score.dtype = torch.float32
    dm = defended(torch, score, clf, ME_T, "checkpoint")
    x = torch.from_numpy(rng.uniform(size=(ME_N, 32, 32, 3)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 10, ME_N)).to(dev)
    eps = 8 / 255
    recolor = ReColorAdv(xform=FullSpatialColorTransform(8), color_space=YPbPrColorSpace(),
                         lp_bound=0.06)
    perts = {"DeltaAddition": DeltaAddition(lp_style="inf", lp_bound=eps),
             "ReColorAdv (LUT, YPbPr)": recolor,
             "ReColorAdv + FullSpatial": SequentialPerturbation(layers=(
                 recolor, ParameterizedXformAdv(xform=FullSpatial(), lp_bound=0.05,
                                                use_stadv=True)))}
    pgd_cfg = me.MisterEdPGDConfig(num_iterations=ME_ITERS, step_size=2 / 255)
    T, it = ME_T, ME_ITERS
    # (name, attack, (forward, backward) score evaluations, Linf bound or None)
    attacks = [(f"perturbation_pgd {name}",
                functools.partial(me.perturbation_pgd, dm, pert, x, y, SEED + 40, pgd_cfg),
                (2 * T * it + T, T * it), eps if name == "DeltaAddition" else None)
               for name, pert in perts.items()]
    attacks += [
        ("pgd_attack Linf", lambda: pgd_attack(dm, x, y, SEED + 41, PGDConfig(
            n_iter=it, eps=eps, step_size=2 / 255)), (3 * T * it, T * it), eps),
        ("fgsm", lambda: (me.fgsm(dm, x, y, SEED + 42, eps=eps), None), (2 * T, T), eps),
        ("carlini_wagner", lambda: me.carlini_wagner(dm, x, y, SEED + 43, me.CarliniWagnerConfig(
            num_iterations=it, lr=0.01)), (3 * T * it, T * it), None)]
    runs = {}
    for name, attack, (fwd, bwd), bound in attacks:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        x_adv, found = attack()
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        if counts != grad_counts(fwd, bwd):
            raise AssertionError(f"{name}: launches {counts} != {grad_counts(fwd, bwd)}")
        dist = float((x_adv - x).abs().max())
        if tuple(x_adv.shape) != tuple(x.shape) or not bool(torch.isfinite(x_adv).all()) \
                or float(x_adv.min()) < 0 or float(x_adv.max()) > 1 \
                or (bound is not None and dist > bound + 1e-6):
            raise AssertionError(f"{name}: x_adv off [0, 1] or its ball (max |d| {dist})")
        with torch.no_grad():
            found_q = discretized_adversarial_check(dm, x_adv, y, SEED + 44)
        s = float(ssim(x, x_adv))
        if not -1.0 <= s <= 1.0:
            raise AssertionError(f"{name}: SSIM {s}")
        runs[name] = dict(wall_s=wall, evals=(fwd, bwd), counts=counts, max_abs_dist=dist,
                          found=None if found is None else int(found.sum()),
                          found_after_rounding=int(found_q.sum()), ssim=s)
        log(f"  {name}: {wall:.2f} s ({fwd} forward / {bwd} backward evaluations) on {smi}; "
            f"max |x_adv - x| {dist:.4f}, found {runs[name]['found']}, after 8-bit rounding "
            f"{int(found_q.sum())} (random weights), SSIM {s:.4f}; launches exact")

    def cw_f6_head(logits):
        return me.cw_f6(logits, y)

    # each attack's parameterisation at its first iterate: the three
    # perturbations' leaves (delta; the LUT; the LUT and the grid), x itself
    # (pgd_attack and fgsm: CE at x), and CW's w, x through tanh
    grads = {}
    for name, pert in perts.items():
        p0 = pert.init_params(x)
        grads[f"perturbation_pgd {name}"] = first_iterate_grad(
            torch, dm, name, [leaf.detach().contiguous() for leaf in leaves(p0)],
            lambda ls, pert=pert, p0=p0: pert.apply(pert.project(unflatten(p0, ls), x), x),
            cw_f6_head, fold_in(SEED + 40, 0))
    grads["pgd_attack / fgsm (CE at x)"] = first_iterate_grad(
        torch, dm, "CE at x", [x], lambda ls: ls[0], lambda logits: ce_loss(logits, y),
        fold_in(SEED + 41, 0))
    w0 = torch.atanh(2 * torch.clamp(x, 1e-6, 1 - 1e-6) - 1)
    grads["carlini_wagner (w)"] = first_iterate_grad(
        torch, dm, "carlini_wagner", [w0], lambda ls: (torch.tanh(ls[0]) + 1) / 2,
        lambda logits: margin_loss(logits, y), fold_in(SEED + 43, 0))
    score.dtype = torch.bfloat16
    return dict(attacks=runs, first_iterate_grads=grads)


def phase_serving(torch, dev, score, clf, rng):
    """Phase 27(d): the bf16 defence served over a mesh of two shards on
    one card, SERVE_T evaluations a shard: ``shard_defended_call`` (JAX's
    serving.py) bit for bit its two per-shard calls with fold_in(seed, i);
    the CLI's ``ShardedDefendedModel`` on an uneven batch (SERVE_N - 1 rows,
    4 + 3) bit for bit its per-shard calls with BatchSlice noise, and
    within a tenth of a reseeded call's distance of the unsharded call
    (the noise does not depend on the mesh)."""
    import dataclasses

    import numpy as np
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.parallel import ShardedDefendedModel, make_mesh, \
        shard_defended_call
    from diffpure_tpu_torch.purify import BatchSlice
    from diffpure_tpu_torch.utils.prng import fold_in

    score.dtype = torch.bfloat16
    dm = defended(torch, score, clf, SERVE_T, "none")
    mesh = make_mesh(data=2, devices=[dev, dev])
    served = shard_defended_call(
        lambda sc, cl, xs, s: dataclasses.replace(dm, score_model=sc, classifier=cl)(xs, s),
        mesh, score, clf)
    sharded = ShardedDefendedModel(dm, mesh)
    x = torch.from_numpy(rng.uniform(size=(SERVE_N, 32, 32, 3)).astype(np.float32)).to(dev)
    seed, half, odd = SEED + 50, SERVE_N // 2, SERVE_N - 1
    counts = {}
    with torch.inference_mode():
        reset_launch_counts()
        got = served(x, seed)
        torch.cuda.synchronize()
        counts["shard_defended_call"] = launch_counts()
        want = torch.cat([dm(x[:half], fold_in(seed, 0)), dm(x[half:], fold_in(seed, 1))])
        reset_launch_counts()
        got_cli = sharded(x[:odd], seed)
        torch.cuda.synchronize()
        counts["ShardedDefendedModel"] = launch_counts()
        want_cli = torch.cat([dm(x[a:b], BatchSlice(seed, a, b, odd))
                              for a, b in ((0, half), (half, odd))])
        whole, reseeded = dm(x[:odd], seed), dm(x[:odd], seed + 1)
    bad = {k: c for k, c in counts.items() if c != expected_counts(2 * SERVE_T)}
    if bad:
        raise AssertionError(f"served calls: launches {bad} != {expected_counts(2 * SERVE_T)}")
    same, same_cli = bool(torch.equal(got, want)), bool(torch.equal(got_cli, want_cli))
    to_whole = float((got_cli - whole).abs().max())
    noise_scale = float((reseeded - whole).abs().max())
    log(f"  shard_defended_call over mesh {mesh.shape} on {dev}: logits {tuple(got.shape)}, "
        f"bit for bit the per-shard calls with fold_in(seed, i): {same}; ShardedDefendedModel "
        f"on {odd} rows (4 + 3): bit for bit its per-shard calls with BatchSlice: {same_cli}, "
        f"max |logit - unsharded| {to_whole:.3e} (a reseeded unsharded call: "
        f"{noise_scale:.3e}); launches exact")
    if not (same and same_cli) or tuple(got.shape) != (SERVE_N, 10) \
            or tuple(got_cli.shape) != (odd, 10) or not to_whole <= 0.1 * noise_scale:
        raise AssertionError("a served call is not its per-shard calls, or the sharded "
                             "defence's noise depends on the mesh")
    return dict(shards=mesh.size, bitwise=same, cli_bitwise=same_cli, counts=counts,
                cli_max_abs_to_unsharded=to_whole, reseeded_max_abs=noise_scale)


def ncsnpp_gflop(torch, score_cpu):
    """flops_estimate of one evaluation of the fp32 NCSN++ at batch 1, on a
    CPU copy (the counter sees PyTorch's operators: the wrappers' plain
    versions there), in GFLOP."""
    from diffpure_tpu_torch.utils.profiling import flops_estimate

    return flops_estimate(score_cpu, torch.zeros(1, 32, 32, 3), torch.tensor([500.0])) / 1e9


def phase_aux(torch, dev, score, clf, ddpm, rng, cpu, flops_job):
    """Phase 27(e): the score_sde DDPM's training mode at full width, batch
    N: at rate 0 eval mode bit for bit on eval mode's route, at
    TRAIN_DROPOUT #10 44 and #3 4 times; a DefendedModel debug_dir dump
    read back; ``flops_job``'s flops_estimate of one NCSN++ evaluation
    (ncsnpp_gflop, on the CPU side) beside XLA's NCSNPP_XLA_GFLOP."""
    import numpy as np
    from diffpure_tpu_torch.eval import DefendedModel
    from diffpure_tpu_torch.models.layers import ResnetBlockDDPMpp
    from diffpure_tpu_torch.ops import launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import PurifyConfig

    home = next(ddpm.parameters()).device
    ddpm.to(dev)
    blocks = [m for m in ddpm.modules() if isinstance(m, ResnetBlockDDPMpp)]
    if {b.dropout for b in blocks} != {TRAIN_DROPOUT}:
        raise AssertionError(f"the DDPM's dropout {({b.dropout for b in blocks})}")
    x = torch.from_numpy(rng.standard_normal((N, 32, 32, 3)).astype(np.float32)).to(dev)
    t = torch.full((N,), 499.5, device=dev)
    want = {**{k: 0 for k in launch_counts()}, **DDPM_TRAIN_COUNTS}  # 44 #10, 4 #3
    outs, counts = {}, {}
    with torch.inference_mode():
        for what, rate, train in (("eval", TRAIN_DROPOUT, False), ("train, rate 0", 0.0, True),
                                  ("train", TRAIN_DROPOUT, True)):
            for b in blocks:
                b.dropout = rate
            reset_launch_counts()
            outs[what] = ddpm(x, t, train=train,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 60))
            torch.cuda.synchronize()
            counts[what] = launch_counts()
    for b in blocks:
        b.dropout = TRAIN_DROPOUT
    ddpm.to(home)
    rate0_same = bool(torch.equal(outs["train, rate 0"], outs["eval"]))
    moved = float((outs["train"] - outs["eval"]).abs().max())
    log(f"  DDPM training mode, batch {N}: rate 0 bit for bit eval mode: {rate0_same}; rate "
        f"{TRAIN_DROPOUT} moves the output by {moved:.3e}; launches {counts['train']}")
    if not rate0_same or any(c != want for c in counts.values()) or not moved > 0 \
            or not bool(torch.isfinite(outs["train"]).all()):
        raise AssertionError(f"DDPM training mode: rate 0 same {rate0_same}, moved {moved}, "
                             f"launches {counts} (want {want} each)")

    # the debug dumps of the first two purifications
    from PIL import Image

    dump = OUT / "debug_dump"
    shutil.rmtree(dump, ignore_errors=True)
    dm = DefendedModel(score, clf, PurifyConfig(t=2, grad_mode="none"), log_every=0,
                       tag="p27", debug_dir=str(dump))
    xd = torch.from_numpy(rng.uniform(size=(10, 32, 32, 3)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        purified = [dm.purify(xd, SEED + 61 + i).float().cpu() for i in range(3)]
    dirs = sorted(os.listdir(dump))
    saved = [np.load(dump / f"bs{i}_p27" / "samples_0.npy").astype(np.float32) for i in range(2)]
    pngs = [np.asarray(Image.open(dump / f"bs{i}_p27" / "samples_0.png")) for i in range(2)]
    dump_ok = dirs == ["bs0_p27", "bs1_p27"] and all(
        s.shape == (8, 32, 32, 3) and np.abs(s - (p[:8].numpy() * 2 - 1)).max() <= 1e-5
        for s, p in zip(saved, purified)) and all(g.shape == (36, 274, 3) for g in pngs)
    log(f"  debug_dir: {dirs}, samples_0.npy = the purified x[:8], grids {pngs[0].shape}: "
        f"{dump_ok}")
    if not dump_ok:
        raise AssertionError(f"the debug dump: {dirs}, {[s.shape for s in saved]}, "
                             f"{[g.shape for g in pngs]}")

    gflop = cpu.result(flops_job)
    log(f"  flops_estimate of one NCSN++ evaluation at batch 1: {gflop:.2f} GFLOP "
        f"(FlopCounterMode: convolutions and products), XLA's cost analysis "
        f"{NCSNPP_XLA_GFLOP} (bench.py:46)")
    if not 0.8 * NCSNPP_XLA_GFLOP <= gflop <= 1.25 * NCSNPP_XLA_GFLOP:
        raise AssertionError(f"flops_estimate {gflop} GFLOP against XLA's {NCSNPP_XLA_GFLOP}")
    return dict(ddpm_train=dict(rate0_bitwise=rate0_same, moved=moved, counts=counts["train"]),
                debug_dump=dict(dirs=dirs, ok=dump_ok), ncsnpp_gflop=gflop)


def phase_rest(torch, dev, score, clf, adm, ddpm, smi):
    """Phase 27: (a)-(e) (phase_guidance, phase_upsampler,
    phase_mister_ed, phase_serving, phase_aux), with a CPU side and seeded
    inputs of its own."""
    import numpy as np

    rng = np.random.default_rng(SEED + 27)
    cpu = CpuSide(torch)
    rec, part_s = {}, {}
    t0 = [time.time()]

    def part_done(name):
        part_s[name] = time.time() - t0[0]
        t0[0] = time.time()

    try:
        log(f"== phase 27(a): the guidance classifier (create_classifier at 256 px), batch "
            f"{CLS_N}, fp32 and bf16; its input gradient; a guided DDIM step with the ADM")
        rec["guidance"] = phase_guidance(torch, dev, adm, rng, smi, cpu)
        part_done("a")
        # the NCSN++'s FLOP count on the CPU side, beside (b)-(d)
        dtype, score.dtype = score.dtype, torch.float32
        score_cpu = copy.deepcopy(score).cpu()
        score.dtype = dtype
        flops_job = cpu.submit("phase 27(e)'s flops_estimate", lambda: ncsnpp_gflop(torch,
                                                                                     score_cpu))
        log("== phase 27(b): the 64 -> 256 upsampler (sr_create_model), bf16, batch 1")
        rec["upsampler"] = phase_upsampler(torch, dev, rng, smi)
        part_done("b")
        log(f"== phase 27(c): the mister_ed attacks and PGD through the fp32 CIFAR defence, "
            f"t*={ME_T}, batch {ME_N}, {ME_ITERS} iterations each")
        rec["mister_ed"] = phase_mister_ed(torch, dev, score, clf, rng, smi)
        part_done("c")
        log(f"== phase 27(d): the bf16 defence served over two shards, t*={SERVE_T}, batch "
            f"{SERVE_N}")
        rec["serving"] = phase_serving(torch, dev, score, clf, rng)
        part_done("d")
        log("== phase 27(e): the DDPM's training mode, a debug_dir dump, flops_estimate")
        rec["aux"] = phase_aux(torch, dev, score, clf, ddpm, rng, cpu, flops_job)
        part_done("e")
        log(f"  phase 27 by part (s): {json.dumps({k: round(v, 1) for k, v in part_s.items()})}")
        rec.update(part_s=part_s, cpu_side_s=cpu.seconds)
        return rec
    finally:
        cpu.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stop-after", choices=("2b", "2c", "2d"), default=None,
                    help="end after this phase (no result line)")
    ap.add_argument("--profile-adm", action="store_true",
                    help="after phase 1, profile warm ImageNet ADM evaluations "
                         "(batch 4, bf16) and end (no result line)")
    ap.add_argument("--profile-ddpm", action="store_true",
                    help="after phase 1, profile warm score_sde DDPM evaluations "
                         "(batch 8, fp32) and end (no result line)")
    ap.add_argument("--profile-cifar", action="store_true",
                    help="after phase 1, profile warm CIFAR NCSN++ evaluations (batch 8 "
                         "and 128 bf16, 8 and 64 fp32; the block chains' steps) and the host "
                         "time per block call, and end (no result line)")
    ap.add_argument("--phase-26", action="store_true",
                    help="after phase 1, run phase 26 alone (the score_sde samplers and the "
                         "legacy score models) and end (no result line)")
    ap.add_argument("--phase-27", action="store_true",
                    help="after phase 1, run phase 27 alone (the guidance classifier, the "
                         "upsampler, the mister_ed attacks, serving, the DDPM's training "
                         "mode) and end (no result line)")
    ap.add_argument("--profile-grad", action="store_true",
                    help="after phase 1, profile warm steps of phase 5's gradient and one "
                         "evaluation's backward at batch 8 and 16 (the chain's steps), and "
                         "end (no result line)")
    args = ap.parse_args()
    import torch

    if not (REPO / "diffpure_tpu_torch" / "csrc").is_dir():
        log("chip_smoke.py must run from a checkout of the repository")
        return 2
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    from diffpure_tpu_torch.attacks import AutoAttackConfig
    from diffpure_tpu_torch.eval import DefendedModel, eval_autoattack, get_accuracy
    from diffpure_tpu_torch.ops import _cuda, launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import PurifyConfig
    from diffpure_tpu_torch.utils.prng import fold_in

    phase_s = {}
    t_phase = [time.time()]

    def phase_done(name):
        now = time.time()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now
        log(f"   (phase {name}: {phase_s[name]:.1f} s)")

    OUT.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 1 ------------------------------------------------------------
    log(f"== phase 1: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    t0 = time.time()
    _cuda.lib()
    build_s = time.time() - t0
    log(f"kernels built and loaded in {build_s:.1f} s")
    build_log = _cuda.BUILD_DIR / "build.log"
    if build_log.exists():
        (OUT / "build.log").write_text(build_log.read_text())
    sass = sass_counts(torch, _cuda.build())
    wgmma = sass["HGMMA"]
    for fn, n in sorted(wgmma.items()):
        if any(k in fn for k in ("halo", "flash", "rb_wgmma", "attn_wgmma")):
            log(f"  SASS: {n:5d} HGMMA in {fn}")
    no_wgmma = [k for k in WGMMA_KERNELS if not any(k in fn and n for fn, n in wgmma.items())]
    if no_wgmma:
        raise AssertionError(f"no wgmma (HGMMA) in the SASS of {no_wgmma}")
    # the fp32 kernels stay on the FMA units (TF32 off): no tensor-core
    # instruction of either kind, and no spill
    fp32_fns = {fn: sass["HMMA"][fn] + wgmma[fn] for fn in wgmma
                if any(k in fn for k in FP32_KERNELS)}
    missing = [k for k in FP32_KERNELS if not any(k in fn for fn in fp32_fns)]
    tensor = {fn: n for fn, n in fp32_fns.items() if n}
    report = ptxas_report(build_log.read_text(), FP32_KERNELS)
    spills = {fn: r for fn, r in report.items() if r.get("spill")}
    regs = sorted({r.get("registers") for r in report.values()})
    log(f"  SASS: {len(fp32_fns)} fp32 kernel functions ({', '.join(FP32_KERNELS)}), "
        f"{sum(fp32_fns.values())} HMMA / HGMMA; -Xptxas -v: {len(report)} entries, "
        f"{len(spills)} with spills, registers {regs}")
    if missing or tensor or spills or not report:
        raise AssertionError(f"fp32 kernels: missing {missing}, tensor-core instructions "
                             f"{tensor}, spills {spills}")
    phase_done("1")
    if args.phase_26:
        score, _ = build_models(torch, dev, torch.bfloat16)
        log("== phase 26 alone: the score_sde samplers and the legacy score models")
        rec = phase_samplers(torch, dev, score, smi)
        phase_done("26")
        (OUT / "phase26.json").write_text(json.dumps(dict(card=smi, phase_s=phase_s, **rec),
                                                     indent=1))
        return 3
    if args.phase_27:
        score, clf = build_models(torch, dev, torch.bfloat16)
        adm, ddpm = build_adm(torch, dev), build_ddpm(torch, dev)
        log("== phase 27 alone: the rest of the JAX package")
        rec = phase_rest(torch, dev, score, clf, adm, ddpm, smi)
        phase_done("27")
        (OUT / "phase27.json").write_text(json.dumps(dict(card=smi, phase_s=phase_s, **rec),
                                                     indent=1, default=str))
        return 3
    if args.profile_cifar:
        profile_cifar(torch, dev, smi)
        return 3
    if args.profile_grad:
        profile_grad(torch, dev, smi)
        return 3
    if args.profile_adm or args.profile_ddpm:
        if args.profile_adm:
            what, tag, n = "ImageNet ADM", "adm", ADM_N
            model = build_adm(torch, dev)
            x, t = (torch.randn(n, 256, 256, 3, device=dev),
                    torch.full((n,), 149, dtype=torch.int32, device=dev))
        else:
            what, tag, n = "score_sde DDPM", "ddpm", N
            model = build_ddpm(torch, dev)
            x, t = torch.randn(n, 32, 32, 3, device=dev), torch.full((n,), 99.9, device=dev)
        log(f"== profile: {what} evaluations, batch {n}, {'bf16' if tag == 'adm' else 'fp32'}")
        prof = profile_eval(torch, model, x, t)
        (OUT / f"profile_{tag}.json").write_text(json.dumps(dict(card=smi, **prof), indent=1))
        log(f"  wall {prof['wall_ms_per_eval']:.2f} ms, device {prof['device_ms_per_eval']:.2f} "
            f"ms per evaluation, idle share {prof['idle_share']:.3f} on {smi}")
        for fam, ms in sorted(prof["by_family"].items(), key=lambda kv: -kv[1]):
            log(f"  {fam:38s} {ms:8.3f} ms")
        for name, ms, calls in prof["top_kernels"]:
            log(f"  {ms:8.3f} ms x{calls:<4d} {name[:100]}")
        return 3

    cpu = CpuSide(torch)  # the CPU's side of the card-against-CPU checks, in its own thread

    # ---- phase 2 ------------------------------------------------------------
    log("== phase 2: kernel against plain at the main-path shapes, batch 8")
    score, clf = build_models(torch, dev, torch.bfloat16)
    rng = np.random.default_rng(SEED + 2)
    x01 = torch.from_numpy(rng.uniform(size=(N, 32, 32, 3)).astype(np.float32)).to(dev)
    shapes = shape_census(torch, score, x01 * 2 - 1)
    per_eval = {k: sum(c for s, c in shapes.items() if s[0] == k) for k in KERNELS}
    if per_eval != {k: v[2] for k, v in KERNELS.items()}:
        raise AssertionError(f"block calls per evaluation {per_eval}")
    attn_shapes = {s: c for s, c in shapes.items() if s[0] == "fused_attnblock"}
    if attn_shapes != ATTN_CENSUS:
        raise AssertionError(f"attention block census {attn_shapes} != {ATTN_CENSUS}")
    records = phase_kernels(torch, dev, shapes)
    log(f"== phase 2 at batch {GRAD_N} (phase 5's gradient batch), bf16 attention block")
    attn16_records = phase_kernels(torch, dev, attn_shapes, n=GRAD_N, dtypes=("bfloat16",))
    log(f"== phase 2 at batch {CIFAR_BIG_N} (bench.py's CIFAR batch), bf16 blocks")
    big_records = phase_kernels(torch, dev, shapes, n=CIFAR_BIG_N, dtypes=("bfloat16",))
    log(f"== phase 2 at batch {F32_BIG_N} (the run scripts' batch), fp32 blocks #1 / #2; "
        f"cuDNN's fp32 convs with torch.backends.cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    f32_records = phase_f32_blocks(torch, dev, shapes)
    log("== phase 2, the fp32 GEMM alone against cuDNN's conv, and its ablated copies")
    f32_ablation = phase_f32_ablation(torch, dev)
    log("== phase 2, up and down blocks with an identity skip (off the census)")
    identity_checks = phase_identity_resample(torch, dev)
    log("== phase 2, the attention block with a non-finite example beside finite ones")
    isolation_checks = phase_attn_isolation(torch, dev)
    phase_done("2")
    zero_bwd = {k: 0 for k in BWD_KERNELS}
    zero_adm = {k: 0 for k in ADM_KERNELS}
    zero_ddpm = {k: 0 for k in DDPM_KERNELS}

    # ---- phase 2b -----------------------------------------------------------
    log("== phase 2b: backward kernel against plain at the main-path shapes, batch 8")
    bwd_records = phase_bwd_kernels(torch, dev, shapes)
    bwd_per_eval(bwd_records, f"batch {N}")
    log(f"== phase 2b at batch {GRAD_N} (phase 5's gradient batch), bf16")
    bwd16_records = phase_bwd_kernels(torch, dev, shapes, n=GRAD_N, dtypes=("bfloat16",))
    bwd_per_eval(bwd16_records, f"batch {GRAD_N}")
    # fp32, the run scripts' precision: at phase 5's batch and theirs, each
    # batch's device time from one profiler session
    bwd_f32_records = {}
    for n in (GRAD_N, F32_BIG_N):
        log(f"== phase 2b at batch {n}, fp32 #4 / #5; cuDNN's fp32 products with "
            f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
        bwd_f32_records[n] = phase_bwd_kernels(torch, dev, shapes, n=n, dtypes=("float32",),
                                               plain_timing=n != F32_BIG_N, one_session=True)
        bwd_per_eval(bwd_f32_records[n], f"batch {n}")
    phase_done("2b")
    (OUT / "result.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
        wgmma=wgmma, shapes=records, big_shapes=big_records, attn16_shapes=attn16_records,
        identity_checks=identity_checks, isolation_checks=isolation_checks, bwd_shapes=bwd_records, bwd16_shapes=bwd16_records,
        bwd_f32_shapes=bwd_f32_records, f32_shapes=f32_records, f32_ablation=f32_ablation,
        phase_s=phase_s), indent=1))
    if args.stop_after == "2b":
        log("stopped after phase 2b as asked (partial run)")
        return 3

    # ---- phase 2c -----------------------------------------------------------
    log(f"== phase 2c: 256-px kernels against plain at the ImageNet ADM's shapes, "
        f"batch {ADM_N}")
    adm = build_adm(torch, dev)
    x256 = torch.from_numpy(rng.standard_normal((ADM_N, 256, 256, 3)).astype(np.float32))
    census = adm_census(torch, adm, x256.to(dev))
    adm_per_eval = {k: sum(c for (n, _), c in census.items() if n == k) for k in ADM_KERNELS}
    log(f"  launches per evaluation: {adm_per_eval}; {len(census)} shapes")
    if min(adm_per_eval.values()) == 0:
        raise AssertionError(f"a 256-px kernel is off the ADM's path: {adm_per_eval}")
    adm_records = phase_adm_kernels(torch, dev, census)
    log("== phase 2c, flash attention at the head widths off the census")
    flash_width_records = phase_flash_widths(torch, dev)
    phase_done("2c")
    (OUT / "result.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
        wgmma=wgmma, shapes=records, bwd_shapes=bwd_records, adm_shapes=adm_records,
        flash_widths=flash_width_records, adm_per_eval=adm_per_eval, phase_s=phase_s),
        indent=1))
    if args.stop_after == "2c":
        log("stopped after phase 2c as asked (partial run)")
        return 3

    # ---- phase 2d -----------------------------------------------------------
    log(f"== phase 2d: GroupNorm+SiLU at the score_sde DDPM's shapes and fused bias + "
        f"leaky ReLU, batch {N}")
    ddpm = build_ddpm(torch, dev)
    gn_census, attn_census, ddpm_flops = ddpm_census(torch, ddpm, x01 * 2 - 1)
    log(f"  GNSiLU calls per evaluation: {sum(gn_census.values())} at {len(gn_census)} "
        f"shapes {gn_census}; attention blocks {attn_census}; {ddpm_flops / 1e9:.2f} GFLOP "
        f"per evaluation at batch {N}")
    if not gn_census or not attn_census:
        raise AssertionError("the DDPM's census found no GNSiLU or no attention block")
    gn_act_records = phase_gn_act_kernels(torch, dev, gn_census)
    ddpm_shapes = {kind: {f"{H}x{H}x{C}": n for (H, C), n in census.items()}
                   for kind, census in (("gn_silu", gn_census), ("attention", attn_census))}
    ddpm_shapes["flops_per_eval"] = ddpm_flops
    phase_done("2d")
    if args.stop_after == "2d":
        (OUT / "result.json").write_text(json.dumps(dict(
            card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
            shapes=records, bwd_shapes=bwd_records, bwd16_shapes=bwd16_records,
            adm_shapes=adm_records, flash_widths=flash_width_records,
            gn_act_shapes=gn_act_records, ddpm_census=ddpm_shapes, phase_s=phase_s),
            indent=1))
        log("stopped after phase 2d as asked (partial run)")
        return 3

    # ---- phase 3 ------------------------------------------------------------
    log("== phase 3: DefendedModel, t*=100, bf16 NCSN++ + WRN-28-10, batch 8")
    cfg = PurifyConfig(t=EVALS, grad_mode="none")
    dm = DefendedModel(score, clf, cfg, log_every=0)
    y = torch.from_numpy(rng.integers(0, 10, N)).to(dev)
    logits = []

    def model_fn(xb, seed):
        out = dm(xb, seed)
        logits.append(out)
        return out

    runs = []
    for run in range(2):  # the first run includes cuDNN's warm-up
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            acc = get_accuracy(model_fn, x01, y, seed=SEED + 3, bs=N)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        runs.append(dict(wall_s=wall, images_per_s=N / wall, counts=counts))
        log(f"run {run}: {wall:.3f} s, {N / wall:.3f} images/s, accuracy {acc:.3f} "
            f"(random weights), launches {counts}")
        want = {**{k: v[2] * EVALS for k, v in KERNELS.items()}, **zero_bwd, **zero_adm,
                **zero_ddpm}
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want}")
    out = logits[-1]
    if tuple(out.shape) != (N, 10) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad logits: shape {tuple(out.shape)}")
    main_counts = runs[0]["counts"]
    log(f"slice (warm run): {runs[1]['images_per_s']:.3f} images/s on {smi}")
    phase_done("3")

    # ---- phase 3b -----------------------------------------------------------
    log(f"== phase 3b: DefendedModel, t*=100, bf16 NCSN++ + WRN-28-10, batch {CIFAR_BIG_N}")
    x128 = torch.from_numpy(rng.uniform(size=(CIFAR_BIG_N, 32, 32, 3)).astype(np.float32)).to(dev)
    y128 = torch.from_numpy(rng.integers(0, 10, CIFAR_BIG_N)).to(dev)
    big_runs = []
    for run in ("cold", "warm"):
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30  # what earlier phases left allocated
        t0 = time.time()
        with torch.inference_mode():
            acc = get_accuracy(model_fn, x128, y128, seed=SEED + 8, bs=CIFAR_BIG_N)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        big_runs.append(dict(run=run, wall_s=wall, images_per_s=CIFAR_BIG_N / wall,
                             counts=counts, peak_gib=peak, held_gib=held))
        log(f"  {run}: {wall:.3f} s, {CIFAR_BIG_N / wall:.3f} images/s on {smi}, accuracy "
            f"{acc:.3f} (random weights); peak device memory {peak:.2f} GiB ({held:.2f} GiB "
            f"held before the call); launches {counts}")
        if counts != want:  # one defended call of 100 evaluations: as phase 3's
            raise AssertionError(f"launch counts {counts} != {want}")
    out = logits[-1]
    if tuple(out.shape) != (CIFAR_BIG_N, 10) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad logits: shape {tuple(out.shape)}")
    phase_done("3b")

    # ---- phase 3c -----------------------------------------------------------
    log(f"== phase 3c: DefendedModel, t*=100, fp32 NCSN++ + WRN-28-10 (the run scripts' "
        f"precision and batch), batch {F32_BIG_N}")
    f32_runs = phase_f32_defended(torch, dev, score, clf, rng, smi, want)
    phase_done("3c")

    # ---- phase 4 ------------------------------------------------------------
    log("== phase 4: purification t*=5, kernels (GPU) against plain (CPU)")
    cfg5 = PurifyConfig(t=5, grad_mode="none")
    x5 = x01[:2]
    slice_checks = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        score.dtype = dtype
        with torch.inference_mode():
            got = DefendedModel(score, clf, cfg5, log_every=0).purify(x5, FixedNoise(SEED + 4))
        score.cpu()
        with torch.inference_mode():
            want = DefendedModel(score, clf, cfg5, log_every=0).purify(
                x5.cpu(), FixedNoise(SEED + 4))
        score.to(dev)
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= SLICE_REL[dtype_name] * scale
        slice_checks[dtype_name] = dict(max_abs_err=err, rel_err=err / scale,
                                        rel_tol=SLICE_REL[dtype_name], ok=ok)
        log(f"  {dtype_name}: max |kernel - plain| {err:.3e} (rel {err / scale:.2e} <= "
            f"{SLICE_REL[dtype_name]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"slice {dtype_name}: kernel and plain disagree")
    phase_done("4")

    # ---- phase 5 ------------------------------------------------------------
    log(f"== phase 5: input gradient of CE(DefendedModel), t*=100, bf16, batch {GRAD_N}")
    score.dtype = torch.bfloat16
    for m in (score, clf):
        m.requires_grad_(False)
    xg = torch.from_numpy(rng.uniform(size=(GRAD_N, 32, 32, 3)).astype(np.float32)).to(dev)
    yg = torch.from_numpy(rng.integers(0, 10, GRAD_N)).to(dev)
    grad_runs = []
    for mode in GRAD_MODES:
        dmg = DefendedModel(score, clf, PurifyConfig(t=EVALS, grad_mode=mode), log_every=0)
        fwd, bwd = GRAD_EVALS[mode]
        want = {**{k: v[2] * EVALS * fwd for k, v in KERNELS.items()},
                **{k: KERNELS[v[2]][2] * EVALS * bwd for k, v in BWD_KERNELS.items()},
                **zero_adm, **zero_ddpm}
        for run in ("cold", "warm"):
            reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            gx, _ = input_grad(torch, dmg, xg, yg, SEED + 5)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            grad_runs.append(dict(mode=mode, run=run, wall_s=wall,
                                  grad_images_per_s=GRAD_N / wall, counts=counts,
                                  peak_gib=peak, grad_abs_max=float(gx.abs().max())))
            log(f"  {mode:10s} {run}: {wall:.3f} s, {GRAD_N / wall:.3f} gradient-images/s "
                f"on {smi}; peak device memory {peak:.2f} GiB; launches {counts}")
            if tuple(gx.shape) != tuple(xg.shape) or not bool(torch.isfinite(gx).all()) \
                    or not bool((gx != 0).any()):
                raise AssertionError(f"{mode}: bad input gradient, shape {tuple(gx.shape)}")
            if counts != want:
                raise AssertionError(f"{mode}: launch counts {counts} != {want}")
    log(f"== phase 5, fp32 (the run scripts' precision): checkpoint, batch {GRAD_N}")
    f32_grad_runs = phase_f32_grad(torch, score, clf, xg, yg, smi)
    phase_done("5")

    # ---- phase 6 ------------------------------------------------------------
    # The gradient of sum(w * purified image) for a seeded cotangent w: the
    # score model's path, where the kernels are. The classifier is left out:
    # WRN-28-10's ReLU gradient is piecewise constant in its input, so the
    # ~5e-6 by which the card's and the CPU's purified images differ
    # (phase 4) flips units and moves its gradient by percents.
    log("== phase 6: purification input gradient t*=5, batch 2, kernels (GPU) against "
        "plain (CPU)")
    x6 = x01[:2]
    w6 = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    got6 = purify_grads(torch, score, x6, w6, (("float32", torch.float32),
                                                ("bfloat16", torch.bfloat16)))
    score_cpu, x6_cpu = cpu.copy("score", score), x6.cpu()
    job6 = cpu.submit("phase 6", lambda: purify_grads(torch, score_cpu, x6_cpu, w6,
                                                       (("float32", torch.float32),)))
    log("  the card's side done; the CPU's runs beside phase 7")
    phase_done("6")

    # ---- phase 7 ------------------------------------------------------------
    # The labels are the defence's own prediction under the noise the
    # defended suite's first (clean) evaluation draws, so every example
    # starts robust and APGD runs through the defence on all of them.
    log(f"== phase 7: eval_autoattack, version 'rand' (eot_iter=1, n_iter=2), t*={AA_T}, "
        "bf16, batch 8, grad_mode 'checkpoint'")
    dm7 = DefendedModel(score, clf, PurifyConfig(t=AA_T, grad_mode="checkpoint"), log_every=0)
    # one EOT sample (phase 17 runs two through the ImageNet defence): the
    # run's time limit holds the new phases
    aa_cfg = AutoAttackConfig(version="rand", eot_iter=1, n_iter=2)
    with torch.no_grad():
        y7 = dm7(x01, fold_in(fold_in(SEED + 7, 1), 7)).argmax(-1)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = eval_autoattack(dm7, x01, y7, SEED + 7, aa_cfg, log=lambda s: log(f"  {s}"))
    torch.cuda.synchronize()
    attack_s = time.time() - t0
    attack_counts = launch_counts()
    x_adv = res["x_adv"]
    dist = float((x_adv - x01).abs().max())
    accs = (res["classifier_robust_acc"], res["defended_robust_acc"])
    log(f"  {attack_s:.1f} s; robust accuracy: classifier {accs[0]:.3f}, defended "
        f"{accs[1]:.3f} (random weights: these numbers mean nothing); "
        f"max |x_adv - x| {dist:.5f} <= eps {aa_cfg.eps:.5f}; launches {attack_counts}")
    if tuple(x_adv.shape) != tuple(x01.shape) or not bool(torch.isfinite(x_adv).all()) \
            or dist > aa_cfg.eps + 1e-6 or float(x_adv.min()) < 0 or float(x_adv.max()) > 1:
        raise AssertionError("x_adv leaves the eps-ball or [0, 1]")
    if not all(0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"robust accuracies {accs} are not fractions")
    idle = [k for k, v in attack_counts.items()
            if v == 0 and k not in ADM_KERNELS and k not in DDPM_KERNELS]
    if idle:
        raise AssertionError(f"kernels of the attack path never launched: {idle}")
    log("== phase 6's checks: purification input gradient, kernels (GPU) against plain (CPU)")
    grad_checks = check_purify_grads(torch, got6, cpu.result(job6))
    phase_done("7")

    # ---- phase 8 ------------------------------------------------------------
    log(f"== phase 8: ImageNet DefendedModel(resize_to=256), guided-diffusion t*={ADM_EVALS}, "
        f"bf16 ADM + ResNet-50, batch {ADM_N}")
    rn50 = imagenet_classifier(torch, dev)
    adm.dtype = torch.bfloat16
    guided = dict(score_type="guided_diffusion", grad_mode="none")
    dm8 = DefendedModel(adm, rn50, PurifyConfig(t=ADM_EVALS, **guided), log_every=0,
                        resize_to=256)
    x224 = torch.from_numpy(rng.uniform(size=(ADM_N, 224, 224, 3)).astype(np.float32)).to(dev)
    want8 = {**{k: 0 for k in KERNELS}, **zero_bwd, **zero_ddpm,
             **{k: v * ADM_EVALS for k, v in adm_per_eval.items()}}
    adm_runs = []
    for run in ("cold", "warm"):
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with torch.inference_mode():
            logits8 = dm8(x224, SEED + 12)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts8 = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        adm_runs.append(dict(run=run, wall_s=wall, images_per_s=ADM_N / wall,
                             counts=counts8, peak_gib=peak))
        log(f"  {run}: {wall:.3f} s, {ADM_N / wall:.4f} images/s on {smi}; peak device "
            f"memory {peak:.2f} GiB; launches {counts8}")
        if counts8 != want8:
            raise AssertionError(f"launch counts {counts8} != {want8}")
        if tuple(logits8.shape) != (ADM_N, 1000) or not bool(torch.isfinite(logits8).all()):
            raise AssertionError(f"bad logits: shape {tuple(logits8.shape)}")
    adm_counts = adm_runs[0]["counts"]
    log(f"ImageNet slice (warm run): {adm_runs[1]['images_per_s']:.4f} images/s on {smi}")
    phase_done("8")

    # ---- phase 9 ------------------------------------------------------------
    log("== phase 9: full-width ADM evaluation (batch 1) and t*=3 fp32 purification, "
        "kernels (GPU) against plain (CPU): the card's side")
    x9 = torch.from_numpy(rng.standard_normal((1, 256, 256, 3)).astype(np.float32) * 0.5)
    t9 = torch.tensor([149], dtype=torch.int32)
    x9p = torch.from_numpy(rng.uniform(size=(1, 256, 256, 3)).astype(np.float32))
    cfg9 = PurifyConfig(t=3, score_type="guided_diffusion", grad_mode="none")
    t0 = time.time()
    card9 = adm_outputs(torch, adm, x9.to(dev), t9.to(dev), x9p.to(dev), cfg9,
                        (("float32", torch.float32), ("bfloat16", torch.bfloat16)))
    log(f"  card: {time.time() - t0:.1f} s; the CPU's side runs beside phases 11-14")
    phase_done("9")

    # ---- phase 10 -----------------------------------------------------------
    log("== phase 10: DefendedModel, t*=100, score_sde DDPM (fp32) + WRN-28-10, batch 8")
    dm10 = DefendedModel(ddpm, clf, PurifyConfig(t=EVALS, grad_mode="none"), log_every=0)
    logits10 = []

    def model_fn10(xb, seed):
        out = dm10(xb, seed)
        logits10.append(out)
        return out

    want10 = {**{k: 0 for k in launch_counts()},
              "group_norm_silu_fused": EVALS * sum(gn_census.values()),
              "fused_attnblock": EVALS * sum(attn_census.values())}
    ddpm_runs = []
    for run in ("cold", "warm"):
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with torch.inference_mode():
            acc = get_accuracy(model_fn10, x01, y, seed=SEED + 21, bs=N)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts10 = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ddpm_runs.append(dict(run=run, wall_s=wall, images_per_s=N / wall, counts=counts10,
                              peak_gib=peak))
        log(f"  {run}: {wall:.3f} s, {N / wall:.3f} images/s on {smi}, accuracy {acc:.3f} "
            f"(random weights); peak device memory {peak:.2f} GiB; launches {counts10}")
        if counts10 != want10:
            raise AssertionError(f"launch counts {counts10} != {want10}")
    out10 = logits10[-1]
    if tuple(out10.shape) != (N, 10) or not bool(torch.isfinite(out10).all()):
        raise AssertionError(f"bad logits: shape {tuple(out10.shape)}")
    ddpm_counts = ddpm_runs[0]["counts"]
    log(f"DDPM slice (warm run): {ddpm_runs[1]['images_per_s']:.3f} images/s on {smi}")
    phase_done("10")

    # phase 9's CPU side, on a CPU copy of the ADM, beside phases 11-14 (after
    # phase 10's timed runs: the host paces them)
    adm_cpu = cpu.copy("adm", adm)
    job9 = cpu.submit("phase 9", lambda: adm_outputs(torch, adm_cpu, x9, t9, x9p, cfg9,
                                                      (("float32", torch.float32),)))

    # ---- phase 11 -----------------------------------------------------------
    log("== phase 11: DDPM purification t*=5 (fp32) and an NCSN++ 'ddpm' evaluation "
        "(fp32, bf16), kernels (GPU) against plain (CPU)")
    from diffpure_tpu_torch.models import NCSNpp
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
    ncsn_ddpm = NCSNpp(resblock_type="ddpm", num_res_blocks=2).eval()
    ncsn_ddpm.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                               seeded_normal_state_dict(ncsn_ddpm, SEED + 23).items()})
    ncsn_ddpm.requires_grad_(False).to(dev)
    x11 = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32) * 0.5)
    t11 = torch.tensor([99.9, 500.0])
    card11, cpu11 = {}, {}
    for where, out11, device in (("card", card11, dev), ("cpu", cpu11, torch.device("cpu"))):
        t0 = time.time()
        for m in (ddpm, ncsn_ddpm):
            m.to(device)
        with torch.inference_mode():
            out11["purify"] = DefendedModel(ddpm, clf, cfg5, log_every=0).purify(
                x01[:2].to(device), FixedNoise(SEED + 22)).cpu()
            for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                ncsn_ddpm.dtype = dtype
                reset_launch_counts()
                out11[dtype_name] = ncsn_ddpm(x11.to(device), t11.to(device)).float().cpu()
                out11[f"{dtype_name}_gn_silu_launches"] = launch_counts()["group_norm_silu_fused"]
        log(f"  {where}: {time.time() - t0:.1f} s")
    for m in (ddpm, ncsn_ddpm):
        m.to(dev)
    if not (card11["float32_gn_silu_launches"] > 0 and card11["bfloat16_gn_silu_launches"] > 0):
        raise AssertionError("NCSN++ 'ddpm' on the card did not launch GroupNorm+SiLU")
    ddpm_checks = {}
    for what, bound in (("purify", DDPM_PURIFY_REL), ("float32", NCSN_DDPM_REL["float32"]),
                        ("bfloat16", NCSN_DDPM_REL["bfloat16"])):
        got, want = card11[what], cpu11[what]
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        ok = bool(torch.isfinite(got).all()) and tuple(got.shape) == tuple(want.shape) \
            and err <= bound * scale
        ddpm_checks[what] = dict(max_abs_err=err, rel_err=err / scale, rel_tol=bound, ok=ok)
        log(f"  {what:8s}: max |card - cpu| {err:.3e} (rel {err / scale:.2e} <= {bound:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
    gap = float((card11["bfloat16"] - cpu11["float32"]).abs().max() / cpu11["float32"].abs().max())
    ddpm_checks["card_bf16_vs_cpu_fp32"] = gap
    log(f"  card bf16 against CPU fp32: rel {gap:.2e}; #10 launches per NCSN++ 'ddpm' "
        f"evaluation on the card: {card11['bfloat16_gn_silu_launches']}")
    bad = [k for k, v in ddpm_checks.items() if isinstance(v, dict) and not v["ok"]]
    if bad:
        raise AssertionError(f"DDPM card against CPU: {bad} disagree")
    phase_done("11")

    # ---- phase 12 -----------------------------------------------------------
    log(f"== phase 12: eval_bpda (BPDA+EOT), t*={BPDA_T}, bf16 NCSN++ + WRN-28-10, batch "
        f"{BPDA_N}, {BPDA_CFG}")
    bpda_runs = phase_bpda(torch, score, clf, x01[:BPDA_N], smi)
    phase_done("12")

    # ---- phase 13 -----------------------------------------------------------
    log(f"== phase 13: DPM-Solver++(2M) purification, t*={EVALS}, {DPM_STEPS} steps, bf16, "
        f"batch {N}; t*=5 in 3 steps and its input gradient, kernels (GPU) against plain "
        f"(CPU)")
    dpm_runs, finish_dpm = phase_dpm(torch, dev, score, clf, x01, x6, w6, smi, cpu)
    phase_done("13")

    # ---- phase 14 -----------------------------------------------------------
    log("== phase 14: the CLI, python -m diffpure_tpu_torch.cli, on the CIFAR-10 BPDA, rand "
        "and rand L2 and the three ImageNet rand run scripts' flags with tiny budgets, seeded "
        "fixtures (ImageNet: an image folder and an LMDB), random weights")
    cli_runs = phase_cli(rng)
    log("== phase 9's checks: full-width ADM evaluation and purification, card against CPU")
    adm_checks = check_adm_outputs(torch, card9, cpu.result(job9))
    log("== phase 13's checks: DPM-Solver++(2M) t*=5, kernels (GPU) against plain (CPU)")
    dpm_checks = finish_dpm()
    phase_done("14")

    # ---- phase 15 -----------------------------------------------------------
    log(f"== phase 15: ImageNet purification input gradient, t*={ADM_GRAD_PARITY_T}, batch 1, "
        f"full-width ADM (flash on), fp32 + bf16, both grad modes, kernels "
        f"(GPU) against plain (CPU)")
    start_adm_grad, finish_adm_grad = phase_adm_grad_parity(torch, dev, adm, rn50, rng, smi,
                                                            cpu)
    phase_done("15")

    # ---- phase 16 -----------------------------------------------------------
    log(f"== phase 16: input gradient of CE(DefendedModel(resize_to=256)), t*={ADM_GRAD_T}, "
        f"bf16 ADM + ResNet-50, batch {ADM_GRAD_N}, both grad modes, once each (warm)")
    adm_grad_runs = phase_adm_grad_rate(torch, dev, adm, rn50, adm_per_eval, rng, smi)
    start_adm_grad()  # phase 15's CPU side, beside phases 17-19 (the host paces phase 16)
    phase_done("16")

    # ---- phase 17 -----------------------------------------------------------
    log(f"== phase 17: eval_autoattack, version 'rand', through the ImageNet defence (bf16 ADM "
        f"+ ResNet-50, checkpoint), {AA_IMAGENET}")
    adm_attack = phase_adm_attack(torch, dev, adm, rn50, rng, smi)
    phase_done("17")

    # ---- phase 18 -----------------------------------------------------------
    log("== phase 18: #10's gradient: the t*=5 DDPM purification (fp32, batch 2, both modes) "
        "and an NCSN++ 'ddpm' evaluation (bf16), kernels (GPU) against plain (CPU)")
    if (sum(gn_census.values()), sum(attn_census.values())) != DDPM_GRAD_CENSUS:
        raise AssertionError(f"the DDPM's census {gn_census} {attn_census} is not "
                             f"{DDPM_GRAD_CENSUS} per evaluation")
    gn_grad_checks = phase_gn_silu_grad(torch, dev, ddpm, ncsn_ddpm, clf, rng, smi)
    phase_done("18")

    # ---- phase 19 -----------------------------------------------------------
    log(f"== phase 19: the CIFAR classifier zoo at full width (fp32, card against CPU, batch "
        f"{ZOO_N}; ms a forward at batch {ZOO_RATE_N}) and the bf16 NCSN++ + WRN-70-16-dropout "
        f"defence at t*={EVALS}, batch {N}")
    for m in (ddpm, ncsn_ddpm, adm):
        m.cpu()  # the ImageNet and DDPM phases are done: free the card's memory
    torch.cuda.empty_cache()
    zoo, wrn70 = phase_classifiers(torch, dev, score, x01, rng, smi)
    log("== phase 15's checks: ImageNet purification input gradient, card against CPU")
    adm_grad_checks = finish_adm_grad()
    phase_done("19")

    # ---- phase 20 -----------------------------------------------------------
    log(f"== phase 20: the ODE, LDSDE and reversible purifiers: ODE t*={EVALS}, bf16, batch {N}; "
        f"t*={PURIFY_T}, batch {PURIFY_N}, {len(PURIFY_MODES)} modes, fp32 + bf16, card against "
        f"CPU; reversible Heun's gradient at batch {GRAD_N}, t*={REV_T}")
    warm5 = [r for r in grad_runs if r["run"] == "warm"]
    purifiers, finish_purifiers = phase_purifiers(torch, dev, score, clf, x01, rng, smi, cpu,
                                                  sde_rate=runs[1]["images_per_s"],
                                                  grad_runs=warm5)
    # phase 23's CPU side, queued behind 20(b)'s: both run beside phases 21-22
    guided_plain = start_guided_plain(torch, cpu, adm, rng)
    phase_done("20")

    # ---- phase 21 -----------------------------------------------------------
    log(f"== phase 21: eval_autoattack 'standard' through the bf16 CIFAR defence, {AA_STANDARD}, "
        f"Linf and L2; then the CLI on {', '.join(STAND_CLI_RUNS)}'s flags with tiny budgets")
    standard = phase_standard(torch, dev, score, clf, wrn70, x01, rng, smi)
    log("== phase 20(b)'s checks: the purifiers at t*=2, card against CPU")
    purifiers = finish_purifiers()
    phase_done("21")

    # ---- phase 22 -----------------------------------------------------------
    log(f"== phase 22: StAdv through the fp32 CIFAR defence (NCSN++ + ResNet-50), {STADV}; "
        f"grid_sample card against CPU")
    stadv_run = phase_stadv(torch, dev, score, rng, smi)
    score.dtype = torch.bfloat16
    phase_done("22")

    # ---- phase 23 -----------------------------------------------------------
    log(f"== phase 23: the discrete guided DDPM through the bf16 ADM (flash) + ResNet-50, "
        f"t={GUIDED_T} ancestral and t={DDIM_T} DDIM ({DDIM_RESPACING}), batch {ADM_N}; "
        f"t={DISCRETE_PARITY_T}, batch 1, card against CPU and an input gradient")
    guided = phase_guided_ddpm(torch, dev, adm, rn50, adm_per_eval, rng, smi, cpu, guided_plain)
    torch.cuda.empty_cache()
    phase_done("23")

    # ---- phase 24 -----------------------------------------------------------
    log(f"== phase 24: the CelebA-HQ defence, full-width DDPM UNet + attribute net, "
        f"t={CELEBAHQ_T}, batch {CELEBAHQ_N}, bf16 and fp32; t={DISCRETE_PARITY_T}, batch 1, "
        f"card against CPU; then the CLI on {', '.join(NEW_CLI_RUNS)}'s flags, at once")
    celebahq, finish_celebahq = phase_celebahq(torch, dev, rng, smi, cpu)
    torch.cuda.empty_cache()
    new_cli = phase_new_cli(torch, dev, rng, smi)
    log("== phase 24's checks: the CelebA-HQ UNet and attribute net, card against CPU")
    celebahq = finish_celebahq()
    phase_done("24")

    # ---- phase 25 -----------------------------------------------------------
    log(f"== phase 25(a): the --large demo's score-matching step, full-width fp32 NCSN++, "
        f"batch {TRAIN_N}; batch {TRAIN_PARITY_N} card against CPU; the forward after the "
        f"weights move")
    train_step, finish_train = phase_train_step(torch, dev, rng, smi, cpu)
    torch.cuda.empty_cache()
    log(f"== phase 25(c)'s shapes: the demo's score model on the card, kernels against its "
        f"plain blocks at batch {DEMO_SCORE_N} (a step) and {DEMO_EVAL_N} (forward, input "
        f"gradient)")
    demo_shapes = phase_demo_shapes(torch, dev, rng)
    log(f"== phase 25(c): the defence demo, python -m diffpure_tpu_torch.experiments."
        f"defense_demo --device cuda {' '.join(DEMO_ARGS)}")
    demo_run = phase_demo(torch, smi)
    train_checks = finish_train()
    cpu.close()
    log(f"== phase 25(b): TrainLoop on the score_sde DDPM (fp32), batch {DDPM_TRAIN_N}; save, "
        f"resume, one more step")
    train_loop = phase_train_loop(torch, dev, smi)
    phase_done("25")

    # ---- phase 26 -----------------------------------------------------------
    log(f"== phase 26: the score_sde samplers and legacy score models: (a) the VE NCSN++ "
        f"(configs/cifar10_ve.yml), (b) the VP PC and ODE samplers (configs/cifar10.yml), "
        f"N = {SAMPLER_N}, batch {SAMPLER_BATCH}, (c) NCSNv2 with annealed Langevin dynamics")
    samplers = phase_samplers(torch, dev, score, smi)
    phase_done("26")

    # ---- phase 27 -----------------------------------------------------------
    log("== phase 27: the rest of the JAX package: guided-diffusion's classifier and "
        "upsampler, the mister_ed attacks, serving over a mesh, the DDPM's training mode")
    rest = phase_rest(torch, dev, score, clf, adm, ddpm, smi)
    phase_done("27")

    # ---- report -------------------------------------------------------------
    kernels = []
    for name, (source, replaces, *_) in {**KERNELS, **BWD_KERNELS}.items():
        pool = bwd_records if name in BWD_KERNELS else records
        mine = [r for r in pool if r["kernel"] == name and r["dtype"] == "bfloat16"]
        bound, bound_by = bound_ms(mine)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            # the forward kernels' count from the serving path (phase 3), the
            # backward kernels' from the attack path (phase 7)
            launches=(attack_counts if name in BWD_KERNELS else main_counts)[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            # per score evaluation (its backward, for the backward kernels):
            # the kernel's calls at each shape, bf16, batch 8
            ms=sum(r["ms"] * r["calls_per_eval"] for r in mine),
            plain_ms=sum(r["plain_ms"] * r["calls_per_eval"] for r in mine),
            bound_ms=bound, bound_by=bound_by,
            # no single PyTorch call computes any of these blocks; the
            # attention block's yardstick is its steps in one PyTorch call
            # each (attn_yardstick)
            library_ms=sum(r["library_ms"] * r["calls_per_eval"] for r in mine)
            if name == "fused_attnblock" else None))
        if name != "fused_attnblock":
            # the fp32 chain (the run scripts' precision), per evaluation (its
            # backward) at batch 8 and F32_BIG_N (and GRAD_N for the backward):
            # CUDA events, device time, bound
            pools = ((N, pool), (F32_BIG_N, f32_records)) if name in KERNELS else \
                ((N, pool), (GRAD_N, bwd_f32_records[GRAD_N]),
                 (F32_BIG_N, bwd_f32_records[F32_BIG_N]))
            kernels[-1]["fp32"] = {
                f"batch_{n}": dict(
                    ms=sum(r["ms"] * r["calls_per_eval"] for r in rs),
                    device_ms=sum(r["device_ms"] * r["calls_per_eval"] for r in rs),
                    bound_ms=sum(r["bound_ms"] * r["calls_per_eval"] for r in rs),
                    max_abs_err=max(r["max_abs_err"] for r in rs))
                for n, rs in ((n, [r for r in rs if r["kernel"] == name
                                   and r["dtype"] == "float32"]) for n, rs in pools)}
    for name, (source, replaces) in ADM_KERNELS.items():
        # per ADM evaluation at batch 4, bf16: the kernel's calls at each shape
        mine = [r for r in adm_records if r["kernel"] == name and r["dtype"] == "bfloat16"]
        by = {"operations": 0.0, "bytes": 0.0}
        for r in mine:
            by[r["bound_by"]] += r["bound_ms"] * r["calls_per_eval"]
        lib_ms = [r["library_ms"] for r in mine]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=adm_counts[name],  # the ImageNet serving path (phase 8)
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] * r["calls_per_eval"] for r in mine),
            plain_ms=sum(r["plain_ms"] * r["calls_per_eval"] for r in mine),
            bound_ms=sum(by.values()), bound_by=max(by, key=by.get),
            # F.scaled_dot_product_attention for the flash kernel; no single
            # PyTorch call computes the other three
            library_ms=None if None in lib_ms else sum(
                m * r["calls_per_eval"] for m, r in zip(lib_ms, mine))))
    for name, (source, replaces) in DDPM_KERNELS.items():
        # fp32, the DDPM's dtype. #10: per DDPM evaluation at batch 8 (its
        # calls at each census shape); #11, on no path: one call at each of
        # FLR_CASES and, with a bias, FLR_LARGE
        mine = [r for r in gn_act_records if r["kernel"] == name and r["dtype"] == "float32"
                and (name == "group_norm_silu_fused" or r["toy"] or (r["large"] and r["bias"]))]
        calls = [r["calls_per_eval"] if name == "group_norm_silu_fused" else 1 for r in mine]
        by = {"operations": 0.0, "bytes": 0.0}
        for r, c in zip(mine, calls):
            by[r["bound_by"]] += r["bound_ms"] * c
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=ddpm_counts[name],  # the DDPM serving path (phase 10)
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] * c for r, c in zip(mine, calls)),
            plain_ms=sum(r["plain_ms"] * c for r, c in zip(mine, calls)),
            bound_ms=sum(by.values()), bound_by=max(by, key=by.get),
            library_ms=None))  # no single PyTorch call computes either
    (OUT / "result.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
        wgmma=wgmma, shapes=records, big_shapes=big_records, attn16_shapes=attn16_records,
        identity_checks=identity_checks, isolation_checks=isolation_checks, bwd_shapes=bwd_records, bwd16_shapes=bwd16_records,
        bwd_f32_shapes=bwd_f32_records, slice_runs=runs, big_runs=big_runs,
        slice_checks=slice_checks, f32_shapes=f32_records, f32_ablation=f32_ablation,
        f32_runs=f32_runs, f32_grad_runs=f32_grad_runs,
        grad_runs=grad_runs, grad_checks=grad_checks,
        attack=dict(seconds=attack_s, counts=attack_counts, classifier_robust_acc=accs[0],
                    defended_robust_acc=accs[1], max_dist=dist),
        adm_shapes=adm_records, flash_widths=flash_width_records, adm_per_eval=adm_per_eval,
        adm_runs=adm_runs,
        adm_checks=adm_checks, gn_act_shapes=gn_act_records, ddpm_census=ddpm_shapes,
        ddpm_runs=ddpm_runs, ddpm_checks=ddpm_checks, bpda_runs=bpda_runs, dpm_runs=dpm_runs,
        dpm_checks=dpm_checks, cli_runs=cli_runs, adm_grad_checks=adm_grad_checks,
        adm_grad_runs=adm_grad_runs, adm_attack=adm_attack, gn_grad_checks=gn_grad_checks,
        classifier_zoo=zoo, purifiers=purifiers, standard=standard, stadv=stadv_run,
        guided_ddpm=guided, celebahq=celebahq, new_cli_runs=new_cli,
        training=dict(step=train_step, checks=train_checks, train_loop=train_loop,
                      demo=demo_run, demo_shapes=demo_shapes),
        samplers=samplers, rest=rest, phase_s=phase_s, cpu_side_s=cpu.seconds,
        kernels=kernels), indent=1, default=str))
    log(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
