#!/usr/bin/env python3
"""Drive the PyTorch port's CIFAR-10 (NCSN++ and DDPM) and ImageNet-256
defences once on one NVIDIA GPU.

    python3 chip_smoke.py          (from the root of the repository)

Phases, each fatal on failure:
  1. versions, the card's name and power limit, and the build of the CUDA
     kernels from diffpure_tpu_torch/csrc (timed); the count of wgmma
     (HGMMA) instructions in the SASS of the halo conv, flash attention and
     the CIFAR block GEMM, which must be non-zero for their bf16 kernels;
  2. each hand-written kernel against its plain PyTorch version on the card,
     at every shape the CIFAR-10 NCSN++ gives it, batch 8, bf16 and fp32,
     and the bf16 blocks again at batch 128, with seeded random-normal
     weights; per shape the wrappers' CUDA-event time, the kernels' device
     time (profiler), the plain time, and for the bf16 blocks TFLOP/s, the
     share of the bound and cuDNN's convs as a yardstick;
  3. the slice: DefendedModel (full-width configs/cifar10.yml NCSN++ with a
     bf16 torso + WRN-28-10, seeded random weights) on 8 seeded images at
     t*=100 through get_accuracy under inference_mode; the kernel launch
     counters must read exactly 40, 36 and 10 per score evaluation;
  3b. the same at batch 128 (the CIFAR batch of the JAX bench), cold and
     warm, with the same counters per evaluation;
  4. the same purification at t*=5 once through the kernels (on the card)
     and once through the plain versions (on the CPU, where the wrappers
     take them), with the same noise; the purified images must agree;
  2b. (run after phase 2) each backward kernel against its plain version
     (autograd of the plain block on the card) at every resblock and
     concat-resblock shape of the main path, batch 8, bf16 and fp32;
  5. the gradient-image rate: the input gradient of the cross-entropy of
     DefendedModel at t*=100, batch 16, bf16 torso, weights frozen, with
     grad_mode 'checkpoint' and 'adjoint', cold and warm; the launch
     counters must read exactly what each mode derives;
  6. the input gradient of the t*=5 purification (against a seeded
     cotangent) at batch 2, kernels (card) against plain (CPU), same noise,
     both grad modes, bf16 and fp32;
  7. the entry point: eval_autoattack (AutoAttack 'rand', APGD-CE and
     APGD-DLR with EOT) through the full-width bf16 defence at t*=100,
     batch 8; x_adv must lie in the eps-ball and in [0, 1], and every
     kernel of the path must have launched.
  2c. (run after phase 2b) the ImageNet-256 kernels (tiled GroupNorm stats
     and apply, halo conv, flash attention) against their plain versions at
     every shape the full-width imagenet256_config ADM gives them at batch
     4 (a census of the wrappers' calls over one evaluation), bf16 and
     fp32; kernel, plain and bound times, TFLOP/s and share of the bound;
     beside the flash kernel, F.scaled_dot_product_attention on 4-D views
     under each backend that takes the inputs, the fastest that agrees with
     the plain version as its library time (a yardstick on no path);
  8. the ImageNet slice: DefendedModel(resize_to=256) with the
     guided-diffusion purify_sde at t*=150 through that ADM (bf16 torso,
     552,814,086 parameters) and ResNet-50, on 4 seeded 224x224 images under
     inference_mode, cold then warm; the launch counters must read 150 x the
     census for the four 256-px kernels and 0 for the CIFAR ones;
  9. one full-width ADM evaluation at batch 1, fp32 and bf16, and a t*=3
     fp32 purification, kernels (card) against plain (CPU), same noise;
  2d. (run after phase 2c) GroupNorm+SiLU (#10) against its plain version
     at every shape the full-width score_sde DDPM gives it at batch 8 (a
     census of its GNSiLU calls over one evaluation), and fused bias +
     leaky ReLU (#11, on no path) at the DDPM's feature-map shapes and an
     odd one, bf16 and fp32; kernel, plain and bound times;
  10. the DDPM slice: DefendedModel (full-width DDPM, fp32, 35,218,947
     parameters + WRN-28-10) on 8 seeded images at t*=100 through
     get_accuracy under inference_mode, cold then warm; the launch
     counters must read 100 x the census for #10 and the attention block,
     0 for every other kernel;
  11. the t*=5 DDPM purification, and one evaluation of NCSN++ with
     resblock_type='ddpm' (2 blocks per level, fp32 and bf16), kernels
     (card) against plain (CPU), same noise.

Needs the CUDA toolkit (nvcc) and one card; exits non-zero without them.
Writes details (per-shape records, the compiler's report) to
chip_smoke_out/. The second-to-last line of stdout is the kernels' JSON
record, the last the device JSON. ``--stop-after 2b``, ``2c`` or ``2d`` ends
after that phase (a short first run of changed kernels; prints no result
line).
``--profile-adm`` (``--profile-ddpm``) profiles the ImageNet ADM's (the
score_sde DDPM's) evaluation after phase 1 and ends (device time by kernel
family, idle share; profile_adm.json, profile_ddpm.json);
``--profile-cifar`` the CIFAR NCSN++'s at batch 8 and 128, with the block
chains' steps and the host time per block call (profile_cifar.json).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / "chip_smoke_out"
N = 8
SEED = 0
CIFAR_PARAMS = 106_632_579
EVALS = 100  # t* = 100 Euler steps, one score evaluation each
CIFAR_BIG_N = 128  # the CIFAR batch of the JAX bench (bench.py:38 BATCH)
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
# The bf16 kernels that must run on wgmma: HGMMA in their SASS (phase 1).
WGMMA_KERNELS = ("halo_wgmma_kernel", "flash_wgmma_kernel", "rb_wgmma_kernel")
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
# Phase 11, card against CPU, max abs error over max |CPU|: the t*=5 fp32
# DDPM purification as the CIFAR slice's; one NCSN++ 'ddpm' evaluation as
# phase 9's ADM one (fp32: summation order; bf16: card and CPU round at
# other places, #10 once where the plain chain rounds before the SiLU).
DDPM_PURIFY_REL = 1e-4
NCSN_DDPM_REL = {"float32": 2e-4, "bfloat16": 5e-2}


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


def device_ms(torch, fn, reps=10):
    """The kernels' own device time per call of fn, from the profiler over
    ``reps`` back-to-back calls (without the host's gaps between them): the
    total, and its GEMM, GroupNorm and split-K shares (CHAIN_KINDS)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then records no kernel: take another
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {"total": 0.0, "gemm": 0.0, "gn": 0.0, "splitk": 0.0}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if not str(e.device_type).endswith("CUDA") or us <= 0:
                continue
            by["total"] += us / 1e3 / reps
            kind = next((k for k, frags in CHAIN_KINDS if any(f in e.key for f in frags)), None)
            if kind in by:
                by[kind] += us / 1e3 / reps
        if by["total"] > 0:
            return by
    raise AssertionError("three profiler sessions recorded no device time")


def conv_yardstick(torch, params, rs, H, cin, cout, n):
    """cuDNN's F.conv2d on channels_last bf16 for a block's two 3x3 convs and
    its 1x1 projection (on the output grid), at batch n: a yardstick for the
    block's GEMMs only (not the same function: no GroupNorm, no epilogue),
    on no path of the port. Returns (CUDA-event ms, device ms) per call."""
    import torch.nn.functional as F

    Ho = {"none": H, "down": H // 2, "up": 2 * H}[rs]
    cl = dict(memory_format=torch.channels_last)
    bf = torch.bfloat16

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
    return cuda_ms(torch, call), device_ms(torch, call)["total"]


def phase_kernels(torch, dev, shapes, n=N, dtypes=("bfloat16", "float32")):
    """Kernel against plain at every main-path shape ``shapes``:
    (kernel, resample, H, c1, c2, cout) -> calls per evaluation, at batch
    n; returns the per-shape records: CUDA-event ms of back-to-back wrapper
    calls (which measure the host where the kernels take less) and the
    kernels' device ms (profiler), plain ms; for the bf16 blocks also the
    GEMMs' share of the device time, TFLOP/s and share of the bound, and
    cuDNN's convs as a yardstick (conv_library_ms)."""
    from diffpure_tpu_torch.ops import fused_attnblock as fab
    from diffpure_tpu_torch.ops import fused_resblock as frb
    from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups

    records = []
    for i, ((name, rs, H, c1, c2, cout), calls) in enumerate(sorted(shapes.items())):
        if n != N and name == "fused_attnblock":
            continue
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
                dev_ms = device_ms(torch, kern)
                rec = dict(kernel=name, resample=rs, H=H, c1=c1, c2=c2, cout=cout, batch=n,
                           calls_per_eval=calls, dtype=dtype_name, max_abs_err=err,
                           rel_err=err / scale, rel_tol=REL[dtype_name],
                           ms=cuda_ms(torch, kern), device_ms=dev_ms["total"],
                           device_ms_by=dev_ms,
                           plain_ms=cuda_ms(torch, plain, reps=20 if n == N else 5), ok=ok)
                line = ""
                if name != "fused_attnblock" and dtype_name == "bfloat16":
                    flops, nbytes = block_cost(name, rs, H, c1, c2, cout, n, 2)
                    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES
                    lib_ms, lib_dev = conv_yardstick(torch, params, rs, H, cin, cout, n)
                    rec.update(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
                               bound_by="operations" if t_ops >= t_bytes else "bytes",
                               tflops=flops / rec["device_ms"] / 1e9,
                               gemm_tflops=flops / max(dev_ms["gemm"], 1e-9) / 1e9,
                               conv_library_ms=lib_ms, conv_library_device_ms=lib_dev)
                    rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
                    line = (f" ({rec['tflops']:.1f} TFLOP/s, GEMM {rec['gemm_tflops']:.1f}, "
                            f"{rec['bound_share']:.3f} of bound) cuDNN convs {lib_ms:.4f} ms "
                            f"(device {lib_dev:.4f})")
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


def phase_identity_resample(torch, dev, n=N):
    """The resampling blocks with an identity skip (cin == cout, no
    projection), which no NCSN++ census shape has: the skip is then the
    resampled x. One up and one down block of 128 channels at 16x16,
    kernel against plain, bf16 and fp32, at REL."""
    from diffpure_tpu_torch.ops import fused_resblock as frb

    checks = {}
    for i, rs in enumerate(("up", "down")):
        params, x32, temb32, _ = block_inputs(torch, dev, 900 + i, "fused_resblock", "none",
                                              16, 128, 0, 128, n)
        if params[8] is not None:
            raise AssertionError("identity-skip block inputs came with a projection")
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            x, temb = x32.to(dtype), temb32.to(dtype)
            kw = dict(num_groups1=32, num_groups2=32, resample=rs)
            with torch.inference_mode():
                got = frb.fused_resblock(x, temb, params,
                                         packed=frb.pack_resblock_params(params, dtype, dev),
                                         **kw)
                want = frb.fused_resblock_reference(x, temb, params, **kw)
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            ok = bool(torch.isfinite(got.float()).all()) and err <= REL[dtype_name] * scale
            checks[f"{rs}/{dtype_name}"] = dict(max_abs_err=err, rel_err=err / scale,
                                                rel_tol=REL[dtype_name], ok=ok)
            log(f"  fused_resblock     {rs:4s} 16x16 128->128 identity skip b{n} "
                f"{dtype_name:8s} rel err {err / scale:.2e} <= {REL[dtype_name]:.0e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"identity-skip {rs} block {dtype_name}: kernel and "
                                     f"plain disagree")
    return checks


def phase_bwd_kernels(torch, dev, shapes):
    """Each backward kernel against autograd of the plain block on the card,
    at every resblock / concat-resblock shape of ``shapes`` (the inputs of
    phase 2 plus a seeded output cotangent g); returns per-shape records.
    ``plain_gap``: the plain bf16 backward against the plain fp32 one."""
    from diffpure_tpu_torch.ops import fused_resblock as frb
    from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups

    records = []
    for i, ((name, rs, H, c1, c2, cout), calls) in enumerate(sorted(shapes.items())):
        if name == "fused_attnblock":
            continue
        params, x32, temb32, normal = block_inputs(torch, dev, i, name, rs, H, c1, c2, cout)
        Ho = {"none": H, "down": H // 2, "up": 2 * H}[rs]
        g32 = normal(N, Ho, Ho, cout)
        kw = dict(num_groups1=ncsn_num_groups(c1 + c2), num_groups2=ncsn_num_groups(cout))
        wants = {}
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x, temb, g = x32.to(dtype), temb32.to(dtype), g32.to(dtype)
            pk = frb.pack_resblock_params(params, dtype, dev)
            pkb = frb.pack_resblock_bwd_params(params, dtype, dev)
            if name == "fused_resblock_cat":
                x1, x2 = x[..., :c1].contiguous(), x[..., c1:].contiguous()
                kern = lambda: frb.fused_resblock_cat_bwd(  # noqa: E731
                    x1, x2, temb, params, g, packed=pk, packed_bwd=pkb, **kw)
                plain = lambda: frb.fused_resblock_cat_bwd_reference(  # noqa: E731
                    x1, x2, temb, params, g, **kw)
                outs = ("dx1", "dx2", "dtemb")
            else:
                kern = lambda: frb.fused_resblock_bwd(  # noqa: E731
                    x, temb, params, g, resample=rs, packed=pk, packed_bwd=pkb, **kw)
                plain = lambda: frb.fused_resblock_bwd_reference(  # noqa: E731
                    x, temb, params, g, resample=rs, **kw)
                outs = ("dx", "dtemb")
            got = kern()
            torch.cuda.synchronize()
            want = wants[dtype_name] = plain()
            errs = {o: float((a - b).abs().max()) for o, a, b in zip(outs, got, want)}
            rels = {o: errs[o] / float(b.abs().max()) for o, b in zip(outs, want)}
            ok = all(bool(torch.isfinite(a).all()) for a in got) and \
                max(rels.values()) <= BWD_REL[dtype_name]
            rec = dict(kernel=name + "_bwd", resample=rs, H=H, c1=c1, c2=c2, cout=cout,
                       calls_per_eval=calls, dtype=dtype_name, max_abs_err=max(errs.values()),
                       rel_err=rels, rel_tol=BWD_REL[dtype_name],
                       ms=cuda_ms(torch, kern), plain_ms=cuda_ms(torch, plain), ok=ok)
            if dtype_name == "bfloat16":
                rec["plain_gap"] = {o: float((a - b).abs().max() / b.abs().max())
                                    for o, a, b in zip(outs, want, wants["float32"])}
            records.append(rec)
            log(f"  {name + '_bwd':22s} {rs:4s} {H:2d}x{H:<2d} {c1:3d}+{c2:<3d}->{cout:3d} "
                f"{dtype_name:8s} rel err {max(rels.values()):.2e} <= "
                f"{BWD_REL[dtype_name]:.1e} kernel {rec['ms']:.4f} ms plain "
                f"{rec['plain_ms']:.4f} ms {'ok' if ok else 'FAIL'}")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} backward kernel checks failed: {bad}")
    return records


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


def adm_census(torch, adm, x):
    """(kernel wrapper, shape key) -> calls over one ADM evaluation at x's
    batch, recorded at the four wrappers as the model calls them."""
    from collections import Counter
    from diffpure_tpu_torch.ops import flash_attention as fla
    from diffpure_tpu_torch.ops import halo_conv as halo
    from diffpure_tpu_torch.ops import tiled_groupnorm as tgn

    seen = Counter()

    def key(name, a, k):
        if name == "group_stats":
            return a[0].shape[1], a[0].shape[3]
        if name == "gn_film_silu_apply":
            return a[0].shape[1], a[0].shape[3], bool(a[3] if len(a) > 3 else
                                                      k.get("apply_silu", True))
        if name == "gn_silu_conv3x3_halo":
            skip, w_proj = k.get("skip"), k.get("w_proj")
            kind = "none" if skip is None else ("identity" if w_proj is None else "proj")
            return (a[0].shape[1], a[0].shape[3], a[3].shape[3], kind,
                    0 if skip is None else skip.shape[3])
        return tuple(a[0].shape)  # flash_attention: (BH, T, D)

    def recorder(mod, name):
        orig = getattr(mod, name)

        def rec(*a, **k):
            seen[(name, key(name, a, k))] += 1
            return orig(*a, **k)
        rec.launches = 0
        return orig, rec

    patched = [(m, n, *recorder(m, n)) for m, n in (
        (tgn, "group_stats"), (tgn, "gn_film_silu_apply"),
        (halo, "gn_silu_conv3x3_halo"), (fla, "flash_attention"))]
    try:
        for m, n, _, rec in patched:
            setattr(m, n, rec)
        with torch.inference_mode():
            adm(x, torch.full((x.shape[0],), 149, dtype=torch.int32, device=x.device))
    finally:
        for m, n, orig, _ in patched:
            setattr(m, n, orig)
    return dict(seen)


def adm_cost(name, shape, esize):
    """(FLOPs, bytes) one call of an ADM kernel must do and move at batch
    ADM_N: each input read once, each output written once (weights in the
    compute dtype; the affines, biases and stats partials in fp32)."""
    if name == "flash_attention":
        bh, t, d = shape
        return 4 * bh * t * t * d, 4 * bh * t * d * esize
    if name == "gn_silu_conv3x3_halo":
        H, cin, cout, kind, cr = shape
        m = ADM_N * H * H
        k = 9 * cin + (cr if kind == "proj" else 0)
        nbytes = (m * (cin + cout + (cr if kind != "none" else 0)) + k * cout) * esize \
            + (2 * ADM_N * cin + cout) * 4
        return 2 * m * cout * k, nbytes
    H, C = shape[:2]
    elems = ADM_N * H * H * C
    if name == "group_stats":  # sum and sum of squares; (N, tiles, C) partials out
        from diffpure_tpu_torch.ops.tiled_groupnorm import _rows_per_tile
        tiles = -(-H // _rows_per_tile(ADM_N, H, C))
        return 3 * elems, elems * esize + 2 * ADM_N * tiles * C * 4
    return 6 * elems, 2 * elems * esize + 2 * ADM_N * C * 4  # gn_film_silu_apply


def sass_wgmma(torch, lib_path):
    """{kernel function: count of HGMMA (wgmma) instructions} in the built
    library's SASS, by cuobjdump from the toolkit that built it."""
    from diffpure_tpu_torch.ops._cuda import _nvcc

    tool = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


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


def phase_adm_kernels(torch, dev, census):
    """Each 256-px kernel against its plain version on the card at every
    census shape, bf16 and fp32, seeded inputs; per-shape records with
    kernel, plain (and for flash attention the library call's) times and
    the bound."""
    import numpy as np
    from diffpure_tpu_torch.ops import flash_attention as fla
    from diffpure_tpu_torch.ops import halo_conv as halo
    from diffpure_tpu_torch.ops import tiled_groupnorm as tgn

    records = []
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
            x32 = normal(ADM_N, H, H, C, shift=0.2)
            A, B = normal(ADM_N, C, scale=0.3, shift=1.0), normal(ADM_N, C, scale=0.3)
        if name == "group_stats":
            gs, gb = normal(C, scale=0.1, shift=1.0), normal(C, scale=0.1)
            fs, ft = normal(ADM_N, C, scale=0.1), normal(ADM_N, C, scale=0.1)
        if name == "gn_silu_conv3x3_halo":
            _, cin, cout, kind, cr = shape
            w, b = normal(3, 3, cin, cout, fan_in=9 * cin), normal(cout, scale=0.1)
            skip32 = None if kind == "none" else normal(ADM_N, H, H, cr)
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
                check = (lambda: tgn.group_stats_affine(x, gs, gb, 32, 1e-5, fs, ft),
                         lambda: tgn.group_stats_affine_reference(x, gs, gb, 32, 1e-5, fs, ft))
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
            flops, nbytes = adm_cost(name, shape, esize)
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
    return records


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
    families = (("halo conv", "halo_"), ("group stats", "stats_kernel"),
                ("GN apply", "apply_kernel"), ("flash attention", "flash_"),
                ("GN+SiLU (#10)", "gn_silu_kernel"), ("attention block (#3)", "attn_kernel"),
                ("convs and matmuls (cuDNN / cuBLAS)", ("conv", "gemm", "xmma", "cutlass",
                                                         "sm90", "implicit")),
                ("elementwise", "elementwise"), ("reductions", "reduce"))
    by, kernels = {}, []
    for e in prof.key_averages():
        # the kernels' own events (the CPU ops that launched them carry
        # their time again)
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if not str(e.device_type).endswith("CUDA") or dev_us <= 0:
            continue
        kernels.append((e.key, dev_us / 1e3 / evals, e.count // evals))
        fam = next((f for f, keys in families if any(
            k in e.key for k in ((keys,) if isinstance(keys, str) else keys))), "other")
        by[fam] = by.get(fam, 0.0) + dev_us / 1e3 / evals
    busy = sum(by.values())
    kernels.sort(key=lambda r: -r[1])
    return dict(wall_ms_per_eval=wall_ms / evals, device_ms_per_eval=busy,
                idle_share=max(0.0, 1.0 - busy * evals / wall_ms), by_family=by,
                top_kernels=kernels[:25], chain_steps=chain_steps(prof, evals))


# Kernel-name fragments of the CIFAR block chains' launches (#1/#2 and #3):
# the GroupNorm pass, the GEMM (the mma.sync one and the wgmma one), the
# split-K pass, the attention core.
CHAIN_KINDS = (("gn", ("gn_apply_kernel", "rb_gn_kernel")), ("gemm", ("igemm_", "rb_wgmma_kernel")),
               ("splitk", ("splitk_",)), ("attn", ("attn_kernel",)))


def chain_steps(prof, evals):
    """Device ms per evaluation of each step of the NCSN++ block chains, from
    the profiler's kernels in launch order. A block call's launches follow
    each other with no other kernel between: a run of chain kernels splits
    at each GroupNorm pass into segments; a segment with the attention core
    is an attention block (#3); the others alternate GN1 + conv0 and GN2 +
    conv1 (a resblock's chain never shares a run with another resblock: the
    temb row's plain ops come first)."""
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


def host_us_per_call(torch, dev):
    """Host microseconds per resblock call at batch 8, bf16: back-to-back
    calls timed on the host clock up to the last enqueue, once through
    ops/fused_resblock._launch and once through the public wrapper under
    inference_mode; beside them the CUDA-event ms per call (the device
    keeps up with the host where it is below the host's time)."""
    from diffpure_tpu_torch.ops import fused_resblock as frb
    from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups

    out = {}
    for rs, H, c, cout in (("none", 4, 256, 256), ("none", 32, 128, 128)):
        params, x32, temb32, _ = block_inputs(torch, dev, 0, "fused_resblock", rs, H, c, 0, cout)
        x, temb = x32.to(torch.bfloat16), temb32.to(torch.bfloat16)
        g1, g2 = ncsn_num_groups(c), ncsn_num_groups(cout)
        pk = frb.pack_resblock_params(params, torch.bfloat16, dev)
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
    """--profile-cifar: warm evaluations of the full-width NCSN++ (bf16
    torso) at batch 8 and 128 under the profiler (device ms by kernel, the
    block chains' steps, idle share), and the host time per block call."""
    score, _ = build_models(torch, dev, torch.bfloat16)
    res = dict(card=smi)
    for n in (N, CIFAR_BIG_N):
        log(f"== profile: CIFAR NCSN++ evaluations, batch {n}, bf16")
        x, t = torch.randn(n, 32, 32, 3, device=dev), torch.full((n,), 99.9, device=dev)
        prof = profile_eval(torch, score, x, t)
        res[f"batch_{n}"] = prof
        log(f"  wall {prof['wall_ms_per_eval']:.3f} ms, device {prof['device_ms_per_eval']:.3f} "
            f"ms per evaluation, idle share {prof['idle_share']:.3f} on {smi}")
        for step, ms in sorted(prof["chain_steps"].items(), key=lambda kv: -kv[1]):
            log(f"  chain step {step:24s} {ms:8.3f} ms")
        for name, ms, calls in prof["top_kernels"][:12]:
            log(f"  {ms:8.3f} ms x{calls:<4d} {name[:100]}")
    res["host_us"] = host_us_per_call(torch, dev)
    for k, v in res["host_us"].items():
        log(f"  host {k:36s} {v['host_us']:8.1f} us per call (CUDA events "
            f"{v['cuda_event_ms'] * 1e3:8.1f} us)")
    (OUT / "profile_cifar.json").write_text(json.dumps(res, indent=1))


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


def phase_gn_act_kernels(torch, dev, gn_shapes):
    """#10 at every (H, C) of the DDPM census, batch N, and #11 at
    FLR_CASES, each against its plain version on the card, bf16 and fp32;
    per-shape records with kernel, plain and bound times. Both compute in
    fp32 (FMA units) whatever the dtype; #10 does ~10 operations per
    element (sum, squared deviation, normalise, affine, SiLU), #11 3."""
    import numpy as np
    from diffpure_tpu_torch.ops import fused_act, groupnorm

    cases = [("group_norm_silu_fused", (N, H, H, C), True, calls)
             for (H, C), calls in sorted(gn_shapes.items())]
    cases += [("fused_leaky_relu", shape, bias, 0) for shape, bias in FLR_CASES]
    records = []
    for i, (name, shape, with_bias, calls) in enumerate(cases):
        rng = np.random.default_rng(3000 + i)
        C = shape[-1]
        x32 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 2 + 0.5).to(dev)
        s = torch.from_numpy(1 + 0.1 * rng.standard_normal(C).astype(np.float32)).to(dev)
        b = torch.from_numpy(0.1 * rng.standard_normal(C).astype(np.float32)).to(dev)
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            esize = 2 if dtype_name == "bfloat16" else 4
            x = x32.to(dtype)
            elems = x.numel()
            if name == "group_norm_silu_fused":
                kern = lambda: groupnorm.group_norm_silu_fused(x, s, b, 32, 1e-6)  # noqa: E731
                plain = lambda: groupnorm.group_norm_silu_fused_reference(  # noqa: E731
                    x, s, b, 32, 1e-6)
                flops, nbytes = 10 * elems, 2 * elems * esize + 2 * C * 4
            else:
                bias = b.to(dtype) if with_bias else None
                kern = lambda: fused_act.fused_leaky_relu(x, bias)  # noqa: E731
                plain = lambda: fused_act.fused_leaky_relu_reference(x, bias)  # noqa: E731
                flops = 3 * elems
                nbytes = 2 * elems * esize + (C * esize if with_bias else 0)
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            ok = bool(torch.isfinite(got.float()).all()) and got.dtype == dtype \
                and err <= REL[dtype_name] * scale
            t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES
            rec = dict(kernel=name, shape=list(shape), bias=with_bias, calls_per_eval=calls,
                       dtype=dtype_name, max_abs_err=err, rel_err=err / scale,
                       rel_tol=REL[dtype_name], ms=cuda_ms(torch, kern, 50, 5),
                       plain_ms=cuda_ms(torch, plain, 50, 5), library_ms=None, flops=flops,
                       bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes", ok=ok)
            records.append(rec)
            log(f"  {name:21s} {str(shape):18s} {'' if with_bias else 'no bias ':8s}"
                f"x{calls:<2d} {dtype_name:8s} rel err {err / scale:.2e} <= "
                f"{REL[dtype_name]:.0e} kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} "
                f"ms bound {rec['bound_ms']:.4f} ms {'ok' if ok else 'FAIL'}")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} GroupNorm+SiLU / leaky ReLU checks failed: {bad}")
    return records


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
                         "and 128, bf16; the block chains' steps) and the host time per "
                         "block call, and end (no result line)")
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
    wgmma = sass_wgmma(torch, _cuda.build())
    for fn, n in sorted(wgmma.items()):
        if any(k in fn for k in ("halo", "flash", "rb_wgmma")):
            log(f"  SASS: {n:5d} HGMMA in {fn}")
    no_wgmma = [k for k in WGMMA_KERNELS if not any(k in fn and n for fn, n in wgmma.items())]
    if no_wgmma:
        raise AssertionError(f"no wgmma (HGMMA) in the SASS of {no_wgmma}")
    phase_done("1")
    if args.profile_cifar:
        profile_cifar(torch, dev, smi)
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

    # ---- phase 2 ------------------------------------------------------------
    log("== phase 2: kernel against plain at the main-path shapes, batch 8")
    score, clf = build_models(torch, dev, torch.bfloat16)
    rng = np.random.default_rng(SEED + 2)
    x01 = torch.from_numpy(rng.uniform(size=(N, 32, 32, 3)).astype(np.float32)).to(dev)
    shapes = shape_census(torch, score, x01 * 2 - 1)
    per_eval = {k: sum(c for s, c in shapes.items() if s[0] == k) for k in KERNELS}
    if per_eval != {k: v[2] for k, v in KERNELS.items()}:
        raise AssertionError(f"block calls per evaluation {per_eval}")
    records = phase_kernels(torch, dev, shapes)
    log(f"== phase 2 at batch {CIFAR_BIG_N} (bench.py's CIFAR batch), bf16 blocks")
    big_records = phase_kernels(torch, dev, shapes, n=CIFAR_BIG_N, dtypes=("bfloat16",))
    log("== phase 2, up and down blocks with an identity skip (off the census)")
    identity_checks = phase_identity_resample(torch, dev)
    phase_done("2")
    zero_bwd = {k: 0 for k in BWD_KERNELS}
    zero_adm = {k: 0 for k in ADM_KERNELS}
    zero_ddpm = {k: 0 for k in DDPM_KERNELS}

    # ---- phase 2b -----------------------------------------------------------
    log("== phase 2b: backward kernel against plain at the main-path shapes, batch 8")
    bwd_records = phase_bwd_kernels(torch, dev, shapes)
    phase_done("2b")
    (OUT / "result.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
        wgmma=wgmma, shapes=records, big_shapes=big_records, identity_checks=identity_checks,
        bwd_shapes=bwd_records, phase_s=phase_s), indent=1))
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
    phase_done("2c")
    (OUT / "result.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
        wgmma=wgmma, shapes=records, bwd_shapes=bwd_records, adm_shapes=adm_records,
        adm_per_eval=adm_per_eval, phase_s=phase_s), indent=1))
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
            shapes=records, bwd_shapes=bwd_records, adm_shapes=adm_records,
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
        t0 = time.time()
        with torch.inference_mode():
            acc = get_accuracy(model_fn, x128, y128, seed=SEED + 8, bs=CIFAR_BIG_N)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        big_runs.append(dict(run=run, wall_s=wall, images_per_s=CIFAR_BIG_N / wall,
                             counts=counts, peak_gib=peak))
        log(f"  {run}: {wall:.3f} s, {CIFAR_BIG_N / wall:.3f} images/s on {smi}, accuracy "
            f"{acc:.3f} (random weights); peak device memory {peak:.2f} GiB; launches {counts}")
        if counts != want:  # one defended call of 100 evaluations: as phase 3's
            raise AssertionError(f"launch counts {counts} != {want}")
    out = logits[-1]
    if tuple(out.shape) != (CIFAR_BIG_N, 10) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad logits: shape {tuple(out.shape)}")
    phase_done("3b")

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
    grad_checks, plain = {}, {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        score.dtype = dtype
        dms = {m: DefendedModel(score, clf, PurifyConfig(t=5, grad_mode=m), log_every=0)
               for m in GRAD_MODES}
        got = {m: purify_grad(torch, dms[m], x6, w6, FixedNoise(SEED + 6)).cpu()
               for m in GRAD_MODES}
        score.cpu()
        for m in GRAD_MODES:
            plain[dtype_name, m] = purify_grad(torch, dms[m], x6.cpu(), w6,
                                               FixedNoise(SEED + 6))
        score.to(dev)
        for m in GRAD_MODES:
            want = plain[dtype_name, m]
            err, scale = float((got[m] - want).abs().max()), float(want.abs().max())
            ok = bool(torch.isfinite(got[m]).all()) and err <= GRAD_REL[dtype_name] * scale
            rec = dict(max_abs_err=err, rel_err=err / scale, rel_tol=GRAD_REL[dtype_name], ok=ok)
            if dtype_name == "bfloat16":  # the plain bf16 gradient against the plain fp32 one
                ref = plain["float32", m]
                rec["plain_gap"] = float((want - ref).abs().max() / ref.abs().max())
            grad_checks[f"{dtype_name}/{m}"] = rec
            log(f"  {dtype_name:8s} {m:10s}: max |kernel - plain| {err:.3e} (rel "
                f"{err / scale:.2e} <= {GRAD_REL[dtype_name]:.1e}) "
                f"{'ok' if ok else 'FAIL'}" + (f"; plain bf16 vs fp32 {rec['plain_gap']:.2e}"
                                               if "plain_gap" in rec else ""))
            if not ok:
                raise AssertionError(f"gradient {dtype_name}/{m}: kernel and plain disagree")
    score.dtype = torch.bfloat16
    phase_done("6")

    # ---- phase 7 ------------------------------------------------------------
    # The labels are the defence's own prediction under the noise the
    # defended suite's first (clean) evaluation draws, so every example
    # starts robust and APGD runs through the defence on all of them.
    log("== phase 7: eval_autoattack, version 'rand' (eot_iter=2, n_iter=2), t*=100, "
        "bf16, batch 8, grad_mode 'checkpoint'")
    dm7 = DefendedModel(score, clf, PurifyConfig(t=EVALS, grad_mode="checkpoint"), log_every=0)
    aa_cfg = AutoAttackConfig(version="rand", eot_iter=2, n_iter=2)
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
    phase_done("7")

    # ---- phase 8 ------------------------------------------------------------
    log(f"== phase 8: ImageNet DefendedModel(resize_to=256), guided-diffusion t*={ADM_EVALS}, "
        f"bf16 ADM + ResNet-50, batch {ADM_N}")
    from diffpure_tpu_torch.classifiers import get_classifier
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
    rn50 = get_classifier("imagenet-resnet50").eval()
    rn50.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                          seeded_normal_state_dict(rn50, SEED + 11).items()})
    rn50.requires_grad_(False).to(dev)
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
        "kernels (GPU) against plain (CPU)")
    x9 = torch.from_numpy(rng.standard_normal((1, 256, 256, 3)).astype(np.float32) * 0.5)
    t9 = torch.tensor([149], dtype=torch.int32)
    x9p = torch.from_numpy(rng.uniform(size=(1, 256, 256, 3)).astype(np.float32))
    cfg9 = PurifyConfig(t=3, **guided)
    dtypes9 = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    card9, cpu9 = {}, {}
    for where, out9, device in (("card", card9, dev), ("cpu", cpu9, torch.device("cpu"))):
        if where == "cpu":
            adm.cpu()
        t0 = time.time()
        with torch.inference_mode():
            for dtype_name, dtype in dtypes9:
                adm.dtype = dtype
                out9[dtype_name] = adm(x9.to(device), t9.to(device)).float().cpu()
            adm.dtype = torch.float32
            out9["purify"] = DefendedModel(adm, rn50, cfg9, log_every=0).purify(
                x9p.to(device), FixedNoise(SEED + 13)).cpu()
        log(f"  {where}: {time.time() - t0:.1f} s")
    adm_checks = {}
    for what, bound in (("float32", ADM_EVAL_REL["float32"]),
                        ("bfloat16", ADM_EVAL_REL["bfloat16"]), ("purify", ADM_PURIFY_REL)):
        got, want = card9[what], cpu9[what]
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= bound * scale
        adm_checks[what] = dict(max_abs_err=err, rel_err=err / scale, rel_tol=bound, ok=ok)
        log(f"  {what:8s}: max |card - cpu| {err:.3e} (rel {err / scale:.2e} <= {bound:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
    # how far each side's bf16 evaluation lies from the CPU's fp32 one
    for where, out9 in (("card", card9), ("cpu", cpu9)):
        gap = float((out9["bfloat16"] - cpu9["float32"]).abs().max()
                    / cpu9["float32"].abs().max())
        adm_checks[f"{where}_bf16_vs_cpu_fp32"] = gap
        log(f"  {where} bf16 against CPU fp32: rel {gap:.2e}")
    bad = [k for k, v in adm_checks.items() if isinstance(v, dict) and not v["ok"]]
    if bad:
        raise AssertionError(f"ImageNet card against CPU: {bad} disagree")
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
            # no single PyTorch call computes any of these blocks
            library_ms=None))
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
        # its shapes
        mine = [r for r in gn_act_records if r["kernel"] == name and r["dtype"] == "float32"]
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
        wgmma=wgmma, shapes=records, big_shapes=big_records, identity_checks=identity_checks,
        bwd_shapes=bwd_records, slice_runs=runs, big_runs=big_runs, slice_checks=slice_checks,
        grad_runs=grad_runs, grad_checks=grad_checks,
        attack=dict(seconds=attack_s, counts=attack_counts, classifier_robust_acc=accs[0],
                    defended_robust_acc=accs[1], max_dist=dist),
        adm_shapes=adm_records, adm_per_eval=adm_per_eval, adm_runs=adm_runs,
        adm_checks=adm_checks, gn_act_shapes=gn_act_records, ddpm_census=ddpm_shapes,
        ddpm_runs=ddpm_runs, ddpm_checks=ddpm_checks, phase_s=phase_s, kernels=kernels),
        indent=1))
    log(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
