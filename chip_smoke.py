#!/usr/bin/env python3
"""Drive the PyTorch port's CIFAR-10 defence once on one NVIDIA GPU.

    python3 chip_smoke.py          (from the root of the repository)

Phases, each fatal on failure:
  1. versions, the card's name and power limit, and the build of the CUDA
     kernels from diffpure_tpu_torch/csrc (timed);
  2. each hand-written kernel against its plain PyTorch version on the card,
     at every shape the CIFAR-10 NCSN++ gives it, batch 8, bf16 and fp32,
     with seeded random-normal weights; kernel and plain times per shape;
  3. the slice: DefendedModel (full-width configs/cifar10.yml NCSN++ with a
     bf16 torso + WRN-28-10, seeded random weights) on 8 seeded images at
     t*=100 through get_accuracy under inference_mode; the kernel launch
     counters must read exactly 40, 36 and 10 per score evaluation;
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

Needs the CUDA toolkit (nvcc) and one card; exits non-zero without them.
Writes details (per-shape records, the compiler's report) to
chip_smoke_out/. The second-to-last line of stdout is the kernels' JSON
record, the last the device JSON. ``--stop-after 2b`` ends after phase 2b
(a short first run of changed kernels; prints no result line).
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


def block_inputs(torch, dev, i, name, rs, H, c1, c2, cout):
    """Seeded random-normal block weights and fp32 inputs (x, temb) for the
    i-th shape of the census, on dev."""
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
    return tuple(params), normal(N, H, H, cin), normal(N, cout, scale=0.3), normal


def phase_kernels(torch, dev, shapes):
    """Kernel against plain at every main-path shape ``shapes``:
    (kernel, resample, H, c1, c2, cout) -> calls per evaluation; returns the
    per-shape records."""
    from diffpure_tpu_torch.ops import fused_attnblock as fab
    from diffpure_tpu_torch.ops import fused_resblock as frb
    from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups

    records = []
    for i, ((name, rs, H, c1, c2, cout), calls) in enumerate(sorted(shapes.items())):
        params, x32, temb32, _ = block_inputs(torch, dev, i, name, rs, H, c1, c2, cout)
        cin = c1 + c2
        g1, g2 = ncsn_num_groups(cin), ncsn_num_groups(cout)
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
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
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            ok = bool(torch.isfinite(got.float()).all()) and err <= REL[dtype_name] * scale
            rec = dict(kernel=name, resample=rs, H=H, c1=c1, c2=c2, cout=cout,
                       calls_per_eval=calls, dtype=dtype_name, max_abs_err=err,
                       rel_err=err / scale, rel_tol=REL[dtype_name],
                       ms=cuda_ms(torch, kern), plain_ms=cuda_ms(torch, plain), ok=ok)
            records.append(rec)
            log(f"  {name:18s} {rs:4s} {H:2d}x{H:<2d} {c1:3d}+{c2:<3d}->{cout:3d} "
                f"{dtype_name:8s} err {err:.3e} (rel {err / scale:.2e} <= "
                f"{REL[dtype_name]:.0e}) kernel {rec['ms']:.4f} ms plain "
                f"{rec['plain_ms']:.4f} ms {'ok' if ok else 'FAIL'}")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel checks failed: {bad}")
    return records


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
    ap.add_argument("--stop-after", choices=("2b",), default=None,
                    help="end after this phase (no result line)")
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
    phase_done("1")

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
    phase_done("2")

    # ---- phase 2b -----------------------------------------------------------
    log("== phase 2b: backward kernel against plain at the main-path shapes, batch 8")
    bwd_records = phase_bwd_kernels(torch, dev, shapes)
    phase_done("2b")
    (OUT / "result.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
        shapes=records, bwd_shapes=bwd_records, phase_s=phase_s), indent=1))
    if args.stop_after == "2b":
        log("stopped after phase 2b as asked (partial run)")
        return 3
    zero_bwd = {k: 0 for k in BWD_KERNELS}

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
        want = {**{k: v[2] * EVALS for k, v in KERNELS.items()}, **zero_bwd}
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want}")
    out = logits[-1]
    if tuple(out.shape) != (N, 10) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad logits: shape {tuple(out.shape)}")
    main_counts = runs[0]["counts"]
    log(f"slice (warm run): {runs[1]['images_per_s']:.3f} images/s on {smi}")
    phase_done("3")

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
                **{k: KERNELS[v[2]][2] * EVALS * bwd for k, v in BWD_KERNELS.items()}}
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
    idle = [k for k, v in attack_counts.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels of the attack path never launched: {idle}")
    phase_done("7")

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
    (OUT / "result.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
        shapes=records, bwd_shapes=bwd_records, slice_runs=runs, slice_checks=slice_checks,
        grad_runs=grad_runs, grad_checks=grad_checks,
        attack=dict(seconds=attack_s, counts=attack_counts, classifier_robust_acc=accs[0],
                    defended_robust_acc=accs[1], max_dist=dist),
        phase_s=phase_s, kernels=kernels), indent=1))
    log(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
