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
     take them), with the same noise; the purified images must agree.

Needs the CUDA toolkit (nvcc) and one card; exits non-zero without them.
Writes details (per-shape records, the compiler's report) to
chip_smoke_out/. The second-to-last line of stdout is the kernels' JSON
record, the last the device JSON.
"""
from __future__ import annotations

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


def phase_kernels(torch, dev, shapes):
    """Kernel against plain at every main-path shape ``shapes``:
    (kernel, resample, H, c1, c2, cout) -> calls per evaluation; returns the
    per-shape records."""
    import numpy as np
    from diffpure_tpu_torch.ops import fused_attnblock as fab
    from diffpure_tpu_torch.ops import fused_resblock as frb
    from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups

    def normal(rng, *shape, fan_in=None, scale=1.0, shift=0.0):
        a = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
        if fan_in:
            a /= np.float32(np.sqrt(fan_in))
        return torch.from_numpy(a + np.float32(shift)).to(dev)

    records = []
    for i, ((name, rs, H, c1, c2, cout), calls) in enumerate(sorted(shapes.items())):
        rng = np.random.default_rng(1000 + i)
        cin = c1 + c2
        if name == "fused_attnblock":
            params = [normal(rng, cin, scale=0.1, shift=1.0), normal(rng, cin, scale=0.1)]
            for _ in range(4):
                params += [normal(rng, cin, cin, fan_in=cin), normal(rng, cin, scale=0.1)]
        else:
            proj = cin != cout or rs != "none"
            params = [normal(rng, cin, scale=0.1, shift=1.0), normal(rng, cin, scale=0.1),
                      normal(rng, cout, cin, 3, 3, fan_in=9 * cin), normal(rng, cout, scale=0.1),
                      normal(rng, cout, scale=0.1, shift=1.0), normal(rng, cout, scale=0.1),
                      normal(rng, cout, cout, 3, 3, fan_in=9 * cout), normal(rng, cout, scale=0.1),
                      normal(rng, cout, cin, fan_in=cin) if proj else None,
                      normal(rng, cout, scale=0.1) if proj else None]
        params = tuple(params)
        x32 = normal(rng, N, H, H, cin)
        temb32 = normal(rng, N, cout, scale=0.3)
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
    import torch

    if not (REPO / "diffpure_tpu_torch" / "csrc").is_dir():
        log("chip_smoke.py must run from a checkout of the repository")
        return 2
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    from diffpure_tpu_torch.eval import DefendedModel, get_accuracy
    from diffpure_tpu_torch.ops import _cuda, launch_counts, reset_launch_counts
    from diffpure_tpu_torch.purify import PurifyConfig

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
        want = {k: v[2] * EVALS for k, v in KERNELS.items()}
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want}")
    out = logits[-1]
    if tuple(out.shape) != (N, 10) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad logits: shape {tuple(out.shape)}")
    main_counts = runs[0]["counts"]
    log(f"slice (warm run): {runs[1]['images_per_s']:.3f} images/s on {smi}")

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

    # ---- report -------------------------------------------------------------
    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        mine = [r for r in records if r["kernel"] == name and r["dtype"] == "bfloat16"]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_counts[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            # per score evaluation: the kernel's calls at each shape, bf16, batch 8
            ms=sum(r["ms"] * r["calls_per_eval"] for r in mine),
            plain_ms=sum(r["plain_ms"] * r["calls_per_eval"] for r in mine)))
    (OUT / "result.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
        shapes=records, slice_runs=runs, slice_checks=slice_checks, kernels=kernels),
        indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
