#!/usr/bin/env python3
"""The fp32 CIFAR readings of the port (diffpure_tpu_torch), for two trees
of the repository on one card, in turns: parent, change, change, parent.

    python3 scripts/torch_f32_compare.py --parent DIR [--out DIR]

from the root of the changed tree, with DIR a checkout of the parent
commit (e.g. unpacked by `git archive` into a git-ignored directory). Each
turn is a process of its own, run from its tree's root, so that it
imports that tree's package and builds that tree's kernels; every turn
uses this tree's chip_smoke.py for the phases, which needs one NVIDIA GPU.
A turn reads, in fp32 (every CIFAR run script's precision):
  - kernels #1 and #2 against their plain versions at every NCSN++ census
    shape, batch 8 (chip_smoke.phase_kernels: device ms by chain step) and
    batch 64 (phase_f32_blocks), with cuDNN's convs as a yardstick;
  - kernels #4 and #5 (the backward) against autograd of the plain block
    at every census shape, batch 8, 16 and 64 (phase_bwd_kernels, each
    batch's device ms by chain step from one profiler session), with
    cuDNN's four products as a yardstick;
  - the whole NCSN++ evaluation at batch 8 and 64 under the profiler
    (device ms, idle share, the block chains' steps);
  - the defended call at batch 64 (phase 3c) and at batch 8, cold and warm;
  - the checkpoint input gradient at batch 16 (phase 5's fp32 leg), and a
    warm gradient of GRAD_PROFILE_T steps at batch 16 and 64 (wall and
    device ms per step, idle share: grad_step_profile);
  - the host microseconds per block call and per backward call;
and in bf16, beside them: #4 / #5 at batch 8 and 16 and the gradient step
at batch 16 (grad_step_profile).
Each turn prints its lines and writes OUT/f32_compare_<turn>.json. The
parent's turns accept the old chains' kernels (OLD_F32_FWD_KERNELS and
OLD_F32_BWD_KERNELS are emptied for them).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
TURNS = ("parent1", "change1", "change2", "parent2")


def load_chip_smoke():
    """This tree's chip_smoke.py, whatever tree's package is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke_f32", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_eval(records, kernel, fields):
    rs = [r for r in records if r["kernel"] == kernel]
    return {f: sum(r[f] * r["calls_per_eval"] for r in rs) for f in fields}


def one_turn(tag: str, out: Path) -> None:
    sys.path.insert(0, str(Path.cwd()))
    cs = load_chip_smoke()
    if tag.startswith("parent"):
        cs.OLD_F32_FWD_KERNELS = cs.OLD_F32_BWD_KERNELS = ()
    import numpy as np
    import torch
    from diffpure_tpu_torch.eval import DefendedModel, get_accuracy
    from diffpure_tpu_torch.ops import _cuda
    from diffpure_tpu_torch.purify import PurifyConfig

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.lib()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(tag, smi, flush=True)
    res = dict(tag=tag, card=smi, tree=str(Path.cwd()))
    res["host_us"] = cs.host_us_per_call(torch, dev, torch.float32)
    res["host_us_bwd"] = cs.host_us_bwd(torch, dev, torch.float32)
    for k, v in {**res["host_us"], **res["host_us_bwd"]}.items():
        print(tag, "fp32 host", k, f"{v['host_us']:.1f} us per call (CUDA events "
              f"{v['cuda_event_ms'] * 1e3:.1f} us)", flush=True)

    score, clf = cs.build_models(torch, dev, torch.bfloat16)
    rng = np.random.default_rng(cs.SEED + 2)
    x01 = torch.from_numpy(rng.uniform(size=(cs.N, 32, 32, 3)).astype(np.float32)).to(dev)
    shapes = cs.shape_census(torch, score, x01 * 2 - 1)
    blocks = {k: v for k, v in shapes.items() if k[0] != "fused_attnblock"}
    r8 = cs.phase_kernels(torch, dev, blocks, dtypes=("float32",))
    r64 = cs.phase_f32_blocks(torch, dev, shapes)
    fields = ("device_ms", "ms", "bound_ms", "plain_ms", "conv_library_ms")
    res["per_eval"] = {}
    for n, rs in ((cs.N, r8), (cs.F32_BIG_N, r64)):
        for k in ("fused_resblock", "fused_resblock_cat"):
            v = per_eval(rs, k, fields)
            if n == cs.N:
                for step in ("gemm", "gn", "splitk"):
                    v[step] = sum(r["device_ms_by"][step] * r["calls_per_eval"]
                                  for r in rs if r["kernel"] == k)
            res["per_eval"][f"{k} batch {n}"] = v
            print(tag, k, "batch", n, {f: round(x, 3) for f, x in v.items()}, flush=True)
    bwd = {}
    for n, dtype in ((cs.N, "float32"), (cs.GRAD_N, "float32"), (cs.F32_BIG_N, "float32"),
                     (cs.N, "bfloat16"), (cs.GRAD_N, "bfloat16")):
        rs = bwd[f"{dtype} batch {n}"] = cs.phase_bwd_kernels(
            torch, dev, blocks, n=n, dtypes=(dtype,), plain_timing=False, one_session=True)
        for k in ("fused_resblock_bwd", "fused_resblock_cat_bwd"):
            v = per_eval(rs, k, ("device_ms", "ms", "bound_ms", "conv_library_ms"))
            for step in cs.BWD_GEMMS + cs.BWD_GNS + ("GN1 recompute", "split-K passes"):
                v[step] = sum(r["device_steps"].get(step, 0.0) * r["calls_per_eval"]
                              for r in rs if r["kernel"] == k)
            res["per_eval"][f"{k} {dtype} batch {n}"] = v
            print(tag, k, dtype, "batch", n, {f: round(x, 3) for f, x in v.items()}, flush=True)

    score.dtype = torch.float32
    res["profile"] = {}
    for n in (cs.N, cs.F32_BIG_N):
        prof = cs.profile_eval(torch, score, torch.randn(n, 32, 32, 3, device=dev),
                               torch.full((n,), 99.9, device=dev))
        res["profile"][n] = {k: prof[k] for k in ("wall_ms_per_eval", "device_ms_per_eval",
                                                  "idle_share", "chain_steps")}
        print(tag, "fp32 evaluation, batch", n, {k: round(v, 3) for k, v in prof.items()
                                                 if k in ("wall_ms_per_eval",
                                                          "device_ms_per_eval", "idle_share")},
              {k: round(v, 3) for k, v in prof["chain_steps"].items()}, flush=True)
    dm = DefendedModel(score, clf, PurifyConfig(t=cs.EVALS, grad_mode="none"), log_every=0)
    x8 = torch.from_numpy(rng.uniform(size=(cs.N, 32, 32, 3)).astype(np.float32)).to(dev)
    y8 = torch.from_numpy(rng.integers(0, 10, cs.N)).to(dev)
    res["defended_8"] = []
    for run in ("cold", "warm", "warm"):
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            get_accuracy(dm, x8, y8, seed=cs.SEED + 8, bs=cs.N)
        torch.cuda.synchronize()
        wall = time.time() - t0
        res["defended_8"].append(dict(run=run, wall_s=wall, images_per_s=cs.N / wall))
        print(tag, f"fp32 defended call, batch {cs.N}, {run}: {wall:.3f} s, "
              f"{cs.N / wall:.3f} images/s", flush=True)
    score.dtype = torch.bfloat16
    res["defended_64"] = cs.phase_f32_defended(torch, dev, score, clf, rng, smi,
                                               cs.expected_counts(cs.EVALS))
    for m in (score, clf):
        m.requires_grad_(False)
    xg = torch.from_numpy(rng.uniform(size=(cs.GRAD_N, 32, 32, 3)).astype(np.float32)).to(dev)
    yg = torch.from_numpy(rng.integers(0, 10, cs.GRAD_N)).to(dev)
    res["grad_16"] = cs.phase_f32_grad(torch, score, clf, xg, yg, smi)
    res["grad_steps"] = {}
    for dtype, n in ((torch.float32, cs.GRAD_N), (torch.float32, cs.F32_BIG_N),
                     (torch.bfloat16, cs.GRAD_N)):
        score.dtype = dtype
        x = torch.from_numpy(rng.uniform(size=(n, 32, 32, 3)).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.integers(0, 10, n)).to(dev)
        step = cs.grad_step_profile(torch, dev, score, clf, x, y)
        key = f"{str(dtype)[6:]} batch {n}"
        res["grad_steps"][key] = {k: v for k, v in step.items() if k != "top_kernels"}
        print(tag, f"{cs.GRAD_PROFILE_T}-step checkpoint gradient, {key}:",
              {k: v if v is None else round(v, 3) for k, v in res["grad_steps"][key].items()},
              flush=True)
    score.dtype = torch.bfloat16
    res["records"] = dict(batch_8=r8, batch_64=r64, bwd=bwd)
    (out / f"f32_compare_{tag}.json").write_text(json.dumps(res, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the parent tree (runs the four turns)")
    ap.add_argument("--turn", choices=TURNS, help="run one turn from the current directory")
    ap.add_argument("--out", default=str(HERE / "chiprun_out"))
    args = ap.parse_args()
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    if args.turn:
        one_turn(args.turn, out)
        return 0
    if not args.parent:
        ap.error("give --parent DIR (or --turn)")
    for turn in TURNS:
        cwd = Path(args.parent).resolve() if turn.startswith("parent") else HERE
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", turn,
                             "--out", str(out)], cwd=cwd).returncode
        if rc:
            print(f"turn {turn} failed with {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
