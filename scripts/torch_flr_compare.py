#!/usr/bin/env python3
"""Kernel #11 (fused bias + leaky ReLU, csrc/fused_act.cu) of two trees of
the repository on one card, in turns: parent, change, change, parent.

    python3 scripts/torch_flr_compare.py --parent DIR [--out DIR]

from the root of the changed tree, with DIR a checkout of the parent
commit (e.g. unpacked by `git archive` into a git-ignored directory). Each
turn is a process of its own, run from its tree's root, so that it imports
that tree's package; it builds that tree's csrc/fused_act.cu alone (nvcc,
the tree's flags, seconds) and binds it in place of the whole library.
Every turn runs this tree's chip_smoke.flr_records, which needs one NVIDIA
GPU: #11 against its plain version at chip_smoke's FLR_CASES and
FLR_LARGE, bf16 and fp32, with and without a bias; CUDA-event ms, device
ms back to back and, past L2, in steady state over rotating copies, the
bound and its share, the yardstick F.leaky_relu(x + b) * scale, the
1-element launch floor; the change's turns run chip_smoke.phase_flr_kernels,
which adds the plan's route and the gradient on the card. Each turn
prints its lines and writes OUT/flr_compare_<turn>.json; the last line is
a summary of all four.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
TURNS = ("parent1", "change1", "change2", "parent2")


def load_chip_smoke():
    """This tree's chip_smoke.py, whatever tree's package is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke_flr", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Partial:
    """A library that holds only some of the symbols the tree's ``_bind``
    types: the others bind to a placeholder and are never called."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return types.SimpleNamespace()


def bind_fused_act_only(tag: str, out: Path):
    """Build the tree's csrc/fused_act.cu alone and make it the tree's
    kernel library; returns the compiler's report."""
    from diffpure_tpu_torch.ops import _cuda

    lib_path = out / f"flr_{tag}.so"
    res = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                          str(_cuda.CSRC / "fused_act.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tag}'s fused_act.cu:\n{res.stdout}{res.stderr}")
    _cuda._lib = _cuda._bind(_Partial(ctypes.CDLL(str(lib_path))))
    return res.stdout + res.stderr


def one_turn(tag: str, out: Path) -> None:
    sys.path.insert(0, str(Path.cwd()))
    cs = load_chip_smoke()
    import torch
    from diffpure_tpu_torch.ops import fused_act

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script needs an NVIDIA GPU")
    report = bind_fused_act_only(tag, out)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(tag, smi, flush=True)
    print("\n".join(line for line in report.splitlines() if "flr" in line or "Used" in line
                    or "spill" in line), flush=True)
    t0 = time.time()
    run = cs.flr_records if tag.startswith("parent") else cs.phase_flr_kernels
    records = run(torch, dev, fused_act)
    (out / f"flr_compare_{tag}.json").write_text(json.dumps(dict(
        tag=tag, card=smi, tree=str(Path.cwd()), seconds=time.time() - t0, ptxas=report,
        records=records), indent=1, default=str))


def summary(out: Path) -> dict:
    """Per turn: the six FLR_CASES' summed device time (back to back) and,
    per dtype, the steady device time past L2 and share of the bound at
    each FLR_LARGE shape with a bias, beside the yardstick's and a copy's,
    and the launch floor."""
    res = {}
    for tag in TURNS:
        path = out / f"flr_compare_{tag}.json"
        if not path.exists():
            res[tag] = None
            continue
        recs = json.loads(path.read_text())["records"]
        shapes = [r for r in recs if r["kernel"] == "fused_leaky_relu"]
        floor = next(r for r in recs if r["kernel"] == "fused_leaky_relu_floor")
        turn = dict(floor_device_us=floor["device_ms"] * 1e3)
        for dt in ("bfloat16", "float32"):
            mine = [r for r in shapes if r["dtype"] == dt]
            turn[f"toy_device_us_{dt}"] = sum(r["device_ms"] for r in mine if r["toy"]) * 1e3
            turn[f"large_{dt}"] = {str(tuple(r["shape"])): dict(
                steady_us=r["steady_device_ms"] * 1e3, share=r["share"],
                yardstick_steady_us=r["yardstick_steady_device_ms"] * 1e3,
                copy_steady_us=r["copy_steady_device_ms"] * 1e3)
                for r in mine if r["large"] and r["bias"]}
        res[tag] = turn
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the parent tree (runs the four turns)")
    ap.add_argument("--turn", choices=TURNS, help="one turn, in the current directory")
    ap.add_argument("--out", default=str(HERE / "chip_smoke_out" / "flr_compare"))
    args = ap.parse_args()
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    if args.turn:
        one_turn(args.turn, out)
        return 0
    if not args.parent:
        ap.error("give --parent DIR (or --turn)")
    rc = 0
    for tag in TURNS:
        root = Path(args.parent).resolve() if tag.startswith("parent") else HERE
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", tag,
                              "--out", str(out)], cwd=root)
        rc = rc or res.returncode
    print(json.dumps(summary(out)))
    return rc


if __name__ == "__main__":
    sys.exit(main())
