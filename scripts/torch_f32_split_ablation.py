#!/usr/bin/env python3
"""The fp32 block GEMM alone (csrc/resblock_f32.cu's diffpure_f32conv, the
3x3 SAME conv every product of the fp32 block backward but the skip adjoint
runs as) at the backward's GEMM shapes over the full-width CIFAR NCSN++'s
census, batch 8 and 16: the split of K that ops/fused_resblock's plan picks
(_f32_conv) against every other split for both thread tiles, device time by
the profiler, all in one profiler session per batch.

    python3 scripts/torch_f32_split_ablation.py [--out DIR]

from the root of the repository, on a machine with one NVIDIA GPU and nvcc.
Prints per shape the plan's and the best (thread tile, splits x steps) and
the sums per evaluation's backward; writes DIR/f32_split_ablation.json.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

# (Ho, C, nout) -> calls per evaluation's backward of the 3x3 GEMMs (conv0's
# recompute, conv1^T, conv0^T): the census's 76 block calls make 228 of
# them at 20 shapes; these 14, with 3 calls or more each, hold 222
SHAPES = {(4, 256, 256): 42, (4, 256, 512): 9, (4, 512, 256): 9, (8, 256, 256): 39,
          (8, 256, 512): 9, (8, 512, 256): 9, (16, 128, 128): 3, (16, 256, 256): 34,
          (16, 256, 512): 8, (16, 512, 256): 8, (32, 128, 128): 33, (32, 128, 256): 8,
          (32, 256, 128): 8, (32, 256, 256): 3}
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 36, 48, 72)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(HERE / "chiprun_out"))
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from diffpure_tpu_torch.ops import _cuda
    from diffpure_tpu_torch.ops import fused_resblock as frb

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _cuda.lib()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    wse = _cuda.SPLITK_WORKSPACE
    ws = torch.empty(wse, device=dev)
    rows = []
    for n in (8, 16):
        fns, tags = [], []
        for (H, C, nout), calls in SHAPES.items():
            act = torch.randn(n, H, H, C, device=dev)
            w = torch.randn(nout, 9 * C, device=dev) / (9 * C) ** 0.5
            out = torch.empty(n, H, H, nout, device=dev)
            M, k = n * H * H, -(-9 * C // frb.F32_BK)
            tiles = -(-M // frb.F32_BM) * -(-nout // frb.F32_BN)
            plan = frb._f32_conv(k, tiles, M, nout, frb.SMS, wse)
            configs = {(plan.tn, plan.splits, plan.per)}
            for tn in frb.F32_TN:
                for cut in SPLITS:
                    per = -(-k // cut)
                    s = -(-k // per)  # the slices `per` steps give
                    if s == 1 or s * M * nout <= wse:
                        configs.add((tn, s, per))
            for tn, s, per in sorted(configs):
                def fn(act=act, w=w, out=out, H=H, C=C, nout=nout, tn=tn, s=s, per=per):
                    err = lib.diffpure_f32conv(
                        act.data_ptr(), n, H, H, C, w.data_ptr(), nout, out.data_ptr(),
                        ws.data_ptr(), wse, tn, frb.F32_STAGES[tn], s, per, 0, _cuda.stream(dev))
                    _cuda.check(err, "diffpure_f32conv")
                fns.append(fn)
                tags.append(dict(batch=n, H=H, C=C, nout=nout, calls=calls, tn=tn, splits=s,
                                 per=per, plan=(tn, s, per) == (plan.tn, plan.splits, plan.per)))
        for t, (ms, _) in zip(tags, cs.device_ms_many(torch, fns, reps=10)):
            rows.append(dict(t, device_ms=ms))
    for n in (8, 16):
        tot_plan = tot_best = 0.0
        for (H, C, nout), calls in SHAPES.items():
            mine = [r for r in rows
                    if r["batch"] == n and (r["H"], r["C"], r["nout"]) == (H, C, nout)]
            plan = next(r for r in mine if r["plan"])
            best = min(mine, key=lambda r: r["device_ms"])
            tot_plan += plan["device_ms"] * calls
            tot_best += best["device_ms"] * calls
            print(f"b{n} {H:2d}x{H:<2d} {C:3d}->{nout:3d} x{calls:2d}: plan 8x{plan['tn']} "
                  f"{plan['splits']}x{plan['per']} {plan['device_ms'] * 1e3:.1f} us, best "
                  f"8x{best['tn']} {best['splits']}x{best['per']} {best['device_ms'] * 1e3:.1f} us",
                  flush=True)
        print(f"batch {n}: these GEMMs per evaluation's backward, the plan's {tot_plan:.3f} ms, "
              f"the best split of each {tot_best:.3f} ms on {smi}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "f32_split_ablation.json").write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
