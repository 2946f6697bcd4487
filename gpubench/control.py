"""The correctness check's two readings for a cell, at the cell's own size:
the program's (one timed call, compared on as many rows as a run compares)
and its control's (the plain reference one precision down, put in the
program's place: TF32 operands for the fp32 configurations, fp8 for the
bf16 one), each against the plain fp32 reference, seed after seed in one
process. A cell's limits lie between the largest program reading and the
smallest control reading.

    python3 gpubench/control.py --workload <cell> --seeds 11 12 13 ... [--controls 3]

Prints one JSON line a seed. The benchmark's runs do not run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def readings(cell: str, seed: int, control: bool, device="cuda:0", base=None) -> dict:
    """The program's numbers and, with ``control``, the control's, for one
    seed."""
    import torch

    from gpubench.lib import manifest

    base = base or manifest.HERE
    wl = manifest.workload(cell, base)
    cfg = manifest.config(wl["config"], base)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    session = importlib.import_module(f"gpubench.entries.{wl['entry']}").Session(
        wl, cfg, seed, device)
    t0 = time.perf_counter()
    session.setup()
    session.call(0)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    session.free()
    _, rows = session.sample()
    program = tuple(t[rows] for t in session.outputs[0])
    want = session.reference(0, rows)
    t2 = time.perf_counter()
    out = {"seed": seed, "program": session.numbers(program, want),
           "seconds": {"program": t1 - t0, "reference": t2 - t1}}
    if control:
        mode = CONTROL[cfg["dtype"]]
        out["control"] = {mode: session.numbers(session.reference(0, rows, mode), want)}
        out["seconds"]["control"] = time.perf_counter() - t2
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3,
                   help="run the control on this many of the seeds, the first ones")
    args = p.parse_args(argv)
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings(args.workload, seed, i < args.controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
