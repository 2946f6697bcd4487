"""Run one cell of the benchmark once and print its result as the last line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a profiler window inside the first timed call). Exits
non-zero, printing no result, without the cards, or where JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from gpubench.lib import harness, manifest

    # the work is on the card: one host thread keeps the run's load steady
    torch.set_num_threads(1)
    t_imports = time.perf_counter()

    bench = manifest.benchmark(ROOT)
    cell = manifest.cell_entry(bench, args.workload)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2

    def log(line):
        print(line, file=sys.stderr, flush=True)

    log(f"set-up: imports {t_imports - T_START:.4f} s, the look for the cards "
        f"{time.perf_counter() - t_imports:.4f} s")

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              T_START, device="cuda:0", bench=bench, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        log(f"{k}: {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
