"""One run of one cell: set-up, the timed window, the traced window's
per-layer metrics, the check against the reference, and the result line.

Nothing here knows a cell: the workload's file names its configuration and
its entry (``entries/<entry>.py``, a ``Session``), the manifest its
metrics, and each per-layer metric has its reader under ``metrics/``."""
from __future__ import annotations

import importlib
import subprocess
import sys
import time
from typing import Optional

import torch

from gpubench.counts import blocks
from gpubench.counts.peaks import PEAK_FLOPS
from gpubench.lib import manifest, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "diffpure_tpu")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card(device) -> dict:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        line = out.stdout.strip().splitlines()[torch.device(device).index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    return dict(zip(q.split(","), (v.strip() for v in line.split(","))))


def _kernel_counts(cfg: dict, wl: dict):
    """(the score model's blocks' least time a solver step by the frozen
    count, the hand-written kernels' names' fragments) for the score
    model's family."""
    spec = cfg["score_model"]
    counts = importlib.import_module(f"gpubench.counts.{spec['family']}")
    forwards, backwards = (2, 1) if wl["entry"] == "eotgrad" else (1, 0)
    bound = blocks.step_bound_s(counts.census(spec["args"]), wl["batch"], cfg["dtype"],
                                forwards, backwards)
    return bound, counts.KERNELS


def _traced_call(session, k: int, device) -> trace.Tracer:
    """One more call, after the timed window, with the profiler window in
    it; its output is not kept (the check reads the timed calls')."""
    start, stop, steps = session.trace_window()
    tracer = trace.Tracer(start, stop, steps, device)
    session.trace(tracer)
    tracer.armed = True
    try:
        session.call(k)
    except trace.WindowClosed:
        pass
    tracer.finish()
    session.trace(None)
    session.outputs.pop(k, None)
    _sync(device)
    return tracer


def run_cell(cell: str, seed: int, seconds: float, traced: bool, t_start: float,
             device="cuda", bench: Optional[dict] = None, base=manifest.HERE,
             log=print) -> dict:
    """Run ``cell`` once and return the result (the line's object). ``log``
    takes lines for standard error."""
    bench = bench or manifest.benchmark()
    wl = manifest.workload(cell, base)
    cfg = manifest.config(wl["config"], base)
    entry = importlib.import_module(f"gpubench.entries.{wl['entry']}")
    on_card = torch.device(device).type == "cuda"
    # fp32 stays fp32, as the program's CLI sets it: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    session = entry.Session(wl, cfg, seed, device)
    t_session = time.perf_counter()
    session.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    phases = {"start": t_session - t_start, **getattr(session, "setup_phases", {})}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    units, calls = 0, 0
    t0 = time.perf_counter()
    while True:
        units += session.call(calls)
        calls += 1
        _sync(device)
        wall = time.perf_counter() - t0
        if wall >= seconds:
            break
    peak_window = torch.cuda.max_memory_allocated(device) if on_card else 0
    peak = max(peak, peak_window)

    metrics, extra = {}, {}
    if traced:
        tracer = _traced_call(session, calls, device)
        data = None
        if tracer.done:
            bound, kernels = _kernel_counts(cfg, wl)
            data = trace.collect(
                tracer, entry=wl["entry"], own_kernels=kernels, bound_s_per_step=bound,
                peak_window_bytes=peak_window, model_flops=units * session.flops_per_unit(),
                rate_wall_s=wall, peak_flops=PEAK_FLOPS[cfg["dtype"]])
            extra["busy_s"] = data.busy_s
            extra["window_s"] = data.window_s
            extra["breakdown"] = trace.breakdown(data)
            own_calls = sum(1 for _ in data.own())
            log(f"trace: {data.steps} steps in {data.window_s:.4f} s, {len(data.kernels)} device "
                f"operations, {own_calls} of the hand-written kernels; launches by the wrappers "
                f"{sum(data.launches.values())} {dict((k, v) for k, v in data.launches.items() if v)}"
                + (" (fewer kernels than launches: the profiler dropped events)"
                   if own_calls < sum(data.launches.values()) else ""))
        for m in manifest.per_layer(bench, cell):
            value = manifest.reader(m["name"], base).read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rate = [m for m in manifest.end_to_end(bench, cell) if m["name"] != "setup_s"]
        for m in rate:
            metrics[m["name"]] = {"value": units / wall, "unit": m["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"JAX or the JAX package was loaded: {found}")

    smi = card(device) if on_card else {}
    log(f"card: {smi}")
    log(f"window: {calls} calls, {units} units in {wall:.4f} s; set-up {setup_s:.4f} s ("
        + ", ".join(f"{k} {v:.4f} s" for k, v in phases.items()) + ")")
    failed = session.failed()
    session.free()
    numbers = session.check()
    limits = wl["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values()) and failed == 0
    if not correct:
        failed = max(failed, 1)
    for k, v in checks.items():
        log(f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})")

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": wl["chips"], "memory_peak_bytes": int(peak)}
    dev.update({k: extra[k] for k in ("busy_s", "window_s") if k in extra})
    result = {"correct": bool(correct), "attempted": calls, "failed": failed,
              "metrics": metrics, "device": dev}
    if "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["checks"] = checks
    return result
