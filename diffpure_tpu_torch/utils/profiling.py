"""NFE accounting, phase timers and profiler glue (port of
diffpure_tpu/utils/profiling.py).

The solvers know how many score evaluations one call makes and report it
with ``record_nfe``; a ``count_nfe()`` context installs the ledger that
collects those reports. Eager PyTorch runs every solver call on the host,
so ``record_nfe`` adds to the installed ledger directly: JAX's trace-time
tally (``nfe_tally`` / ``absorb_nfe``) and host callbacks have nothing to
do here. A solver records once per call, outside its steps, so the
recomputation of ``checkpoint=True`` and the adjoint's backward add
nothing. The ledger is the calling thread's: a purification run in
another thread (a CPU reference computed beside the card's work) does not
land in it.

The profiler glue: ``trace`` is ``torch.profiler`` writing a Chrome trace,
``annotate`` a ``record_function`` range, ``flops_estimate`` PyTorch's
``FlopCounterMode`` (XLA's cost analysis in JAX). The counter sees
PyTorch's operators only, not the hand-written kernels' work: count a
function whose work runs in them on CPU tensors, where the wrappers run
their plain versions.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class NFECounter:
    """Score-model evaluations per phase (the solver that made them)."""

    def __init__(self):
        self.counts: Dict[str, int] = defaultdict(int)

    def add(self, phase: str, nfe: int) -> None:
        self.counts[phase] += nfe

    def total(self) -> int:
        return sum(self.counts.values())

    def report(self) -> str:
        parts = [f"{k}={v}" for k, v in sorted(self.counts.items())]
        return f"NFE total={self.total()} ({', '.join(parts)})"


_LEDGER = threading.local()  # .counter: the ledger count_nfe installed in this thread


@contextlib.contextmanager
def count_nfe() -> Iterator[NFECounter]:
    """Scoped counting: ``with count_nfe() as c: ...; c.total()``. Counts
    the evaluations recorded in the calling thread."""
    outer = getattr(_LEDGER, "counter", None)
    _LEDGER.counter = NFECounter()
    try:
        yield _LEDGER.counter
    finally:
        _LEDGER.counter = outer


def record_nfe(phase: str, nfe: int) -> None:
    """Credit ``nfe`` forward evaluations to ``phase`` in the ledger the
    calling thread installed (none installed: nothing to do)."""
    counter: Optional[NFECounter] = getattr(_LEDGER, "counter", None)
    if counter is not None:
        counter.add(phase, int(nfe))


class PhaseTimer:
    """Wall-clock per phase (the 'sampling time per batch' metric,
    ref eval_sde_adv.py:84-87)."""

    def __init__(self):
        self.times: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.times[name] += time.time() - t0
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        return self.times[name] / max(self.counts[name], 1)

    def report(self) -> str:
        return ", ".join(f"{k}: {self.times[k]:.2f}s/{self.counts[k]}x"
                         for k in sorted(self.times))


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the scope (the CPU, and the card where there is one) and
    write ``log_dir/trace.json`` (chrome://tracing, Perfetto); None: no
    profiling."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range in the trace."""
    return torch.profiler.record_function(name)


def flops_estimate(fn, *args) -> Optional[float]:
    """FLOPs of one call ``fn(*args)`` without a graph, by PyTorch's
    ``FlopCounterMode`` (matrix products, convolutions, attention); None
    where counting fails."""
    try:
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:
        return None


def attention_flops(batch: int, seq: int, channels: int) -> int:
    """Closed-form attention matmul FLOPs (ref unet.py:316-333): two
    (seq x seq x channels) matmuls."""
    return 2 * batch * (seq ** 2) * channels
