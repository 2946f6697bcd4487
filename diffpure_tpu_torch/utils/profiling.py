"""NFE accounting and phase timers (port of the ledger half of
diffpure_tpu/utils/profiling.py:19-222).

The solvers know how many score evaluations one call makes and report it
with ``record_nfe``; a ``count_nfe()`` context installs the ledger that
collects those reports. Eager PyTorch runs every solver call on the host,
so ``record_nfe`` adds to the installed ledger directly: JAX's trace-time
tally (``nfe_tally`` / ``absorb_nfe``) and host callbacks have nothing to
do here. A solver records once per call, outside its steps, so the
recomputation of ``checkpoint=True`` and the adjoint's backward add
nothing. The ledger is the calling thread's: a purification run in
another thread (a CPU reference computed beside the card's work) does not
land in it. The JAX profiler glue (``trace``, ``annotate``,
``flops_estimate``) is not ported.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


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
