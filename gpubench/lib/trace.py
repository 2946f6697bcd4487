"""The traced run: spans around the program's calls, a bounded profiler
window inside one call made after the timed window, and what the readers
read from it.

The benchmark's own files wrap the callables it hands the program (the
score model, the classifier) in ``Span``s: a ``record_function`` range and
host-clock intervals while the window is open. The window opens before
score evaluation ``start`` of the traced call and closes before evaluation
``stop`` (the call is then cut short: ``WindowClosed``), or where ``stop``
is None when the call returns, each after a ``torch.cuda.synchronize``, so
it holds whole solver steps; the profiler's trace stays in memory. The
profiler is started and stopped on the calling thread, never inside a
backward pass: autograd restores the caller's thread-local profiler state
after each node it runs. It is started only once the timed window has
closed: a process that has run it launches kernels more slowly after.
"""
from __future__ import annotations

import bisect
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "bench."
MARK = SPAN_PREFIX + "mark"
# the host blocking because the device's launch queue is full: waiting for
# the device, not host work
QUEUE_FULL = "Command Buffer Full"


class WindowClosed(Exception):
    """Raised out of the traced call once its window has closed."""


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launch_counts() -> Dict[str, int]:
    """The program's counters of its hand-written kernels' launches."""
    from diffpure_tpu_torch.ops import launch_counts
    return dict(launch_counts())


class Tracer:
    """Opens and closes the profiler window at score evaluations ``start``
    and ``stop`` (None: the call's end, ``finish``) of the first call it is
    armed for."""

    def __init__(self, start: int, stop: Optional[int], steps: int, device):
        self.start, self.stop, self.steps, self.device = start, stop, steps, device
        self.armed = False
        self.active = False
        self.done = False
        self.intervals: List[Tuple[float, float]] = []
        self.prof: Optional[profile] = None
        self.t0 = self.t1 = self.host_end = 0.0
        self.launches: Dict[str, int] = {}

    def on_eval(self, index: int) -> None:
        if self.armed and not self.active and index == self.start:
            self._begin()
        elif self.active and index == self.stop:
            self._end()

    def finish(self) -> None:
        """The end of a timed call."""
        if self.active:
            self._end()

    def _begin(self) -> None:
        _sync(self.device)
        self._launches0 = _launch_counts()
        on_card = torch.device(self.device).type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if on_card else []))
        self.prof.start()
        self.active = True
        self.t0 = time.perf_counter()
        with record_function(MARK):  # ties the host clock to the profiler's
            pass

    def _end(self) -> None:
        # the host's share of the window ends here; the device's once it
        # has drained what the host ran ahead with
        self.host_end = time.perf_counter()
        _sync(self.device)
        self.t1 = time.perf_counter()
        self.prof.stop()
        after = _launch_counts()
        self.launches = {k: after[k] - self._launches0.get(k, 0) for k in after}
        self.active, self.armed, self.done = False, False, True

    def span(self, t0: float, t1: float) -> None:
        if self.active:
            self.intervals.append((t0, t1))


class Span:
    """A callable of the program's, wrapped: a ``bench.<name>`` range, the
    host interval of each call while the window is open and, where the
    output carries a gradient, the interval of its backward (from the
    output's cotangent arriving to the first input's leaving). ``evals``
    counts calls; ``tracer.on_eval`` sees each index first when
    ``triggers``."""

    def __init__(self, fn, name: str, tracer: Optional[Tracer] = None, triggers: bool = False):
        self.fn, self.name, self.tracer, self.triggers = fn, SPAN_PREFIX + name, tracer, triggers
        self.evals = 0

    def __call__(self, x, *args):
        tr = self.tracer
        if tr is not None and self.triggers:
            tr.on_eval(self.evals)
            if tr.done:
                raise WindowClosed
        self.evals += 1
        t0 = time.perf_counter()
        with record_function(self.name):
            out = self.fn(x, *args)
        if tr is not None and tr.active:
            tr.span(t0, time.perf_counter())
            if out.requires_grad and x.requires_grad:
                self._hook_backward(out, x)
        return out

    def _hook_backward(self, out, x) -> None:
        mark = []

        def arrived(g):
            mark.append(time.perf_counter())

        def left(g):
            now = time.perf_counter()
            self.tracer.span(mark[0] if mark else now, now)

        out.register_hook(arrived)
        x.register_hook(left)


def _union(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@dataclass
class TraceData:
    """What the readers read. Times in seconds; ``kernels`` are (name,
    start, end) of every device operation in the window; ``host_self_s``
    the window's host time up to the closing synchronisation less the
    spans' and the waits on a full launch queue; ``rate_wall_s`` the
    (untraced) timed window's wall time, in which the calls needed
    ``model_flops``."""
    entry: str
    steps: int
    window_s: float
    host_self_s: float
    kernels: List[Tuple[str, float, float]]
    launches: Dict[str, int]
    own_kernels: Tuple[str, ...]
    bound_s_per_step: float
    peak_window_bytes: int
    model_flops: float
    rate_wall_s: float
    peak_flops: float
    host_events: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def device_s(self) -> float:
        return sum(e - s for _, s, e in self.kernels)

    @property
    def busy_s(self) -> float:
        return _union([(s, e) for _, s, e in self.kernels])

    def own(self) -> List[Tuple[str, float, float]]:
        return [k for k in self.kernels if any(f in k[0] for f in self.own_kernels)]


def collect(tracer: Tracer, **kw) -> TraceData:
    """TraceData from a closed window."""
    kernels, host = [], []
    # the raw events: building the profiler's event tree takes minutes for
    # a whole gradient call
    for e in tracer.prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e9
        t = s + e.duration_ns() / 1e9
        if str(e.device_type()).endswith("CUDA"):
            if not e.name().startswith(SPAN_PREFIX):
                kernels.append((e.name(), s, t))
        else:
            host.append((e.name(), s, t))
    # the spans' host-clock intervals on the profiler's clock
    mark = next((h[1] for h in host if h[0] == MARK), None)
    shift = 0.0 if mark is None else mark - tracer.t0
    a, b = tracer.t0 + shift, tracer.host_end + shift
    busy = [(s + shift, t + shift) for s, t in tracer.intervals]
    if mark is not None:
        busy += [(s, t) for n, s, t in host if n == QUEUE_FULL]
    busy = [(max(s, a), min(t, b)) for s, t in busy if t > a and s < b]
    return TraceData(steps=tracer.steps, window_s=tracer.t1 - tracer.t0,
                     host_self_s=max(b - a - _union(busy), 0.0), kernels=kernels,
                     launches=tracer.launches, host_events=host, **kw)


def breakdown(t: TraceData, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the device by the innermost host event open when each began."""
    by_op = Counter()
    for name, s, e in t.kernels:
        by_op[name] += e - s
    gaps = []
    end = None
    for name, s, e in sorted(t.kernels, key=lambda k: k[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    host = sorted(t.host_events, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_host = defaultdict(float)
    for a, b in gaps:
        i = bisect.bisect_right(starts, a) - 1
        name = "none"
        for j in range(i, max(i - 400, -1), -1):
            if host[j][2] >= a:
                name = host[j][0]
                break
        by_host[name] += b - a
    return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[n, v] for n, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:top]]}
