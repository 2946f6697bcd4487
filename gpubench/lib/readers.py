"""The arithmetic of the per-layer metrics, one function each; the files
under ``metrics/`` bind a metric's name to one of these and to the entry
whose cells it reads. A reader that finds nothing returns None and the
metric is left out of the line."""
from __future__ import annotations

from typing import Optional

from gpubench.lib.trace import TraceData


def _ok(t: Optional[TraceData], entry: str) -> bool:
    return t is not None and t.entry == entry and t.steps > 0 and t.window_s > 0


def host_ms_per_step(t, entry):
    """Host time a solver step outside the benchmark's spans around the
    score model (its backward included) and the classifier, less the waits
    on a full launch queue."""
    if not _ok(t, entry):
        return None
    return t.host_self_s / t.steps * 1e3


def device_ms_per_step(t, entry):
    if not _ok(t, entry) or not t.kernels:
        return None
    return t.device_s / t.steps * 1e3


def kernels_per_step(t, entry):
    if not _ok(t, entry) or not t.kernels:
        return None
    return len(t.kernels) / t.steps


def step_roofline(t, entry):
    """The score model's blocks' least time by the frozen count over the
    step's device time (every operation), %."""
    if not _ok(t, entry) or t.device_s <= 0 or t.bound_s_per_step <= 0:
        return None
    return t.bound_s_per_step * t.steps / t.device_s * 100.0


def own_device_share(t, entry):
    if not _ok(t, entry) or t.device_s <= 0:
        return None
    return sum(e - s for _, s, e in t.own()) / t.device_s * 100.0


def idle_share(t, entry):
    if not _ok(t, entry) or not t.kernels:
        return None
    return max(0.0, 1.0 - t.busy_s / t.window_s) * 100.0


def peak_mem_gib(t, entry):
    if not _ok(t, entry) or t.peak_window_bytes <= 0:
        return None
    return t.peak_window_bytes / 2 ** 30


def mfu(t, entry):
    """The model FLOPs the window's finished calls need, over its wall time
    and the configuration's dtype peak, %."""
    if not _ok(t, entry) or t.rate_wall_s <= 0:
        return None
    return t.model_flops / t.rate_wall_s / t.peak_flops * 100.0
