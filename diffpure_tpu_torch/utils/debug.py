"""Numerics guards (port of diffpure_tpu/utils/debug.py): NaN detection and
value checks.

``nan_guard`` is JAX's ``jax_debug_nans``: inside it, the first PyTorch
operator whose output holds a NaN raises ``FloatingPointError`` naming the
operator, in the forward and in the backward (a ``TorchDispatchMode``
sees both; autograd carries the mode to its worker threads). As in JAX,
infinities pass. It checks every output, a synchronisation each: a
debugging switch, never on a timed path. The hand-written kernels are no
PyTorch operators: a NaN one makes is caught at the next operator that
reads it.

``assert_finite`` / ``assert_in_range`` are checkify's checks: no-ops
(no synchronisation, nothing read) outside ``checkified`` and
``nan_guard``; inside ``checkified(fn)`` the first failure becomes the
error returned with fn's result, inside ``nan_guard`` it raises.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

Tensor = torch.Tensor


class CheckError(RuntimeError):
    """A failed check (JAX's ``JaxRuntimeError`` of checkify)."""


class Error:
    """What ``checkified`` returns beside the result: the first failed
    check's message, or none."""

    def __init__(self):
        self.message: Optional[str] = None

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise CheckError(self.message)


_STATE = threading.local()  # .errors: the Error of the innermost checkified; .guards


def _nan_in(out) -> bool:
    tensors, _ = tree_flatten(out)
    return any(isinstance(t, Tensor) and t.is_floating_point() and t.device.type != "meta"
               and bool(torch.isnan(t).any()) for t in tensors)


class _NaNMode(TorchDispatchMode):
    """Checks each operator's outputs; ``report(message)`` on a NaN."""

    def __init__(self, report: Callable[[str], None]):
        super().__init__()
        self.report = report

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _nan_in(out):
            self.report(f"invalid value (nan) encountered in {func}")
        return out


def _raise_fpe(message: str) -> None:
    raise FloatingPointError(message)


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Raise at the first operator that makes a NaN, within the scope."""
    if not enable:
        yield
        return
    _STATE.guards = getattr(_STATE, "guards", 0) + 1
    try:
        with _NaNMode(_raise_fpe):
            yield
    finally:
        _STATE.guards -= 1


def checkified(fn: Callable, *, errors=("user", "nan")) -> Callable:
    """fn wrapped so that its checks become a returned error:
    ``err, out = checkified(fn)(*args)``. ``errors``: 'user' (the
    ``assert_*`` checks) and 'nan' (an operator that makes a NaN), JAX's
    ``user_checks | nan_checks``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        err = Error()

        def record(message: str) -> None:
            if err.message is None:
                err.message = message

        outer = getattr(_STATE, "errors", None)
        _STATE.errors = record if "user" in errors else None
        try:
            with _NaNMode(record) if "nan" in errors else contextlib.nullcontext():
                out = fn(*args, **kwargs)
        finally:
            _STATE.errors = outer
        return err, out

    return wrapped


def _check(ok: Callable[[], Tensor], message: str) -> None:
    record = getattr(_STATE, "errors", None)
    if record is None and not getattr(_STATE, "guards", 0):
        return
    if not bool(ok()):
        if record is None:
            raise CheckError(message)
        record(message)


def assert_finite(x: Tensor, name: str = "tensor") -> Tensor:
    """x, checked to be finite (a no-op outside ``checkified`` / ``nan_guard``)."""
    _check(lambda: torch.isfinite(x).all(), f"{name} contains non-finite values")
    return x


def assert_in_range(x: Tensor, lo: float, hi: float, name: str = "tensor") -> Tensor:
    """x, checked to lie in [lo, hi] (the reference's t in [0, 1] asserts,
    ref diffpure_sde.py:83)."""
    _check(lambda: (x.min() >= lo) & (x.max() <= hi), f"{name} out of range [{lo}, {hi}]")
    return x
