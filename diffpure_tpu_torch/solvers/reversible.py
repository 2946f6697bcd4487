"""Reversible Heun: an algebraically reversible SDE solver with exact
O(1)-memory gradients (port of diffpure_tpu/solvers/reversible.py:45-176;
Kidger et al., arXiv:2105.13493).

The solve carries a pair (y, yhat):

    yhat_{n+1} = 2 y_n - yhat_n + f(yhat_n, t_n) dt + g(t_n) dW_n
    y_{n+1}    = y_n + (f(yhat_n, t_n) + f(yhat_{n+1}, t_{n+1})) dt / 2
                     + (g(t_n) + g(t_{n+1})) dW_n / 2

and the step can be undone algebraically from (y_{n+1}, yhat_{n+1}) with
the same dW_n. One autograd ``Function``: the forward keeps no graph and
saves only the final pair; the backward walks the steps in reverse, rebuilds
(y_n, yhat_n) (two drift evaluations without a graph), then takes the local
vector-Jacobian product of the whole step at the rebuilt state (two more,
with a graph), and returns x0's cotangent as ybar_0 + yhatbar_0 (x0 seeds
both, JAX :163-165). The Brownian increments are replayed by index. The
time grid is float32, formed as JAX forms it from float32 t0 and t1.

The rebuilt trajectory equals the forward one only as far as the drift
returns the same bits for the same input and the reversal's rounding
allows: each backward records max |(y_0, yhat_0) - x0| of its rebuilt
start, which ``last_reconstruction_error`` reads.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from diffpure_tpu_torch.solvers.ode import _tb
from diffpure_tpu_torch.utils.profiling import record_nfe

Tensor = torch.Tensor
# the last backward's max |(y_0, yhat_0) - x0|, a 0-d tensor on x0's device
_LAST = {}


def _grid(t0: float, t1: float, n_steps: int):
    """(dt, t_n(i)) in float32: dt = (t1 - t0) / n, t_n = t0 + i dt."""
    t0, t1 = np.float32(t0), np.float32(t1)
    dt = np.float32((t1 - t0) / np.float32(n_steps))
    return dt, lambda i: np.float32(t0 + np.float32(i) * dt)


def _local_step(drift, diffusion, y: Tensor, yhat: Tensor, t_n: float, t_n1: float,
                dt: float, dw: Tensor):
    """The forward update as a function of (y, yhat) (JAX :131)."""
    f = drift(yhat, _tb(y, t_n))
    g = _bcast(diffusion(_tb(y, t_n)), y)
    yhat1 = 2.0 * y - yhat + f * dt + g * dw
    f1 = drift(yhat1, _tb(y, t_n1))
    g1 = _bcast(diffusion(_tb(y, t_n1)), y)
    return y + 0.5 * (f + f1) * dt + 0.5 * (g + g1) * dw, yhat1


def _bcast(g: Tensor, x: Tensor) -> Tensor:
    return g.reshape((x.shape[0],) + (1,) * (x.ndim - 1))


class _ReversibleHeun(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, x0, *params):
        drift, diffusion, t0, t1, n_steps, dw = spec
        dt, t_at = _grid(t0, t1, n_steps)
        f = drift(x0, _tb(x0, t_at(0)))
        g = _bcast(diffusion(_tb(x0, t_at(0))), x0)
        y, yhat = x0, x0
        for i in range(n_steps):
            t_n1 = np.float32(t_at(i) + dt)
            w = dw(i)
            yhat1 = 2.0 * y - yhat + f * float(dt) + g * w
            f1 = drift(yhat1, _tb(x0, t_n1))
            g1 = _bcast(diffusion(_tb(x0, t_n1)), x0)
            y = y + 0.5 * (f + f1) * float(dt) + 0.5 * (g + g1) * w
            yhat, f, g = yhat1, f1, g1
        ctx.spec = spec
        ctx.save_for_backward(x0, y, yhat, *params)
        return y

    @staticmethod
    def backward(ctx, ybar):
        drift, diffusion, t0, t1, n_steps, dw = ctx.spec
        x0, y1, yhat1, *params = ctx.saved_tensors
        dt, t_at = _grid(t0, t1, n_steps)
        fdt = float(dt)
        need = ctx.needs_input_grad[2:]
        wrt = [p for p, n in zip(params, need) if n]
        pbar = [torch.zeros_like(p) for p in wrt]
        yhatbar = torch.zeros_like(ybar)
        for i in reversed(range(n_steps)):
            t_n = t_at(i)
            t_n1 = np.float32(t_n + dt)
            w = dw(i)
            with torch.no_grad():  # the algebraic reversal (JAX :150-156)
                f1 = drift(yhat1, _tb(y1, t_n1))
                g1 = _bcast(diffusion(_tb(y1, t_n1)), y1)
                yhat = 2.0 * y1 - yhat1 - f1 * fdt - g1 * w
                f = drift(yhat, _tb(y1, t_n))
                g = _bcast(diffusion(_tb(y1, t_n)), y1)
                y = y1 - 0.5 * (f + f1) * fdt - 0.5 * (g + g1) * w
            with torch.enable_grad():  # the local VJP at the rebuilt state
                yy = y.detach().requires_grad_(True)
                yh = yhat.detach().requires_grad_(True)
                out = _local_step(drift, diffusion, yy, yh, t_n, t_n1, fdt, w)
                grads = torch.autograd.grad(out, [yy, yh, *wrt], (ybar, yhatbar),
                                            allow_unused=True)
            ybar, yhatbar = grads[0], grads[1]
            pbar = [acc + (d if d is not None else 0) for acc, d in zip(pbar, grads[2:])]
            y1, yhat1 = y, yhat
        # (y_0, yhat_0) are both x0 in exact arithmetic
        _LAST["error"] = torch.maximum((y1 - x0).abs().max(), (yhat1 - x0).abs().max())
        it = iter(pbar)
        return (None, ybar + yhatbar, *[next(it) if n else None for n in need])


def sdeint_reversible_heun(drift: Callable[[Tensor, Tensor], Tensor],
                           diffusion: Callable[[Tensor], Tensor], x0: Tensor,
                           t0: float, t1: float, n_steps: int,
                           dw: Callable[[int], Tensor],
                           params: Sequence[Tensor] = ()) -> Tensor:
    """Integrate dx = drift(x, t) dt + diffusion(t) dW (Stratonovich, which
    is Ito here: g is state-free) from t0 to t1 with reversible Heun,
    differentiable with respect to x0 and ``params`` by the algebraic
    reversal. ``dw(i)`` must return the same increment every call. Records
    ``n_steps + 1`` evaluations as ``"sde_reversible_heun"`` (JAX :91); the
    backward's four a step do not count."""
    record_nfe("sde_reversible_heun", n_steps + 1)
    return _ReversibleHeun.apply((drift, diffusion, t0, t1, n_steps, dw), x0, *params)


def odeint_reversible_heun(func: Callable[[Tensor, Tensor], Tensor], x0: Tensor,
                           t0: float, t1: float, n_steps: int,
                           params: Sequence[Tensor] = ()) -> Tensor:
    """The deterministic case (g = 0): reversible Heun's method with exact
    O(1)-memory gradients (JAX :169)."""
    return sdeint_reversible_heun(func, torch.zeros_like, x0, t0, t1, n_steps,
                                  lambda i: torch.zeros_like(x0), params)


def last_reconstruction_error() -> float:
    """max |(y_0, yhat_0) - x0| of the last backward's rebuilt start: how far
    the algebraic reversal lands from the forward's start in this
    arithmetic (0 where the drift returns the same bits for the same input
    and the reversal rounds back exactly)."""
    return float(_LAST["error"])
