"""Fixed-step ODE integrators (port of diffpure_tpu/solvers/ode.py:21-72):
Euler, and Heun's explicit trapezoidal rule, the fixed-step stand-in for
the reference's adaptive dopri5 (ref runners/diffpure_ode.py:243).

Python loops over a fixed number of steps, time formed in float32 as the
JAX scans form it (``em_time``). With ``checkpoint=True`` each step runs
under ``torch.utils.checkpoint`` when autograd records (JAX's
``jax.checkpoint`` on the scan body): the backward recomputes one step at a
time. The O(1)-memory adjoint of the Euler solve is
solvers/adjoint.odeint_euler_adjoint, the reversible one
solvers/reversible.odeint_reversible_heun.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from diffpure_tpu_torch.solvers.em import em_time
from diffpure_tpu_torch.utils.profiling import record_nfe

Tensor = torch.Tensor
OdeFn = Callable[[Tensor, Tensor], Tensor]  # f(x, t_batch) -> dx/dt


def _tb(x: Tensor, t) -> Tensor:
    """A (batch,) time tensor at t on x's device and dtype."""
    return torch.full((x.shape[0],), float(t), dtype=x.dtype, device=x.device)


def _integrate(step, x0: Tensor, n_steps: int, checkpoint: bool) -> Tensor:
    remat = checkpoint and torch.is_grad_enabled()
    x = x0
    for i in range(n_steps):
        x = _checkpoint(step, x, i, use_reentrant=False) if remat else step(x, i)
    return x


def odeint_euler(func: OdeFn, x0: Tensor, t0: float, t1: float, n_steps: int, *,
                 checkpoint: bool = False) -> Tensor:
    """Integrate dx/dt = func(x, t) from t0 to t1 in ``n_steps`` Euler
    steps; records ``n_steps`` evaluations as ``"ode_euler"``."""
    dt = (t1 - t0) / n_steps

    def step(x: Tensor, i: int) -> Tensor:
        return x + func(x, _tb(x, em_time(t0, dt, i))) * dt

    record_nfe("ode_euler", n_steps)
    return _integrate(step, x0, n_steps, checkpoint)


def odeint_heun(func: OdeFn, x0: Tensor, t0: float, t1: float, n_steps: int, *,
                checkpoint: bool = False) -> Tensor:
    """Heun's method: k1 = f(x, t), k2 = f(x + dt k1, t + dt),
    x + dt/2 (k1 + k2); two evaluations a step, recorded as ``"ode_heun"``."""
    dt = (t1 - t0) / n_steps

    def step(x: Tensor, i: int) -> Tensor:
        t = em_time(t0, dt, i)
        k1 = func(x, _tb(x, t))
        k2 = func(x + dt * k1, _tb(x, float(np.float32(t) + np.float32(dt))))
        return x + (dt / 2) * (k1 + k2)

    record_nfe("ode_heun", 2 * n_steps)
    return _integrate(step, x0, n_steps, checkpoint)
