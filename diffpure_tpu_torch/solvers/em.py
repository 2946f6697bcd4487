"""Euler-Maruyama SDE integrator (port of diffpure_tpu/solvers/em.py:53).

A Python loop over a fixed number of steps. Brownian increments come from
the caller, one per step, so parity tests can inject the increments JAX
drew; the default source (``brownian_increment``) is counter-based, so any
step's noise can be replayed from (seed, step) alone.

Differentiable: with ``checkpoint=True`` each step runs under
``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint`` on the
scan body, diffpure_tpu/solvers/em.py:79-80): the backward recomputes one
step at a time, replaying its Brownian increment by index, so memory is
O(n_steps * state) and each step's drift runs twice. For O(1) memory see
solvers/adjoint.py.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from diffpure_tpu_torch.utils.prng import generator
from diffpure_tpu_torch.utils.profiling import record_nfe

Tensor = torch.Tensor


def brownian_increment(seed: int, i: int, like: Tensor, dt: float) -> Tensor:
    """dW_i ~ N(0, |dt|) shaped like ``like``, from a generator seeded by
    (seed, i) on ``like``'s device. |dt| keeps descending grids NaN-free."""
    g = generator(seed, i, device=like.device)
    return torch.randn(like.shape, generator=g, device=like.device,
                       dtype=like.dtype) * math.sqrt(abs(dt))


def em_time(t0: float, dt: float, i: int) -> float:
    """t_i = t0 + i * dt formed in float32, as the JAX scan forms it."""
    return float(np.float32(t0) + np.float32(i) * np.float32(dt))


def em_step(drift: Callable[[Tensor, Tensor], Tensor],
            diffusion: Callable[[Tensor], Tensor], x: Tensor, t: float,
            dt: float, dw: Tensor) -> Tensor:
    """One Euler-Maruyama step x + drift(x, t) dt + diffusion(t) dW."""
    tb = torch.full((x.shape[0],), t, dtype=x.dtype, device=x.device)
    g = diffusion(tb)
    g = g.reshape(g.shape + (1,) * (x.ndim - g.ndim))
    return x + drift(x, tb) * dt + g * dw


def sdeint_em(drift: Callable[[Tensor, Tensor], Tensor],
              diffusion: Callable[[Tensor], Tensor], x0: Tensor, t0: float,
              t1: float, n_steps: int, dw: Callable[[int], Tensor], *,
              checkpoint: bool = False) -> Tensor:
    """Integrate dx = drift(x, t) dt + diffusion(t) dW from t0 to t1 in
    ``n_steps`` steps; ``dw(i)`` is the Brownian increment of step i.

    ``checkpoint``: recompute each step in the backward instead of keeping
    its activations (only when autograd records, otherwise a plain loop).
    Records ``n_steps`` evaluations as ``"sde_euler"`` (JAX em.py:81), once
    per call: the recomputed steps do not count again.
    """
    dt = (t1 - t0) / n_steps

    def step(x: Tensor, i: int) -> Tensor:
        return em_step(drift, diffusion, x, em_time(t0, dt, i), dt, dw(i))

    record_nfe("sde_euler", n_steps)
    remat = checkpoint and torch.is_grad_enabled()
    x = x0
    for i in range(n_steps):
        x = _checkpoint(step, x, i, use_reentrant=False) if remat else step(x, i)
    return x
