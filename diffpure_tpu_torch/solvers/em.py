"""Euler-Maruyama SDE integrator (port of diffpure_tpu/solvers/em.py:53).

A Python loop over a fixed number of steps. Brownian increments come from
the caller, one per step, so parity tests can inject the increments JAX
drew; the default source (``brownian_increment``) is counter-based, so any
step's noise can be replayed from (seed, step) alone.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from diffpure_tpu_torch.utils.prng import generator

Tensor = torch.Tensor


def brownian_increment(seed: int, i: int, like: Tensor, dt: float) -> Tensor:
    """dW_i ~ N(0, |dt|) shaped like ``like``, from a generator seeded by
    (seed, i) on ``like``'s device. |dt| keeps descending grids NaN-free."""
    g = generator(seed, i, device=like.device)
    return torch.randn(like.shape, generator=g, device=like.device,
                       dtype=like.dtype) * math.sqrt(abs(dt))


def sdeint_em(drift: Callable[[Tensor, Tensor], Tensor],
              diffusion: Callable[[Tensor], Tensor], x0: Tensor, t0: float,
              t1: float, n_steps: int, dw: Callable[[int], Tensor]) -> Tensor:
    """Integrate dx = drift(x, t) dt + diffusion(t) dW from t0 to t1 in
    ``n_steps`` steps; ``dw(i)`` is the Brownian increment of step i.

    t_i = t0 + i * dt is formed in float32, as the JAX scan forms it.
    """
    dt = (t1 - t0) / n_steps
    t0_32, dt_32 = np.float32(t0), np.float32(dt)
    x = x0
    for i in range(n_steps):
        t = float(t0_32 + np.float32(i) * dt_32)
        tb = torch.full((x.shape[0],), t, dtype=x.dtype, device=x.device)
        g = diffusion(tb)
        g = g.reshape(g.shape + (1,) * (x.ndim - g.ndim))
        x = x + drift(x, tb) * dt + g * dw(i)
    return x
