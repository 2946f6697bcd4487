"""DPM-Solver++(2M) for the VP probability-flow ODE (port of
diffpure_tpu/solvers/dpm.py:33-82).

Data-prediction form: with alpha_t, sigma_t the VP marginal coefficients
and lambda = log(alpha / sigma),
    x_{i+1} = (sigma_{i+1} / sigma_i) x_i - alpha_{i+1} (e^{-h} - 1) D_i,
    h = lambda_{i+1} - lambda_i,
    D_i = (1 + 1/(2r)) x0_i - (1/(2r)) x0_{i-1},  r = h_{i-1} / h_i
(first step: D_0 = x0_0, i.e. DDIM), x0 = (x - sigma eps) / alpha.

The time grid and every coefficient are float32, formed as JAX forms them
(``jnp.linspace`` and ``_coeffs`` in float32): a float64 grid would move
the result by more than 1e-5. With a gradient wanted, each multistep step
runs under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint(step)``).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from diffpure_tpu_torch.diffusion.schedules import linspace_f32
from diffpure_tpu_torch.diffusion.sde import VPSDE
from diffpure_tpu_torch.utils.profiling import record_nfe

Tensor = torch.Tensor
EpsFn = Callable[[Tensor, Tensor], Tensor]  # (x, t_batch) -> epsilon


def _coeffs(sde: VPSDE, t: float) -> Tuple[Tensor, Tensor, Tensor]:
    """(alpha, sigma, lambda) at time t as float32 scalars on the CPU, in
    JAX's order of operations (near t = 1e-5, 1 - exp(2 lmc) cancels: an
    exp rounded another way moves sigma by percents)."""
    t = torch.tensor(t, dtype=torch.float32)
    lmc = (-0.25 * (t * t) * (sde.beta_max - sde.beta_min)
           - 0.5 * t * sde.beta_min)
    alpha = torch.exp(lmc)
    sigma = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * lmc), min=1e-12))
    return alpha, sigma, lmc - torch.log(sigma)


def dpm_solver_pp_2m(eps_fn: EpsFn, x: Tensor, t_start: float, t_end: float,
                     n_steps: int, sde: VPSDE) -> Tensor:
    """Integrate the probability-flow ODE from t_start down to t_end in
    ``n_steps`` score evaluations on a grid uniform in t; deterministic and
    differentiable."""
    B = x.shape[0]
    ts = linspace_f32(t_start, t_end, n_steps + 1)
    co = [_coeffs(sde, float(t)) for t in ts]  # (alpha, sigma, lambda) per point

    def x0_pred(x: Tensor, i: int) -> Tensor:
        alpha, sigma, _ = co[i]
        eps = eps_fn(x, torch.full((B,), float(ts[i]), dtype=x.dtype, device=x.device))
        return (x - sigma.item() * eps) / alpha.item()

    def step(x: Tensor, x0_prev: Tensor, i: int):
        (_, s_i, l_i), (a_n, s_n, l_n) = co[i], co[i + 1]
        h = l_n - l_i
        c = 1.0 / (2.0 * ((l_i - co[i - 1][2]) / h))  # 1 / (2 r)
        x0_i = x0_pred(x, i)
        D = (1.0 + c).item() * x0_i - c.item() * x0_prev
        return (s_n / s_i).item() * x - (a_n * (torch.exp(-h) - 1.0)).item() * D, x0_i

    record_nfe("dpm_solver_pp", n_steps)
    # first step: DPM-Solver++(1) == DDIM
    (_, s0, l0), (a1, s1, l1) = co[0], co[1]
    x0_prev = x0_pred(x, 0)
    x = (s1 / s0).item() * x - (a1 * (torch.exp(-(l1 - l0)) - 1.0)).item() * x0_prev
    remat = torch.is_grad_enabled()
    for i in range(1, n_steps):
        x, x0_prev = (_checkpoint(step, x, x0_prev, i, use_reentrant=False)
                      if remat else step(x, x0_prev, i))
    return x
