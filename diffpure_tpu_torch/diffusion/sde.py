"""VP, sub-VP and VE SDE closed forms (port of diffpure_tpu/diffusion/sde.py).

Time runs over [0, T] with T = 1; ``t`` is a scalar or a (batch,) tensor,
and per-example coefficients broadcast against the state by right-padding
singleton axes. Draws take an explicit ``torch.Generator``. The reverse-SDE
object waits for ROADMAP item 18 (the PC samplers are its only user).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def batch_mul(coef, x: Tensor) -> Tensor:
    """Multiply per-example coefficients (batch,) into a state of any rank."""
    if not torch.is_tensor(coef) or coef.ndim == 0:
        return coef * x
    return coef.reshape(coef.shape + (1,) * (x.ndim - coef.ndim)) * x


@dataclasses.dataclass(frozen=True)
class VPSDE:
    """dx = -1/2 beta(t) x dt + sqrt(beta(t)) dW,
    beta(t) = beta_min + t (beta_max - beta_min)
    (ref score_sde/sde_lib.py:120-172)."""

    beta_min: float = 0.1
    beta_max: float = 20.0
    N: int = 1000
    T = 1.0

    def beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def sde(self, x: Tensor, t) -> Tuple[Tensor, Tensor]:
        beta_t = self.beta(t)
        return batch_mul(-0.5 * beta_t, x), torch.sqrt(torch.as_tensor(beta_t))

    def log_mean_coeff(self, t):
        return (-0.25 * t ** 2 * (self.beta_max - self.beta_min)
                - 0.5 * t * self.beta_min)

    def marginal_prob(self, x: Tensor, t) -> Tuple[Tensor, Tensor]:
        """Mean and std of p_t(x(t) | x(0)).

        std = sqrt(-expm1(2 lmc)), not JAX's sqrt(1 - exp(2 lmc)): near
        t = 1e-5 (the end of every reverse solve) the difference cancels in
        float32, so the latter is off by 0.6% there and moves with each
        device's rounding of exp.
        """
        lmc = torch.as_tensor(self.log_mean_coeff(t))
        mean = batch_mul(torch.exp(lmc), x)
        std = torch.sqrt(torch.clamp(-torch.expm1(2.0 * lmc), min=0.0))
        return mean, std

    def alphas_cumprod_cont(self, t):
        """Continuous alpha-bar exp(-1/2 (bmax - bmin) t^2 - bmin t)
        (ref runners/diffpure_sde.py:76)."""
        t = torch.as_tensor(t)
        return torch.exp(-0.5 * (self.beta_max - self.beta_min) * t ** 2
                         - self.beta_min * t)

    @property
    def discrete_betas(self) -> np.ndarray:
        return np.linspace(self.beta_min / self.N, self.beta_max / self.N,
                           self.N, dtype=np.float64)

    @property
    def alphas_cumprod(self) -> np.ndarray:
        """Discrete alpha-bar, float64 as in the reference."""
        return np.cumprod(1.0 - self.discrete_betas)



@dataclasses.dataclass(frozen=True)
class SubVPSDE:
    """Sub-VP SDE (ref score_sde/sde_lib.py:175-212)."""

    beta_min: float = 0.1
    beta_max: float = 20.0
    N: int = 1000
    T = 1.0

    def beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def sde(self, x: Tensor, t) -> Tuple[Tensor, Tensor]:
        t = torch.as_tensor(t)
        beta_t = self.beta(t)
        discount = 1.0 - torch.exp(-2.0 * self.beta_min * t
                                   - (self.beta_max - self.beta_min) * t ** 2)
        return batch_mul(-0.5 * beta_t, x), torch.sqrt(beta_t * discount)

    def marginal_prob(self, x: Tensor, t) -> Tuple[Tensor, Tensor]:
        """Mean and "std" of p_t(x(t) | x(0)). The std is 1 - exp(2 lmc),
        without a square root, as the reference has it; written
        -expm1(2 lmc) for the reason VPSDE.marginal_prob gives."""
        t = torch.as_tensor(t)
        lmc = (-0.25 * t ** 2 * (self.beta_max - self.beta_min)
               - 0.5 * t * self.beta_min)
        return batch_mul(torch.exp(lmc), x), -torch.expm1(2.0 * lmc)

    def prior_sampling(self, shape, generator=None, device=None) -> Tensor:
        return torch.randn(shape, generator=generator, device=device)


@dataclasses.dataclass(frozen=True)
class VESDE:
    """Variance-exploding SDE (ref score_sde/sde_lib.py:215-261)."""

    sigma_min: float = 0.01
    sigma_max: float = 50.0
    N: int = 1000
    T = 1.0

    def sigma(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** torch.as_tensor(t)

    def sde(self, x: Tensor, t) -> Tuple[Tensor, Tensor]:
        diffusion = self.sigma(t) * float(
            np.sqrt(2.0 * (np.log(self.sigma_max) - np.log(self.sigma_min))))
        return torch.zeros_like(x), diffusion

    def marginal_prob(self, x: Tensor, t) -> Tuple[Tensor, Tensor]:
        return x, self.sigma(t)

    @property
    def discrete_sigmas(self) -> np.ndarray:
        """The N noise scales, ascending, float64 as in the reference."""
        return np.exp(np.linspace(np.log(self.sigma_min), np.log(self.sigma_max),
                                  self.N, dtype=np.float64))

    def prior_sampling(self, shape, generator=None, device=None) -> Tensor:
        return torch.randn(shape, generator=generator, device=device) * self.sigma_max
