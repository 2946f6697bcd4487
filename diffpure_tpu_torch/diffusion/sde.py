"""VP, sub-VP and VE SDEs and the reverse SDE (port of
diffpure_tpu/diffusion/sde.py).

Time runs over [0, T] with T = 1; ``t`` is a scalar or a (batch,) tensor,
and per-example coefficients broadcast against the state by right-padding
singleton axes. Draws take an explicit ``torch.Generator``. ``SDE`` holds
what the three share (JAX :33-69): the Euler discretisation, the marginal
coefficients and ``reverse``, which gives the reverse-time SDE or its
probability-flow ODE (``ReverseSDE``, JAX :218), the PC and ODE samplers'
drift (diffusion/sampling.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def batch_mul(coef, x: Tensor) -> Tensor:
    """Multiply per-example coefficients (batch,) into a state of any rank."""
    if not torch.is_tensor(coef) or coef.ndim == 0:
        return coef * x
    return coef.reshape(coef.shape + (1,) * (x.ndim - coef.ndim)) * x


def _timestep(sde, t: Tensor) -> Tensor:
    """The discrete index of t, (t (N - 1) / T) truncated toward zero in
    t's float32, as JAX's ``astype(int32)`` truncates (JAX :129)."""
    return (t * (sde.N - 1) / sde.T).to(torch.int32).long()


def _normal_logp(z: Tensor, sigma: float = 1.0) -> Tensor:
    """log N(z; 0, sigma^2 I) per example (JAX :121, :199)."""
    n = math.prod(z.shape[1:])
    return (-n / 2.0 * math.log(2 * math.pi * sigma ** 2)
            - z.reshape(z.shape[0], -1).square().sum(-1) / (2.0 * sigma ** 2))


class SDE:
    """What the forward SDEs share (ref score_sde/sde_lib.py:15-117): each
    defines ``sde``, ``marginal_prob``, ``prior_sampling``, ``prior_logp``,
    its fields ``N`` and ``T``, and may override ``discretize``."""

    def marginal_coeffs(self, t) -> Tuple[Tensor, Tensor]:
        """(mean_coef, std) such that x_t = mean_coef x_0 + std eps."""
        return self.marginal_prob(torch.ones(()), t)

    def discretize(self, x: Tensor, t) -> Tuple[Tensor, Tensor]:
        """Euler discretisation x_{i+1} = x_i + f_i + G_i z: (f, G) =
        (drift dt, diffusion sqrt(dt)) with dt = T / N (ref
        sde_lib.py:58-77)."""
        drift, diffusion = self.sde(x, t)
        dt = self.T / self.N
        return drift * dt, diffusion * math.sqrt(dt)

    def reverse(self, score_fn: Callable[[Tensor, Tensor], Tensor],
                probability_flow: bool = False) -> "ReverseSDE":
        return ReverseSDE(self, score_fn, probability_flow)


@dataclasses.dataclass(frozen=True)
class VPSDE(SDE):
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

    def prior_sampling(self, shape, generator=None, device=None) -> Tensor:
        return torch.randn(shape, generator=generator, device=device)

    def prior_logp(self, z: Tensor) -> Tensor:
        return _normal_logp(z)

    def discretize(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
        """DDPM's discretisation at the truncated index of t: f = (sqrt(1 -
        beta) - 1) x, G = sqrt(beta), beta in x's dtype (ref
        sde_lib.py:160-172)."""
        beta = torch.as_tensor(self.discrete_betas, dtype=x.dtype,
                               device=x.device)[_timestep(self, t)]
        return batch_mul(torch.sqrt(1.0 - beta), x) - x, torch.sqrt(beta)


@dataclasses.dataclass(frozen=True)
class SubVPSDE(SDE):
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

    def prior_logp(self, z: Tensor) -> Tensor:
        return _normal_logp(z)


@dataclasses.dataclass(frozen=True)
class VESDE(SDE):
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

    def prior_logp(self, z: Tensor) -> Tensor:
        return _normal_logp(z, self.sigma_max)

    def discretize(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
        """SMLD's discretisation at the truncated index i of t: f = 0, G =
        sqrt(sigma_i^2 - sigma_{i-1}^2), sigma_{-1} = 0, the scales in x's
        dtype (ref sde_lib.py:247-261)."""
        i = _timestep(self, t)
        sigmas = torch.as_tensor(self.discrete_sigmas, dtype=x.dtype, device=x.device)
        sigma = sigmas[i]
        adjacent = torch.where(i == 0, torch.zeros_like(sigma),
                               sigmas[torch.clamp(i - 1, min=0)])
        return torch.zeros_like(x), torch.sqrt(sigma ** 2 - adjacent ** 2)


@dataclasses.dataclass(frozen=True)
class ReverseSDE:
    """The reverse-time SDE of ``forward``, or its probability-flow ODE:
    drift f - g^2 score (halved for the flow), diffusion g (0 for the flow)
    (ref sde_lib.py:79-117)."""

    forward: SDE
    score_fn: Callable[[Tensor, Tensor], Tensor]
    probability_flow: bool = False

    @property
    def T(self) -> float:
        return self.forward.T

    def sde(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
        drift, diffusion = self.forward.sde(x, t)
        score = self.score_fn(x, t)
        factor = 0.5 if self.probability_flow else 1.0
        drift = drift - batch_mul(diffusion ** 2, score) * factor
        if self.probability_flow:
            diffusion = torch.zeros_like(diffusion)
        return drift, diffusion
