"""Predictor-corrector and probability-flow ODE samplers (port of
diffpure_tpu/diffusion/sampling.py; ref score_sde/sampling.py:34-485).

The predictor and corrector registries, ``get_pc_sampler`` and
``get_ode_sampler``. Python loops over the N steps (JAX's ``lax.scan``).

Draws: a predictor or corrector takes ``draw``, a callable that returns the
next standard normal draw shaped like the state; it draws where JAX draws
(every predictor but ``none`` once a step, each corrector step once), so the
two consume the same draws. A sampler's draws come from a noise source
(``PCNoise`` by default) addressed as JAX's key tree splits them:

- ``prior(sde, shape, device)``: the prior sample (``sde.prior_sampling``,
  JAX's first split);
- ``corrector(i, j, like)``: step i's corrector, its j-th Langevin step
  (JAX: ``k, k1, k2 = split(k, 3)`` at step i, then ``k1, sub = split(k1)``
  per corrector step);
- ``predictor(i, like)``: step i's predictor (JAX's ``k2``).

``PCNoise`` draws them from one explicit ``torch.Generator`` in the order
the loop asks for them: the prior, then at each step the corrector's
n_steps_each draws and the predictor's. Parity tests hand the sampler a
source that serves JAX's own draws by (i, j) instead.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from diffpure_tpu_torch.diffusion.schedules import linspace_f32
from diffpure_tpu_torch.diffusion.sde import SDE, VESDE, VPSDE, _timestep, batch_mul
from diffpure_tpu_torch.solvers.ode import odeint_euler

Tensor = torch.Tensor
ScoreFn = Callable[[Tensor, Tensor], Tensor]
Draw = Callable[[], Tensor]

_PREDICTORS: Dict[str, Callable] = {}
_CORRECTORS: Dict[str, Callable] = {}


def register_predictor(name):
    def deco(fn):
        _PREDICTORS[name] = fn
        return fn
    return deco


def register_corrector(name):
    def deco(fn):
        _CORRECTORS[name] = fn
        return fn
    return deco


def get_predictor(name):
    return _PREDICTORS[name]


def get_corrector(name):
    return _CORRECTORS[name]


# --- predictors (ref sampling.py:177-248) ----------------------------------

@register_predictor("euler_maruyama")
def euler_maruyama_predictor(draw: Draw, sde: SDE, score_fn: ScoreFn, x: Tensor,
                             t: Tensor, probability_flow: bool = False):
    dt = -sde.T / sde.N
    drift, diffusion = sde.reverse(score_fn, probability_flow).sde(x, t)
    z = draw()
    x_mean = x + drift * dt
    return x_mean + batch_mul(diffusion, math.sqrt(-dt) * z), x_mean


@register_predictor("reverse_diffusion")
def reverse_diffusion_predictor(draw: Draw, sde: SDE, score_fn: ScoreFn, x: Tensor,
                                t: Tensor, probability_flow: bool = False):
    f, G = sde.discretize(x, t)
    score = score_fn(x, t)
    rev_f = f - batch_mul(G ** 2, score) * (0.5 if probability_flow else 1.0)
    z = draw()
    x_mean = x - rev_f
    if probability_flow:
        return x_mean, x_mean
    return x_mean + batch_mul(G, z), x_mean


@register_predictor("ancestral_sampling")
def ancestral_sampling_predictor(draw: Draw, sde: SDE, score_fn: ScoreFn, x: Tensor,
                                 t: Tensor, probability_flow: bool = False):
    """DDPM / SMLD ancestral sampling, VP and VE only (ref
    sampling.py:204-248); the tables in float32, as JAX has them."""
    if probability_flow:
        raise ValueError("ancestral sampling has no probability flow")
    i = _timestep(sde, t)
    score = score_fn(x, t)
    z = draw()
    if isinstance(sde, VESDE):
        sigmas = torch.as_tensor(sde.discrete_sigmas, dtype=torch.float32, device=x.device)
        sigma = sigmas[i]
        adjacent = torch.where(i == 0, torch.zeros_like(sigma),
                               sigmas[torch.clamp(i - 1, min=0)])
        x_mean = x + batch_mul(sigma ** 2 - adjacent ** 2, score)
        std = torch.sqrt(adjacent ** 2 * (sigma ** 2 - adjacent ** 2)
                         / torch.clamp(sigma ** 2, min=1e-20))
        return x_mean + batch_mul(std, z), x_mean
    if isinstance(sde, VPSDE):
        beta = torch.as_tensor(sde.discrete_betas, dtype=torch.float32, device=x.device)[i]
        x_mean = batch_mul(1.0 / torch.sqrt(1.0 - beta), x + batch_mul(beta, score))
        return x_mean + batch_mul(torch.sqrt(beta), z), x_mean
    raise NotImplementedError(f"ancestral sampling has no rule for {type(sde).__name__}")


@register_predictor("none")
def none_predictor(draw: Draw, sde: SDE, score_fn: ScoreFn, x: Tensor, t: Tensor,
                   probability_flow: bool = False):
    return x, x


# --- correctors (ref sampling.py:254-330) -----------------------------------

def _alpha(sde: SDE, t: Tensor) -> Tensor:
    """1 - beta at t's index for the VP SDE (float32 table), else 1."""
    if isinstance(sde, VPSDE):
        alphas = torch.as_tensor(1.0 - sde.discrete_betas, dtype=torch.float32,
                                 device=t.device)
        return alphas[_timestep(sde, t)]
    return torch.ones_like(t)


def _norm(v: Tensor) -> Tensor:
    """Per-example L2 norm in JAX's form sqrt(mean(v^2) * size)."""
    return torch.sqrt(v.reshape(v.shape[0], -1).square().mean(-1) * v[0].numel())


@register_corrector("langevin")
def langevin_corrector(draw: Draw, sde: SDE, score_fn: ScoreFn, x: Tensor, t: Tensor,
                       snr: float, n_steps: int):
    alpha = _alpha(sde, t)
    x_mean = x
    for _ in range(n_steps):
        grad = score_fn(x, t)
        noise = draw()
        step_size = (snr * _norm(noise) / (_norm(grad) + 1e-20)) ** 2 * 2 * alpha
        x_mean = x + batch_mul(step_size, grad)
        x = x_mean + batch_mul(torch.sqrt(step_size * 2), noise)
    return x, x_mean


@register_corrector("ald")
def ald_corrector(draw: Draw, sde: SDE, score_fn: ScoreFn, x: Tensor, t: Tensor,
                  snr: float, n_steps: int):
    """Annealed Langevin dynamics, NCSN's sampler (ref sampling.py:286-330):
    step size (snr std(t))^2 2 alpha."""
    alpha = _alpha(sde, t)
    std = sde.marginal_prob(x, t)[1]
    x_mean = x
    for _ in range(n_steps):
        grad = score_fn(x, t)
        noise = draw()
        step_size = (snr * std) ** 2 * 2 * alpha
        x_mean = x + batch_mul(step_size, grad)
        x = x_mean + batch_mul(torch.sqrt(step_size * 2), noise)
    return x, x_mean


@register_corrector("none")
def none_corrector(draw: Draw, sde: SDE, score_fn: ScoreFn, x: Tensor, t: Tensor,
                   snr: float, n_steps: int):
    return x, x


# --- samplers ---------------------------------------------------------------

class PCNoise:
    """Every draw of a sampler from one ``torch.Generator``, in the order
    the loop asks (the module docstring's layout, read sequentially). The
    draws are made on the generator's device and moved to the state's."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator

    def _device(self, like_device):
        return self.generator.device if self.generator is not None else like_device

    def prior(self, sde: SDE, shape, device) -> Tensor:
        return sde.prior_sampling(shape, generator=self.generator,
                                  device=self._device(device)).to(device)

    def _normal(self, like: Tensor) -> Tensor:
        return torch.randn(like.shape, generator=self.generator,
                           device=self._device(like.device),
                           dtype=like.dtype).to(like.device)

    def corrector(self, i: int, j: int, like: Tensor) -> Tensor:
        return self._normal(like)

    def predictor(self, i: int, like: Tensor) -> Tensor:
        return self._normal(like)


def pc_timesteps(sde: SDE, eps: float = 1e-3) -> np.ndarray:
    """The PC loop's grid, ``jnp.linspace(T, eps, N)`` in float32 (JAX
    :186): the discrete indices (t (N - 1) / T, truncated) agree with JAX's
    at every step (tests/test_torch_sampling.py, N = 1000 and 232), the
    times to an ulp of T."""
    return linspace_f32(sde.T, eps, sde.N)


def get_pc_sampler(sde: SDE, shape: Tuple[int, ...], predictor: str = "euler_maruyama",
                   corrector: str = "none", snr: float = 0.16, n_steps_each: int = 1,
                   probability_flow: bool = False, denoise: bool = True,
                   eps: float = 1e-3, device=None):
    """The predictor-corrector loop (ref sampling.py:338-395): at each of
    the N times from T down to eps, the corrector, then the predictor.
    Returns ``sampler(score_fn, generator=None, noise=None) -> (x, nfe)``:
    the last step's mean with ``denoise``, else its sample, and the number
    of score evaluations N (n_steps_each + 1). ``noise`` (a ``PCNoise``
    by default, on ``generator``) gives the draws. ``device`` defaults to
    the card."""
    pred, corr = get_predictor(predictor), get_corrector(corrector)
    device = torch.device("cuda" if device is None else device)

    def sampler(score_fn: ScoreFn, generator: Optional[torch.Generator] = None,
                noise=None):
        noise = PCNoise(generator) if noise is None else noise
        x = noise.prior(sde, shape, device)
        x_mean = x
        for i, t in enumerate(pc_timesteps(sde, eps)):
            vec_t = torch.full((shape[0],), float(t), device=device)
            js = iter(range(n_steps_each))
            x, x_mean = corr(lambda: noise.corrector(i, next(js), x), sde, score_fn, x,
                             vec_t, snr, n_steps_each)
            x, x_mean = pred(lambda: noise.predictor(i, x), sde, score_fn, x, vec_t,
                             probability_flow=probability_flow)
        return (x_mean if denoise else x), sde.N * (n_steps_each + 1)

    return sampler


def get_ode_sampler(sde: SDE, shape: Tuple[int, ...], denoise: bool = False,
                    n_steps: Optional[int] = None, eps: float = 1e-3, device=None):
    """The probability-flow ODE from T to eps in ``n_steps`` (N by default)
    fixed Euler steps (ref sampling.py:398-485; JAX replaces the adaptive
    RK45 with ``odeint_euler``), then with ``denoise`` one Tweedie step at
    eps. Returns ``sampler(score_fn, generator=None, noise=None) -> (x,
    n_steps)``; the one draw is the prior's. ``device`` defaults to the
    card."""
    n = n_steps or sde.N
    device = torch.device("cuda" if device is None else device)

    def sampler(score_fn: ScoreFn, generator: Optional[torch.Generator] = None,
                noise=None):
        noise = PCNoise(generator) if noise is None else noise
        x = noise.prior(sde, shape, device)
        rev = sde.reverse(score_fn, probability_flow=True)
        x = odeint_euler(lambda xx, tt: rev.sde(xx, tt)[0], x, sde.T, eps, n)
        if denoise:
            vec_eps = torch.full((shape[0],), eps, device=device)
            _, G = sde.discretize(x, vec_eps)
            x = x + batch_mul(G ** 2, score_fn(x, vec_eps))
        return x, n

    return sampler
