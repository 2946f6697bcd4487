"""Purification runners (port of diffpure_tpu/purify/runners.py): the reverse
VP-SDE (:91, ``diffusion_type='sde'``), the probability-flow ODE (:144,
``'ode'``), the input-anchored Langevin SDE (:188, ``'ldsde'``), the
DPM-Solver++(2M) purification (:246, ``'dpm'``) and the ``purify``
dispatcher (:391).

Images are NHWC in [-1, 1]. ``model_fn(x, t_labels)`` is the epsilon model:
an ``NCSNpp`` with ``score_type='score_sde'`` (continuous labels t*999), an
``ADMUNet`` with ``score_type='guided_diffusion'`` (integer steps t*N,
runners.py:45-63). Randomness comes from a noise source with the JAX
runner's stream layout: purification round ``it`` draws t* from stream
3*it, the forward-diffusion noise from 3*it + 1 and the Brownian increment
of step i from (3*it + 2, i) (runners.py:114-117, em.py:42); the ODE and
DPM runners draw t* from stream 2*it and the forward noise from 2*it + 1
(runners.py:166, :260); the LDSDE runner does not diffuse and draws step
i's increment from (it, i) (runners.py:214). An integer seed gives
``SeededNoise`` with the runner's layout; tests pass an object with the
same methods that returns the draws JAX made.

Gradients (``cfg.grad_mode``, runners.py:121-138): ``'checkpoint'``
backpropagates exactly through the solver, recomputing each step;
``'adjoint'`` uses the O(1)-memory adjoint of solvers/adjoint.py (the ODE
runner's is Euler-only); ``'reversible'`` integrates with reversible Heun
(solvers/reversible.py; the ODE runner with zero diffusion); ``'none'``
returns a result with no gradient (JAX's ``stop_gradient``; the solver runs
without a graph). The DPM runner, as JAX's, knows only ``'none'`` and
differentiates exactly (checkpointed steps) in every other mode; the LDSDE
runner, as JAX's, knows ``'adjoint'`` and ``'none'`` and runs the
checkpointed path under ``'reversible'``.
"""
from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from diffpure_tpu_torch.diffusion.score import get_score_fn, \
    make_guided_score_fn
from diffpure_tpu_torch.diffusion.sde import VPSDE, batch_mul
from diffpure_tpu_torch.purify.config import PurifyConfig
from diffpure_tpu_torch.solvers.adjoint import odeint_euler_adjoint, sdeint_em_adjoint
from diffpure_tpu_torch.solvers.dpm import dpm_solver_pp_2m
from diffpure_tpu_torch.solvers.em import brownian_increment, sdeint_em
from diffpure_tpu_torch.solvers.ode import odeint_euler, odeint_heun
from diffpure_tpu_torch.solvers.reversible import odeint_reversible_heun, \
    sdeint_reversible_heun
from diffpure_tpu_torch.utils.prng import fold_in, generator

Tensor = torch.Tensor
ModelFn = Callable[[Tensor, Tensor], Tensor]


class SeededNoise:
    """Counter-based noise from one integer seed (torch generators on the
    data's device; not JAX's bits). Round ``it`` draws from streams
    ``streams * it + j``: 3 a round for the SDE runner, 2 for the ODE and
    DPM ones; with ``streams=1`` (the LDSDE runner) round ``it``'s Brownian
    increments come from stream ``it``."""

    def __init__(self, seed: int, streams: int = 3):
        self.seed = int(seed)
        self.streams = streams

    def t_offset(self, it: int, t_delta: int) -> int:
        g = generator(self.seed, self.streams * it)
        return int(torch.randint(-t_delta, t_delta, (), generator=g))

    def forward_eps(self, it: int, shape, like: Tensor) -> Tensor:
        g = generator(self.seed, self.streams * it + 1, device=like.device)
        return torch.randn(shape, generator=g, device=like.device, dtype=like.dtype)

    def brownian(self, it: int, i: int, like: Tensor, dt: float) -> Tensor:
        if self.streams == 2:
            raise ValueError("a two-stream (ODE, DPM) noise source has no Brownian stream")
        stream = it if self.streams == 1 else self.streams * it + 2
        return brownian_increment(fold_in(self.seed, stream), i, like, dt)


Noise = Union[int, SeededNoise]


def as_noise(noise, streams: int = 3) -> SeededNoise:
    if isinstance(noise, (int, np.integer)):
        return SeededNoise(noise, streams)
    return noise


def _forward_diffuse(x0: Tensor, noise, it: int, cfg: PurifyConfig,
                     total_noise_levels: int) -> Tensor:
    """One-shot forward diffusion to step t* with the discrete alpha-bar,
    float64 table cast to float32 (ref diffpure_sde.py:217-223). With
    fix_rand one noise tile is shared across the batch."""
    a = VPSDE(cfg.beta_min, cfg.beta_max, cfg.N).alphas_cumprod.astype(np.float32)
    if cfg.fix_rand:
        e = noise.forward_eps(it, (1,) + tuple(x0.shape[1:]), x0)
        e = e.expand_as(x0)
    else:
        e = noise.forward_eps(it, tuple(x0.shape), x0)
    abar = torch.tensor(a[total_noise_levels - 1], device=x0.device)
    return x0 * torch.sqrt(abar) + e * torch.sqrt(1.0 - abar)


def _sample_t(noise, it: int, cfg: PurifyConfig) -> int:
    """t*, or with rand_t t* + U{-t_delta, t_delta - 1}
    (ref diffpure_sde.py:219-221)."""
    if not cfg.rand_t:
        return cfg.t
    return cfg.t + noise.t_offset(it, cfg.t_delta)


def _make_score_fn(model_fn: ModelFn, cfg: PurifyConfig, sde: VPSDE):
    """score(x, t) from the epsilon model, by ``cfg.score_type``
    (runners.py:45-63)."""
    if cfg.score_type == "guided_diffusion":
        return make_guided_score_fn(model_fn, sde, cfg.learn_sigma)
    if cfg.score_type == "score_sde":
        return get_score_fn(sde, model_fn, continuous=True)
    raise NotImplementedError(f"unknown score_type {cfg.score_type!r}")


def _check_grad_mode(cfg: PurifyConfig) -> None:
    if cfg.grad_mode not in ("checkpoint", "adjoint", "reversible", "none"):
        raise ValueError(f"unknown grad_mode {cfg.grad_mode!r}")


def _params(model_fn) -> tuple:
    """The model's parameters that require grad: the adjoint and reversible
    solvers' ``params`` (frozen models give none)."""
    return (tuple(p for p in model_fn.parameters() if p.requires_grad)
            if isinstance(model_fn, torch.nn.Module) else ())


def purify_sde(model_fn: ModelFn, x: Tensor, noise: Noise,
               cfg: PurifyConfig) -> Tensor:
    """Integrate the reverse VP-SDE in flipped time t' = 1 - s from
    1 - t*/1000 to 1 - 1e-5 with Euler-Maruyama:
    drift'(x, t') = -[f(x, s) - g(s)^2 score(x, s)], diffusion' = g(s)."""
    _check_grad_mode(cfg)
    noise = as_noise(noise)
    sde = VPSDE(beta_min=cfg.beta_min, beta_max=cfg.beta_max, N=cfg.N)
    score_fn = _make_score_fn(model_fn, cfg, sde)

    def drift(xx: Tensor, t_flip: Tensor) -> Tensor:
        s = 1.0 - t_flip
        f, g = sde.sde(xx, s)
        return -(f - batch_mul(g ** 2, score_fn(xx, s)))

    def diffusion(t_flip: Tensor) -> Tensor:
        return torch.sqrt(sde.beta(1.0 - t_flip))

    n_steps = cfg.solver_steps()
    xs = []
    x0 = x
    for it in range(cfg.sample_step):
        t_star = _sample_t(noise, it, cfg)
        xt = _forward_diffuse(x0, noise, it, cfg, t_star)
        t0 = 1.0 - t_star / 1000.0
        t1 = 1.0 - cfg.epsilon_dt1
        dt = (t1 - t0) / n_steps
        args = (drift, diffusion, xt, t0, t1, n_steps,
                lambda i, it=it, xt=xt: noise.brownian(it, i, xt, dt))
        if cfg.grad_mode == "adjoint":
            x0 = sdeint_em_adjoint(*args, params=_params(model_fn))
        elif cfg.grad_mode == "reversible":
            # reversible Heun on JAX's float32 grid; the increment's scale
            # is sqrt(|dt|) of that grid's dt (JAX reversible.py:79)
            dt32 = float(np.float32((np.float32(t1) - np.float32(t0)) / np.float32(n_steps)))
            x0 = sdeint_reversible_heun(
                drift, diffusion, xt, t0, t1, n_steps,
                lambda i, it=it, xt=xt: noise.brownian(it, i, xt, dt32),
                params=_params(model_fn))
        elif cfg.grad_mode == "none":
            with torch.no_grad():
                x0 = sdeint_em(*args)
        else:
            x0 = sdeint_em(*args, checkpoint=True)
        xs.append(x0)
    return torch.cat(xs, dim=0)


def _make_eps_fn(model_fn: ModelFn, cfg: PurifyConfig):
    """epsilon(x, t) from the model, by ``cfg.score_type`` (runners.py:230-243):
    guided-diffusion takes integer steps t*N (float32, truncated), score_sde
    continuous labels t*999."""
    if cfg.score_type == "guided_diffusion":
        def eps_fn(x: Tensor, t: Tensor) -> Tensor:
            out = model_fn(x, (t.float() * cfg.N).to(torch.int32))
            return out[..., :out.shape[-1] // 2] if cfg.learn_sigma else out
        return eps_fn
    if cfg.score_type == "score_sde":
        return lambda x, t: model_fn(x, t * 999)
    raise NotImplementedError(f"unknown score_type {cfg.score_type!r}")


def purify_dpm(model_fn: ModelFn, x: Tensor, noise: Noise,
               cfg: PurifyConfig) -> Tensor:
    """Forward-diffuse to t*, then DPM-Solver++(2M) down to t = 1e-5 in
    ``cfg.solver_steps()`` score evaluations (runners.py:246)."""
    noise = as_noise(noise, streams=2)
    sde = VPSDE(beta_min=cfg.beta_min, beta_max=cfg.beta_max, N=cfg.N)
    eps_fn = _make_eps_fn(model_fn, cfg)
    xs = []
    x0 = x
    for it in range(cfg.sample_step):
        t_star = _sample_t(noise, it, cfg)
        xt = _forward_diffuse(x0, noise, it, cfg, t_star)
        args = (eps_fn, xt, t_star / 1000.0, cfg.epsilon_dt1, cfg.solver_steps(), sde)
        if cfg.grad_mode == "none":
            with torch.no_grad():
                x0 = dpm_solver_pp_2m(*args)
        else:
            x0 = dpm_solver_pp_2m(*args)
        xs.append(x0)
    return torch.cat(xs, dim=0)


def purify_ode(model_fn: ModelFn, x: Tensor, noise: Noise,
               cfg: PurifyConfig) -> Tensor:
    """Probability-flow ODE purification (runners.py:144; ref
    diffpure_ode.py): forward-diffuse to t*, then integrate
    dx/dt = f(x, t) - 1/2 g(t)^2 score(x, t) from t*/1000 down to 1e-5 (time
    not flipped) in round(t / 1000 / step_size) steps of ``cfg.t`` (JAX
    counts the steps from ``cfg.t``, also under rand_t)."""
    _check_grad_mode(cfg)
    noise = as_noise(noise, streams=2)
    sde = VPSDE(beta_min=cfg.beta_min, beta_max=cfg.beta_max, N=cfg.N)
    score_fn = _make_score_fn(model_fn, cfg, sde)

    def ode_fn(xx: Tensor, t: Tensor) -> Tensor:
        f, g = sde.sde(xx, t)
        return f - 0.5 * batch_mul(g ** 2, score_fn(xx, t))

    n_steps = max(int(round(cfg.t / 1000.0 / cfg.step_size)), 1)
    xs = []
    x0 = x
    for it in range(cfg.sample_step):
        t_star = _sample_t(noise, it, cfg)
        xt = _forward_diffuse(x0, noise, it, cfg, t_star)
        args = (ode_fn, xt, t_star / 1000.0, cfg.epsilon_dt1, n_steps)
        if cfg.grad_mode == "adjoint":
            if cfg.ode_method != "euler":
                raise ValueError("the ODE adjoint is Euler-only (ode_method='euler')")
            x0 = odeint_euler_adjoint(*args, params=_params(model_fn))
        elif cfg.grad_mode == "reversible":
            # reversible Heun with zero diffusion (JAX's noise, times 0)
            x0 = odeint_reversible_heun(*args, params=_params(model_fn))
        else:
            solver = odeint_heun if cfg.ode_method == "heun" else odeint_euler
            if cfg.grad_mode == "none":
                with torch.no_grad():
                    x0 = solver(*args)
            else:
                x0 = solver(*args, checkpoint=True)
        xs.append(x0)
    return torch.cat(xs, dim=0)


def purify_ldsde(model_fn: ModelFn, x: Tensor, noise: Noise,
                 cfg: PurifyConfig) -> Tensor:
    """Langevin-dynamics SDE purification anchored to the input
    (runners.py:188; ref diffpure_ldsde.py:50-130): no forward diffusion;
    drift -1/2 lambda (-score(x, t=ldsde_t) + (x - x_init) / sigma2),
    diffusion sqrt(lambda) eta, round((t1 - t0) / ldsde_dt) Euler-Maruyama
    steps from 1 - t*/1000 to 1 - 1e-5. Under ``'adjoint'`` the drift's
    x_init is a constant: the gradient reaches the input through the
    solve's start only, as the reference's sdeint_adjoint gives it (x_init
    is no adjoint parameter there; JAX's adjoint raises on it, ROADMAP
    Queue 3)."""
    _check_grad_mode(cfg)
    noise = as_noise(noise, streams=1)
    sde = VPSDE(beta_min=cfg.beta_min, beta_max=cfg.beta_max, N=cfg.N)
    score_fn = _make_score_fn(model_fn, cfg, sde)
    x_init = x.detach() if cfg.grad_mode == "adjoint" else x

    def drift(xx: Tensor, t_unused: Tensor) -> Tensor:
        t = torch.full((xx.shape[0],), cfg.ldsde_t, dtype=xx.dtype, device=xx.device)
        return -0.5 * cfg.lambda_ld * (-score_fn(xx, t) + (xx - x_init) / cfg.sigma2)

    def diffusion(t: Tensor) -> Tensor:
        return torch.full_like(t, np.sqrt(cfg.lambda_ld) * cfg.eta)

    t0 = 1.0 - cfg.t / 1000.0
    t1 = 1.0 - cfg.epsilon_dt1
    n_steps = max(int(round((t1 - t0) / cfg.ldsde_dt)), 1)
    dt = (t1 - t0) / n_steps
    xs = []
    x0 = x
    for it in range(cfg.sample_step):
        args = (drift, diffusion, x0, t0, t1, n_steps,
                lambda i, it=it, x0=x0: noise.brownian(it, i, x0, dt))
        if cfg.grad_mode == "adjoint":
            x0 = sdeint_em_adjoint(*args, params=_params(model_fn))
        elif cfg.grad_mode == "none":
            with torch.no_grad():
                x0 = sdeint_em(*args)
        else:  # 'checkpoint', and 'reversible' as JAX runs it
            x0 = sdeint_em(*args, checkpoint=True)
        xs.append(x0)
    return torch.cat(xs, dim=0)


_LATER = {"ddpm": "Slice 3 item 15", "celebahq-ddpm": "Slice 4 item 17"}
_RUNNERS = {"sde": purify_sde, "ode": purify_ode, "ldsde": purify_ldsde,
            "dpm": purify_dpm}


def purify(model_fn: ModelFn, x: Tensor, noise: Noise,
           cfg: PurifyConfig) -> Tensor:
    """Runner dispatch (ref eval_sde_adv.py:44-55)."""
    if cfg.diffusion_type in _RUNNERS:
        return _RUNNERS[cfg.diffusion_type](model_fn, x, noise, cfg)
    if cfg.diffusion_type in _LATER:
        raise NotImplementedError(
            f"diffusion_type={cfg.diffusion_type!r} waits for ROADMAP "
            f"{_LATER[cfg.diffusion_type]}")
    raise NotImplementedError(f"unknown diffusion type {cfg.diffusion_type}")
