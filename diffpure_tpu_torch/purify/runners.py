"""Purification runners (port of diffpure_tpu/purify/runners.py): the reverse
VP-SDE (:91, ``diffusion_type='sde'``), the probability-flow ODE (:144,
``'ode'``), the input-anchored Langevin SDE (:188, ``'ldsde'``), the
DPM-Solver++(2M) purification (:246, ``'dpm'``), the discrete guided
DDPM / DDIM loop (:285, ``'ddpm'``), the CelebA-HQ DDPM loop (:342,
``'celebahq-ddpm'``) and the ``purify`` dispatcher (:391).

Images are NHWC in [-1, 1]. ``model_fn(x, t_labels)`` is the epsilon model:
an ``NCSNpp`` with ``score_type='score_sde'`` (continuous labels t*999), an
``ADMUNet`` with ``score_type='guided_diffusion'`` (integer steps t*N,
runners.py:45-63). Randomness comes from a noise source with the JAX
runner's stream layout: purification round ``it`` draws t* from stream
3*it, the forward-diffusion noise from 3*it + 1 and the Brownian increment
of step i from (3*it + 2, i) (runners.py:114-117, em.py:42); the ODE and
DPM runners draw t* from stream 2*it and the forward noise from 2*it + 1
(runners.py:166, :260); the LDSDE runner does not diffuse and draws step
i's increment from (it, i) (runners.py:214). The two discrete loops draw
round ``it``'s forward noise from stream 2*it and step i's noise from
(2*it + 1, i), where JAX splits the key of stream 2*it + 1 once a step
(runners.py:313-339): ``DiscreteNoise``. An integer seed gives
``SeededNoise`` (``DiscreteNoise``) with the runner's layout; tests pass an
object with the same methods that returns the draws JAX made.

Gradients (``cfg.grad_mode``, runners.py:121-138): ``'checkpoint'``
backpropagates exactly through the solver, recomputing each step;
``'adjoint'`` uses the O(1)-memory adjoint of solvers/adjoint.py (the ODE
runner's is Euler-only); ``'reversible'`` integrates with reversible Heun
(solvers/reversible.py; the ODE runner with zero diffusion); ``'none'``
returns a result with no gradient (JAX's ``stop_gradient``; the solver runs
without a graph). The DPM runner, as JAX's, knows only ``'none'`` and
differentiates exactly (checkpointed steps) in every other mode; the LDSDE
runner, as JAX's, knows ``'adjoint'`` and ``'none'`` and runs the
checkpointed path under ``'reversible'``; the discrete loops, as JAX's
``jax.checkpoint(step)`` scans, run each step checkpointed in every mode but
``'none'``.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from diffpure_tpu_torch.diffusion.discrete import ModelMeanType, ModelVarType, \
    SpacedDiffusion, _gather, _to32
from diffpure_tpu_torch.diffusion.schedules import get_named_beta_schedule, \
    linear_beta_schedule
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
from diffpure_tpu_torch.utils.profiling import record_nfe

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


class DiscreteNoise:
    """The discrete loops' noise from one integer seed (torch generators on
    the data's device): round ``it``'s forward noise from stream 2*it, step
    i's from (2*it + 1, i)."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def forward_eps(self, it: int, shape, like: Tensor) -> Tensor:
        g = generator(self.seed, 2 * it, device=like.device)
        return torch.randn(shape, generator=g, device=like.device, dtype=like.dtype)

    def step_eps(self, it: int, i: int, like: Tensor) -> Tensor:
        g = generator(self.seed, 2 * it + 1, i, device=like.device)
        return torch.randn(like.shape, generator=g, device=like.device, dtype=like.dtype)


Noise = Union[int, SeededNoise, DiscreteNoise]


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


def make_imagenet_diffusion(timestep_respacing: str = "1000") -> SpacedDiffusion:
    """The guided-diffusion process of the ImageNet purification, with
    rescaled timesteps (JAX :274; ref configs/imagenet.yml +
    script_util.py:394-443)."""
    betas = get_named_beta_schedule("linear", 1000)
    return SpacedDiffusion.from_original(
        betas, timestep_respacing or "1000", model_mean_type=ModelMeanType.EPSILON,
        model_var_type=ModelVarType.LEARNED_RANGE, rescale_timesteps=True)


def _discrete_loop(step, x0: Tensor, noise, it: int, t_star: int,
                   cfg: PurifyConfig) -> Tensor:
    """Steps t* - 1 ... 0 of a discrete loop from x0, each step
    ``step(x, t, z)`` with its draw z; checkpointed and differentiable under
    any grad_mode but 'none' (JAX's ``jax.checkpoint(step)`` scan), without
    a graph under 'none'."""
    if cfg.grad_mode == "none" and torch.is_grad_enabled():
        with torch.no_grad():
            return _discrete_loop(step, x0, noise, it, t_star, cfg)
    remat = torch.is_grad_enabled()
    xc = x0
    for i in range(t_star):
        t = torch.full((x0.shape[0],), t_star - 1 - i, dtype=torch.int32, device=x0.device)
        z = noise.step_eps(it, i, xc)
        xc = _checkpoint(step, xc, t, z, use_reentrant=False) if remat else step(xc, t, z)
    return xc


def _discrete_forward(x0: Tensor, noise, it: int, abar: np.ndarray, t_star: int) -> Tensor:
    """x0 diffused to step t*: the float32 alpha-bar at t* - 1 and its
    square roots in float32 (not through ``_extract``; JAX :309, :317)."""
    e = noise.forward_eps(it, tuple(x0.shape), x0)
    a_t = torch.tensor(np.asarray(abar, np.float32)[t_star - 1], device=x0.device)
    return x0 * torch.sqrt(a_t) + e * torch.sqrt(1.0 - a_t)


def as_discrete_noise(noise):
    if isinstance(noise, (int, np.integer)):
        return DiscreteNoise(noise)
    return noise


def purify_guided_ddpm(model_fn: ModelFn, x: Tensor, noise: Noise, cfg: PurifyConfig,
                       diffusion: Optional[SpacedDiffusion] = None,
                       use_ddim: bool = False) -> Tensor:
    """Discrete guided-diffusion purification (ImageNet; JAX :285, ref
    diffpure_guided.py): forward-diffuse to step ``cfg.t`` of ``diffusion``
    (default: the 1000-step linear process with the learned range), then
    ``cfg.t`` ancestral steps (``use_ddim``: deterministic DDIM steps, eta
    0) with the denoised x0 clipped to [-1, 1]. A respaced ``diffusion``
    (``make_imagenet_diffusion("ddim50")``) takes ``cfg.t`` in respaced
    indices; its wrapped model maps them back to the original steps (ref
    respace.py:124-135). The model sees float32 timesteps t * 1000 / N."""
    noise = as_discrete_noise(noise)
    if diffusion is None:
        diffusion = make_imagenet_diffusion()
    sampler = diffusion.ddim_sample if use_ddim else diffusion.p_sample

    def step(xc: Tensor, t: Tensor, z: Tensor) -> Tensor:
        return sampler(model_fn, xc, t, clip_denoised=True, noise=z)["sample"]

    xs = []
    x0 = x
    for it in range(cfg.sample_step):
        xt = _discrete_forward(x0, noise, it, diffusion.alphas_cumprod, cfg.t)
        record_nfe("guided_ddpm", int(cfg.t))
        x0 = _discrete_loop(step, xt, noise, it, cfg.t, cfg)
        xs.append(x0)
    return torch.cat(xs, dim=0)


def purify_celebahq_ddpm(model_fn: ModelFn, x: Tensor, noise: Noise,
                         cfg: PurifyConfig) -> Tensor:
    """CelebA-HQ DDPM purification with the reference's hand-written
    posterior step (JAX :342; ref diffpure_ddpm.py:37-54,99-142): the
    linear betas (1e-4 to 2e-2) of ``cfg.N`` steps, float64 tables cast to
    float32 once, the fixed-small log-variance log(max(var, 1e-20)), no x0
    clipping, and no noise at t = 0. The model takes integer steps."""
    noise = as_discrete_noise(noise)
    betas64 = linear_beta_schedule(cfg.N, 1e-4, 2e-2)
    alphas = 1.0 - betas64
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = betas64 * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    logvar = np.log(np.maximum(posterior_variance, 1e-20))
    weighted_score = betas64 / np.sqrt(1.0 - alphas_cumprod)
    recip_sqrt_alphas = _to32(1.0 / np.sqrt(alphas), x.device)
    weighted_score = _to32(weighted_score, x.device)
    logvar = _to32(logvar, x.device)

    def step(xc: Tensor, t: Tensor, z: Tensor) -> Tensor:
        eps = model_fn(xc, t)
        mean = (_gather(recip_sqrt_alphas, t, xc.shape)
                * (xc - _gather(weighted_score, t, xc.shape) * eps))
        lv = _gather(logvar, t, xc.shape)
        mask = (t != 0).to(xc.dtype).reshape(t.shape + (1,) * (xc.ndim - 1))
        return mean + mask * torch.exp(0.5 * lv) * z

    xs = []
    x0 = x
    for it in range(cfg.sample_step):
        xt = _discrete_forward(x0, noise, it, alphas_cumprod, cfg.t)
        record_nfe("celebahq_ddpm", int(cfg.t))
        x0 = _discrete_loop(step, xt, noise, it, cfg.t, cfg)
        xs.append(x0)
    return torch.cat(xs, dim=0)


_RUNNERS = {"sde": purify_sde, "ode": purify_ode, "ldsde": purify_ldsde,
            "dpm": purify_dpm, "ddpm": purify_guided_ddpm,
            "celebahq-ddpm": purify_celebahq_ddpm}


def purify(model_fn: ModelFn, x: Tensor, noise: Noise, cfg: PurifyConfig,
           **kwargs) -> Tensor:
    """Runner dispatch (ref eval_sde_adv.py:44-55); ``kwargs`` go to the
    runner (``diffusion``, ``use_ddim`` for 'ddpm'), as in JAX."""
    if cfg.diffusion_type in _RUNNERS:
        return _RUNNERS[cfg.diffusion_type](model_fn, x, noise, cfg, **kwargs)
    raise NotImplementedError(f"unknown diffusion type {cfg.diffusion_type}")
