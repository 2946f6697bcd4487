"""Discrete-time Gaussian diffusion (DDPM) with respacing (port of
diffpure_tpu/diffusion/discrete.py, the whole module; ref
guided_diffusion/gaussian_diffusion.py:126-916 and respace.py:71-136).

Where to cast, as JAX does: every schedule table is float64 numpy, computed
from the betas (square roots and logs in float64), and cast to float32 at
the gather (``_extract``; a process keeps each float32 copy per device).
Images are NHWC; the channel splits the reference makes on dim 1 are made
on the last axis.

Randomness: the samplers take their Gaussian draw as a tensor (``noise``)
or draw it from a ``torch.Generator``; JAX passes a key. The loops take a
callable ``step_noise(i, like)`` for step i's draw, so that tests inject
the draws JAX made from its split keys.
"""
from __future__ import annotations

import enum
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from diffpure_tpu_torch.diffusion.schedules import space_timesteps

Tensor = torch.Tensor


class ModelMeanType(enum.Enum):
    """What the model predicts (ref gaussian_diffusion.py:73-80)."""
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    """Output variance handling (ref gaussian_diffusion.py:83-95)."""
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


def _to32(arr: np.ndarray, device) -> Tensor:
    """A float64 schedule table cast to float32 on ``device``."""
    return torch.from_numpy(np.asarray(arr, np.float64).astype(np.float32)).to(device)


def _gather(table: Tensor, t: Tensor, broadcast_shape) -> Tensor:
    """``table`` at timesteps t, with singleton axes up to the image's rank."""
    vals = table[t.long()]
    return vals.reshape(vals.shape + (1,) * (len(broadcast_shape) - vals.ndim))


def _extract(arr: np.ndarray, t: Tensor, broadcast_shape) -> Tensor:
    """The float32 schedule constants at timesteps t, with singleton axes up
    to the image's rank (JAX :42; ref gaussian_diffusion.py:903-916)."""
    return _gather(_to32(arr, t.device), t, broadcast_shape)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal Gaussians (ref guided_diffusion/losses.py:23-49)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: Tensor) -> Tensor:
    return 0.5 * (1.0 + torch.tanh(float(np.sqrt(2.0 / np.pi)) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x: Tensor, *, means: Tensor,
                                        log_scales: Tensor) -> Tensor:
    """Log-likelihood of a discretised Gaussian on [-1, 1] 8-bit images
    (ref guided_diffusion/losses.py:52-85)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    cdf_delta = cdf_plus - cdf_min
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   torch.log(cdf_delta.clamp(min=1e-12))))


def _nonzero_mask(t: Tensor, x: Tensor) -> Tensor:
    return (t != 0).to(x.dtype).reshape(t.shape + (1,) * (x.ndim - t.ndim))


def _draw(noise: Optional[Tensor], x: Tensor,
          generator: Optional[torch.Generator]) -> Tensor:
    if noise is not None:
        return noise
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


class GaussianDiffusion:
    """A discrete diffusion process over a fixed beta schedule; every table
    is float64 numpy, computed once from the betas (ref
    gaussian_diffusion.py:140-177), and cast to float32 once per device at
    its first gather."""

    def __init__(self, betas: np.ndarray,
                 model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
                 model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
                 rescale_timesteps: bool = False):
        betas = np.asarray(betas, dtype=np.float64)
        assert (betas > 0).all() and (betas <= 1).all()
        self.betas = betas
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.rescale_timesteps = rescale_timesteps
        self.num_timesteps = len(betas)

        ac = np.cumprod(1.0 - betas)
        self.alphas_cumprod = ac
        self.alphas_cumprod_prev = np.append(1.0, ac[:-1])
        self.alphas_cumprod_next = np.append(ac[1:], 0.0)
        self.sqrt_alphas_cumprod = np.sqrt(ac)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - ac)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / ac)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / ac - 1.0)
        pv = betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - ac)
        self.posterior_variance = pv
        self.posterior_log_variance_clipped = np.log(np.append(pv[1], pv[1:]))
        self.posterior_mean_coef1 = betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - ac)
        self.posterior_mean_coef2 = ((1.0 - self.alphas_cumprod_prev) * np.sqrt(1.0 - betas)
                                     / (1.0 - ac))
        # the tables the methods derive from these, in float64 as JAX does
        large = np.append(pv[1], betas[1:])
        self._derived = {
            "one_minus_alphas_cumprod": 1.0 - ac,
            "log_one_minus_alphas_cumprod": np.log(1.0 - ac),
            "log_betas": np.log(betas),
            "recip_posterior_mean_coef1": 1.0 / self.posterior_mean_coef1,
            "posterior_coef2_over_coef1": self.posterior_mean_coef2 / self.posterior_mean_coef1,
            "fixed_large_variance": large,
            "fixed_large_log_variance": np.log(large),
        }
        self._tables32 = {}

    def _at(self, name: str, t: Tensor, broadcast_shape) -> Tensor:
        """Table ``name`` at timesteps t, cast to float32 at the gather (JAX's
        ``_extract``); the float32 copy is kept per device."""
        key = (name, t.device)
        table = self._tables32.get(key)
        if table is None:
            arr = self._derived[name] if name in self._derived else getattr(self, name)
            table = self._tables32[key] = _to32(arr, t.device)
        return _gather(table, t, broadcast_shape)

    # ---- forward process ------------------------------------------------------

    def q_mean_variance(self, x_start: Tensor, t: Tensor):
        mean = self._at("sqrt_alphas_cumprod", t, x_start.shape) * x_start
        variance = self._at("one_minus_alphas_cumprod", t, x_start.shape)
        log_variance = self._at("log_one_minus_alphas_cumprod", t, x_start.shape)
        return mean, variance, log_variance

    def q_sample(self, x_start: Tensor, t: Tensor, noise: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tensor:
        """Diffuse x_start to step t (ref gaussian_diffusion.py:196-218)."""
        noise = _draw(noise, x_start, generator)
        return (self._at("sqrt_alphas_cumprod", t, x_start.shape) * x_start
                + self._at("sqrt_one_minus_alphas_cumprod", t, x_start.shape) * noise)

    def q_posterior_mean_variance(self, x_start: Tensor, x_t: Tensor, t: Tensor):
        """q(x_{t-1} | x_t, x_0) (ref gaussian_diffusion.py:220-238)."""
        posterior_mean = (self._at("posterior_mean_coef1", t, x_t.shape) * x_start
                          + self._at("posterior_mean_coef2", t, x_t.shape) * x_t)
        posterior_variance = self._at("posterior_variance", t, x_t.shape)
        posterior_log_variance = self._at("posterior_log_variance_clipped", t, x_t.shape)
        return posterior_mean, posterior_variance, posterior_log_variance

    # ---- model wrappers -------------------------------------------------------

    def _scale_timesteps(self, t: Tensor) -> Tensor:
        """ref gaussian_diffusion.py:359-362."""
        if self.rescale_timesteps:
            return t.float() * (1000.0 / self.num_timesteps)
        return t

    def _predict_xstart_from_eps(self, x_t, t, eps):
        return (self._at("sqrt_recip_alphas_cumprod", t, x_t.shape) * x_t
                - self._at("sqrt_recipm1_alphas_cumprod", t, x_t.shape) * eps)

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        return (self._at("recip_posterior_mean_coef1", t, x_t.shape) * xprev
                - self._at("posterior_coef2_over_coef1", t, x_t.shape) * x_t)

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        return ((self._at("sqrt_recip_alphas_cumprod", t, x_t.shape) * x_t
                 - pred_xstart)
                / self._at("sqrt_recipm1_alphas_cumprod", t, x_t.shape))

    def p_mean_variance(self, model_fn: Callable, x: Tensor, t: Tensor,
                        clip_denoised: bool = True,
                        denoised_fn: Optional[Callable] = None,
                        model_kwargs=None) -> dict:
        """p(x_{t-1} | x_t) parameters (ref gaussian_diffusion.py:240-350).
        model_fn(x, t_scaled, **kwargs) -> NHWC output; with LEARNED(_RANGE)
        variance its channels hold [model_mean, model_var]. With a bf16
        output the split halves stay bf16 and meet the float32 tables, where
        both packages promote to float32."""
        model_output = model_fn(x, self._scale_timesteps(t), **(model_kwargs or {}))

        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = model_output.chunk(2, dim=-1)
            if self.model_var_type == ModelVarType.LEARNED:
                model_log_variance = model_var_values
            else:
                min_log = self._at("posterior_log_variance_clipped", t, x.shape)
                max_log = self._at("log_betas", t, x.shape)
                frac = (model_var_values + 1.0) / 2.0
                model_log_variance = frac * max_log + (1.0 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif self.model_var_type == ModelVarType.FIXED_LARGE:
            model_variance = self._at("fixed_large_variance", t, x.shape)
            model_log_variance = self._at("fixed_large_log_variance", t, x.shape)
        else:  # FIXED_SMALL
            model_variance = self._at("posterior_variance", t, x.shape)
            model_log_variance = self._at("posterior_log_variance_clipped", t, x.shape)

        def process_xstart(x0):
            if denoised_fn is not None:
                x0 = denoised_fn(x0)
            if clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            return x0

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(self._predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        elif self.model_mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(model_output)
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        else:  # EPSILON
            pred_xstart = process_xstart(self._predict_xstart_from_eps(x, t, model_output))
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)

        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance, "pred_xstart": pred_xstart}

    # ---- classifier guidance (ref gaussian_diffusion.py:352-400) ----------------

    def condition_mean(self, cond_fn: Callable, p_mean_var: dict, x: Tensor,
                       t: Tensor, model_kwargs=None) -> Tensor:
        """Shift the posterior mean by variance * grad log p(y|x)
        (ref gaussian_diffusion.py:352-377)."""
        gradient = cond_fn(x, self._scale_timesteps(t), **(model_kwargs or {}))
        return p_mean_var["mean"].float() + p_mean_var["variance"] * gradient.float()

    def condition_score(self, cond_fn: Callable, p_mean_var: dict, x: Tensor,
                        t: Tensor, model_kwargs=None) -> dict:
        """Song et al.'s score conditioning for DDIM
        (ref gaussian_diffusion.py:379-400)."""
        alpha_bar = self._at("alphas_cumprod", t, x.shape)
        eps = self._predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(
            x, self._scale_timesteps(t), **(model_kwargs or {}))
        out = dict(p_mean_var)
        out["pred_xstart"] = self._predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x, t)
        return out

    # ---- samplers -------------------------------------------------------------

    def p_sample(self, model_fn: Callable, x: Tensor, t: Tensor,
                 clip_denoised: bool = True, denoised_fn=None, cond_fn=None,
                 model_kwargs=None, noise: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> dict:
        """One ancestral step (ref gaussian_diffusion.py:403-447); ``noise``
        is its Gaussian draw (else drawn from ``generator``)."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, model_kwargs=model_kwargs)
        noise = _draw(noise, x, generator)
        mean = out["mean"]
        if cond_fn is not None:
            mean = self.condition_mean(cond_fn, out, x, t, model_kwargs=model_kwargs)
        sample = mean + _nonzero_mask(t, x) * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(self, model_fn: Callable, x: Tensor, t: Tensor,
                    clip_denoised: bool = True, denoised_fn=None, cond_fn=None,
                    model_kwargs=None, eta: float = 0.0, noise: Optional[Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> dict:
        """One DDIM step (ref gaussian_diffusion.py:545-612)."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, model_kwargs=model_kwargs)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs=model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = self._at("alphas_cumprod", t, x.shape)
        alpha_bar_prev = self._at("alphas_cumprod_prev", t, x.shape)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        noise = _draw(noise, x, generator)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        sample = mean_pred + _nonzero_mask(t, x) * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(self, model_fn: Callable, x: Tensor, t: Tensor,
                            clip_denoised: bool = True, model_kwargs=None,
                            eta: float = 0.0) -> dict:
        """The deterministic encode step (ref gaussian_diffusion.py:614-653)."""
        assert eta == 0.0, "reverse ODE only with eta=0"
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                   model_kwargs=model_kwargs)
        eps = ((self._at("sqrt_recip_alphas_cumprod", t, x.shape) * x
                - out["pred_xstart"])
               / self._at("sqrt_recipm1_alphas_cumprod", t, x.shape))
        alpha_bar_next = self._at("alphas_cumprod_next", t, x.shape)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
                     + torch.sqrt(1 - alpha_bar_next) * eps)
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    def p_sample_loop(self, model_fn: Callable, shape, noise: Tensor,
                      step_noise: Callable[[int, Tensor], Tensor],
                      clip_denoised: bool = True, denoised_fn=None, model_kwargs=None,
                      from_t: Optional[int] = None) -> Tensor:
        """The whole (or a partial) reverse loop from ``noise``; ``from_t``
        starts it at step from_t - 1 (purification, ref
        runners/diffpure_guided.py:68-75). Step i draws ``step_noise(i, x)``."""
        start = self.num_timesteps if from_t is None else from_t
        x = noise
        for i in range(start):
            t = torch.full((shape[0],), start - 1 - i, dtype=torch.int32, device=x.device)
            x = self.p_sample(model_fn, x, t, clip_denoised=clip_denoised,
                              denoised_fn=denoised_fn, model_kwargs=model_kwargs,
                              noise=step_noise(i, x))["sample"]
        return x

    # ---- losses (training; ref gaussian_diffusion.py:717-901) -------------------

    def _vb_terms_bpd(self, model_fn, x_start, x_t, t, clip_denoised=True,
                      model_kwargs=None):
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, clip_denoised=clip_denoised,
                                   model_kwargs=model_kwargs)
        kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
        kl = kl.reshape(kl.shape[0], -1).mean(dim=-1) / float(np.log(2.0))
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        decoder_nll = decoder_nll.reshape(decoder_nll.shape[0], -1).mean(dim=-1) \
            / float(np.log(2.0))
        output = torch.where(t == 0, decoder_nll, kl)
        return {"output": output, "pred_xstart": out["pred_xstart"]}

    def training_losses(self, model_fn, x_start: Tensor, t: Tensor, model_kwargs=None,
                        noise: Optional[Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> dict:
        """MSE (+ the VLB with a learned variance) training loss
        (ref gaussian_diffusion.py:793-864)."""
        model_kwargs = model_kwargs or {}
        noise = _draw(noise, x_start, generator)
        x_t = self.q_sample(x_start, t, noise=noise)
        terms = {}
        model_output = model_fn(x_t, self._scale_timesteps(t), **model_kwargs)

        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = model_output.chunk(2, dim=-1)
            frozen_out = torch.cat([model_output.detach(), model_var_values], dim=-1)
            terms["vb"] = self._vb_terms_bpd(
                lambda *_a, **_k: frozen_out, x_start, x_t, t,
                clip_denoised=False)["output"]
            terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)

        target = {
            ModelMeanType.PREVIOUS_X: lambda: self.q_posterior_mean_variance(
                x_start, x_t, t)[0],
            ModelMeanType.START_X: lambda: x_start,
            ModelMeanType.EPSILON: lambda: noise,
        }[self.model_mean_type]()
        mse = (target - model_output) ** 2
        terms["mse"] = mse.reshape(mse.shape[0], -1).mean(dim=-1)
        terms["loss"] = terms["mse"] + terms.get("vb", 0.0)
        return terms


def _respaced_betas(betas: np.ndarray, use_timesteps: Sequence[int]):
    """The new betas and timestep map of a respaced process
    (ref respace.py:71-105)."""
    alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
    last_alpha_cumprod = 1.0
    new_betas, timestep_map = [], []
    for i, alpha_cumprod in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1.0 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return np.array(new_betas), np.array(timestep_map, dtype=np.int64)


class SpacedDiffusion(GaussianDiffusion):
    """Diffusion over a subset of the original timesteps (ref
    respace.py:71-136). Model calls map respaced indices to original steps
    through ``timestep_map``; with rescale_timesteps they are rescaled by
    the original step count, to float32 (ref respace.py:124-135), so the
    model's timestep embedding sees floats."""

    def __init__(self, betas: np.ndarray, timestep_map: Sequence[int],
                 original_num_steps: int, **kwargs):
        super().__init__(betas, **kwargs)
        self.timestep_map = tuple(int(i) for i in timestep_map)
        self.original_num_steps = original_num_steps
        self._maps = {}

    @staticmethod
    def from_original(betas: np.ndarray, use_timesteps, **kwargs) -> "SpacedDiffusion":
        if isinstance(use_timesteps, str):
            use_timesteps = space_timesteps(len(betas), use_timesteps)
        new_betas, tmap = _respaced_betas(betas, set(use_timesteps))
        return SpacedDiffusion(new_betas, tmap, len(betas), **kwargs)

    def _wrap_model(self, model_fn: Callable) -> Callable:
        def wrapped(x, ts, **kwargs):
            tmap = self._maps.get(ts.device)
            if tmap is None:
                tmap = self._maps[ts.device] = torch.tensor(
                    self.timestep_map, dtype=torch.int32, device=ts.device)
            new_ts = tmap[ts.long()]
            if self.rescale_timesteps:
                new_ts = new_ts.float() * (1000.0 / self.original_num_steps)
            return model_fn(x, new_ts, **kwargs)

        return wrapped

    def p_mean_variance(self, model_fn, *args, **kwargs):
        return super().p_mean_variance(self._wrap_model(model_fn), *args, **kwargs)

    # cond_fn sees the model's timesteps, as guided-diffusion wraps it (ref
    # respace.py:110-117); JAX's SpacedDiffusion hands it the respaced indices
    def condition_mean(self, cond_fn, *args, **kwargs):
        return super().condition_mean(self._wrap_model(cond_fn), *args, **kwargs)

    def condition_score(self, cond_fn, *args, **kwargs):
        return super().condition_score(self._wrap_model(cond_fn), *args, **kwargs)

    def training_losses(self, model_fn, *args, **kwargs):
        return super().training_losses(self._wrap_model(model_fn), *args, **kwargs)

    def _scale_timesteps(self, t):
        # the wrapped model scales (ref respace.py:119-121)
        return t
