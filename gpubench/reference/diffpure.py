"""DiffPure's defended classifier (Nie et al., 2022, ``runners/diffpure_sde.py``
and ``eval_sde_adv.py``), plain PyTorch, float32: [0, 1] images, an optional
bilinear resize, x -> 2x - 1, one-shot forward diffusion to t*, the reverse
VP-SDE integrated with Euler-Maruyama back to t = 1e-5 in flipped time, then
(x + 1) / 2 to the classifier.

VP-SDE (Song et al., 2021): beta(s) = beta_min + s (beta_max - beta_min),
f(x, s) = -beta(s) x / 2, g(s) = sqrt(beta(s)). In flipped time t' = 1 - s
the drift is -[f(x, s) - g(s)^2 score(x, s)] and the diffusion g(s). The
forward diffusion uses the discrete alpha-bar at step t* (float64 table,
cast to float32). The grid: t'_i = t'_0 + i dt formed in float32.

Scores: ``score_sde`` feeds labels s * 999 and divides epsilon by the
marginal std sqrt(1 - exp(2 log_mean_coeff(s))), evaluated as
sqrt(-expm1(...)), which is the same quantity without float32's
cancellation near s = 1e-5; ``guided_diffusion`` feeds the integer step
int(s * N) and divides the first three output channels by
sqrt(1 - exp(-(beta_max - beta_min) s^2 / 2 - beta_min s)).

Noise comes from the benchmark's source (the same draws the program got),
asked for at the whole batch's NHWC shape and sliced to the rows checked.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

Tensor = torch.Tensor


def alphas_cumprod(beta_min: float, beta_max: float, n: int) -> np.ndarray:
    return np.cumprod(1.0 - np.linspace(beta_min / n, beta_max / n, n, dtype=np.float64))


def bilinear_resize(x: Tensor, size: int) -> Tensor:
    """NCHW, half-pixel centres, no antialiasing (an upsample)."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=False)


class Defence:
    """purify + classify. ``score`` and ``classifier`` are the reference
    models (NCHW); calls take and return NHWC, as the program's do."""

    def __init__(self, score, classifier, *, t_star: int, score_type: str,
                 resize_to: Optional[int] = None, n_steps: Optional[int] = None,
                 beta_min: float = 0.1, beta_max: float = 20.0, N: int = 1000,
                 eps_end: float = 1e-5):
        if score_type not in ("score_sde", "guided_diffusion"):
            raise ValueError(score_type)
        self.score, self.classifier = score, classifier
        self.t_star, self.score_type, self.resize_to = t_star, score_type, resize_to
        self.n_steps = n_steps or t_star
        self.beta_min, self.beta_max, self.N, self.eps_end = beta_min, beta_max, N, eps_end

    def _beta(self, s: Tensor) -> Tensor:
        return self.beta_min + s * (self.beta_max - self.beta_min)

    def _score(self, x: Tensor, s: Tensor) -> Tensor:
        b = (-1,) + (1,) * (x.ndim - 1)
        if self.score_type == "score_sde":
            eps = self.score(x, s * 999)
            lmc = -0.25 * s ** 2 * (self.beta_max - self.beta_min) - 0.5 * s * self.beta_min
            std = torch.sqrt(torch.clamp(-torch.expm1(2.0 * lmc), min=0.0))
            return -eps / std.reshape(b)
        eps = self.score(x, (s.float() * self.N).to(torch.int32))[:, :3]
        abar = torch.exp(-0.5 * (self.beta_max - self.beta_min) * s ** 2 - self.beta_min * s)
        return -eps / torch.sqrt(1.0 - abar).reshape(b)

    def purify(self, x: Tensor, noise, batch: int, rows: Sequence[int],
               checkpoint: bool = False) -> Tensor:
        """x: NCHW in [-1, 1], the checked ``rows`` of a batch of ``batch``."""
        rows = torch.as_tensor(list(rows), device=x.device)
        like = torch.zeros((batch,) + tuple(x.shape[2:]) + (x.shape[1],), device=x.device)

        def nchw(full_nhwc: Tensor) -> Tensor:
            return full_nhwc[rows].permute(0, 3, 1, 2)

        a = alphas_cumprod(self.beta_min, self.beta_max, self.N).astype(np.float32)
        abar = torch.tensor(a[self.t_star - 1], device=x.device)
        e = nchw(noise.forward_eps(0, tuple(like.shape), like))
        xt = x * torch.sqrt(abar) + e * torch.sqrt(1.0 - abar)
        t0, t1 = 1.0 - self.t_star / 1000.0, 1.0 - self.eps_end
        dt = (t1 - t0) / self.n_steps

        def step(xc: Tensor, i: int) -> Tensor:
            t = float(np.float32(t0) + np.float32(i) * np.float32(dt))
            tb = torch.full((xc.shape[0],), t, dtype=xc.dtype, device=xc.device)
            s = 1.0 - tb
            beta = self._beta(s).reshape(-1, 1, 1, 1)
            drift = -(-0.5 * beta * xc - beta * self._score(xc, s))
            dw = nchw(noise.brownian(0, i, like, dt))
            return xc + drift * dt + torch.sqrt(beta) * dw

        remat = checkpoint and torch.is_grad_enabled()
        for i in range(self.n_steps):
            xt = _checkpoint(step, xt, i, use_reentrant=False) if remat else step(xt, i)
        return xt

    def __call__(self, x01_nhwc: Tensor, noise, batch: int, rows: Sequence[int],
                 checkpoint: bool = False):
        """(purified [0, 1] NHWC, logits) of the checked rows, whose inputs
        are ``x01_nhwc``."""
        dtype = next(self.score.parameters()).dtype
        x = x01_nhwc.permute(0, 3, 1, 2).to(dtype)
        if self.resize_to is not None and x.shape[-1] != self.resize_to:
            x = bilinear_resize(x, self.resize_to)
        x = self.purify((x - 0.5) * 2.0, noise, batch, rows, checkpoint)
        x01 = (x + 1.0) * 0.5
        return x01.permute(0, 2, 3, 1), self.classifier(x01)
