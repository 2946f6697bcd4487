"""Score adapters: epsilon model -> score(x, t) (port of
diffpure_tpu/diffusion/score.py: ``get_score_fn`` :24 for the VP, sub-VP
and VE SDEs, continuous and discrete, and the guided-diffusion adapter
:61-81).

The two families use different alpha-bars on purpose (ref
runners/diffpure_sde.py:101-120): score_sde feeds labels t*999 and divides
by the continuous marginal std; guided_diffusion feeds integer steps t*N and
divides by sqrt(1 - alpha_bar_cont(t)).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from diffpure_tpu_torch.diffusion.sde import VESDE, VPSDE, SubVPSDE, batch_mul

Tensor = torch.Tensor


def get_score_fn(sde, model_fn: Callable[[Tensor, Tensor], Tensor],
                 continuous: bool = True) -> Callable[[Tensor, Tensor], Tensor]:
    """Convert an epsilon / sigma model into score(x, t) (ref
    score_sde/models/utils.py:128-177).

    VP / sub-VP: continuous (and sub-VP always) feeds labels t*999 and
    divides by the continuous marginal std; discrete VP feeds t*(N-1) and
    divides by the discrete sqrt(1 - alpha_bar) at the truncated label. VE:
    continuous feeds the noise scale sigma(t) as the label, discrete the
    rounded (T - t)*(N-1), and the model's output is the score itself.
    """
    if isinstance(sde, (VPSDE, SubVPSDE)):
        sqrt_1m = None
        if not continuous and isinstance(sde, VPSDE):
            sqrt_1m = torch.from_numpy(
                np.sqrt(1.0 - sde.alphas_cumprod).astype(np.float32))

        def score_fn(x: Tensor, t: Tensor) -> Tensor:
            if sqrt_1m is None:
                model_output = model_fn(x, t * 999)
                std = sde.marginal_prob(torch.zeros_like(x), t)[1]
            else:
                labels = t * (sde.N - 1)
                model_output = model_fn(x, labels)
                std = sqrt_1m.to(x.device)[labels.to(torch.int32).long()]
            return batch_mul(-1.0 / std, model_output)

        return score_fn

    if isinstance(sde, VESDE):
        def score_fn(x: Tensor, t: Tensor) -> Tensor:
            if continuous:
                labels = sde.marginal_prob(torch.zeros_like(x), t)[1]
            else:
                labels = torch.round((sde.T - t) * (sde.N - 1)).to(torch.int32)
            return model_fn(x, labels)

        return score_fn

    raise NotImplementedError(f"no score adapter for SDE class {type(sde)}")


def eps_to_score_continuous_vp(eps: Tensor, t: Tensor, sde: VPSDE) -> Tensor:
    """score = -eps / sqrt(1 - alpha_bar_cont(t)) (ref diffpure_sde.py:77,112)."""
    return batch_mul(-1.0 / torch.sqrt(1.0 - sde.alphas_cumprod_cont(t)), eps)


def make_guided_score_fn(model_fn: Callable[..., Tensor], sde: VPSDE,
                         learn_sigma: bool = True, **model_kwargs
                         ) -> Callable[[Tensor, Tensor], Tensor]:
    """Score adapter for the guided-diffusion epsilon model.

    The model takes integer steps: t * N formed in float32 and truncated
    toward zero, as JAX's ``(t * N).astype(int32)`` does (rounding, or
    float64, would feed another step on some Euler steps). With learn_sigma
    the output holds [eps, var] on the channel axis (NHWC: the last); eps is
    its first half.
    """
    def score_fn(x: Tensor, t: Tensor) -> Tensor:
        disc_steps = (t.float() * sde.N).to(torch.int32)
        out = model_fn(x, disc_steps, **model_kwargs)
        if learn_sigma:
            out = out[..., :out.shape[-1] // 2]
        return eps_to_score_continuous_vp(out, t, sde)

    return score_fn
