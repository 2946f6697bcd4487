"""Score adapters: epsilon model -> score(x, t) (port of
diffpure_tpu/diffusion/score.py: the VP continuous branch of
``get_score_fn`` :24, and the guided-diffusion adapter :61-81).

The two families use different alpha-bars on purpose (ref
runners/diffpure_sde.py:101-120): score_sde feeds labels t*999 and divides
by the continuous marginal std; guided_diffusion feeds integer steps t*N and
divides by sqrt(1 - alpha_bar_cont(t)).
"""
from __future__ import annotations

from typing import Callable

import torch

from diffpure_tpu_torch.diffusion.sde import VPSDE, batch_mul

Tensor = torch.Tensor


def get_score_fn(sde: VPSDE, model_fn: Callable[[Tensor, Tensor], Tensor],
                 continuous: bool = True) -> Callable[[Tensor, Tensor], Tensor]:
    """score(x, t) = -model(x, t*999) / std(t), with the continuous marginal
    std (ref score_sde/models/utils.py:128-177)."""
    if not isinstance(sde, VPSDE) or not continuous:
        raise NotImplementedError(
            "only the continuous VP-SDE score adapter is ported; the others "
            "wait for ROADMAP Slice 1 item 4")

    def score_fn(x: Tensor, t: Tensor) -> Tensor:
        model_output = model_fn(x, t * 999)
        std = sde.marginal_prob(torch.zeros_like(x), t)[1]
        return batch_mul(-1.0 / std, model_output)

    return score_fn


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
