"""Score adapter: epsilon model -> score(x, t) (port of
diffpure_tpu/diffusion/score.py:24, the VP continuous branch)."""
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
