"""Discretization of adversarial examples to 8-bit images (port of
diffpure_tpu/attacks/discretization.py; ref mister_ed/utils/discretize.py):
an attack found in continuous [0, 1] must survive PNG quantization.

``torch.round`` rounds half to even, as ``jnp.round`` does. Seeds as the
port's attacks take them: the randomized rounding draws from
``generator(seed)``; ``discretized_adversarial_check`` rounds with
fold_in(seed, 1) and classifies with fold_in(seed, 2).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from diffpure_tpu_torch.utils.prng import fold_in, generator

Tensor = torch.Tensor


def discretize_image(x01: Tensor, mode: str = "round", seed: Optional[int] = None) -> Tensor:
    """[0, 1] floats to the 255-level grid: 'round', the nearest level;
    'random', randomized rounding (up with probability the fraction:
    unbiased)."""
    scaled = x01 * 255.0
    if mode == "round":
        q = torch.round(scaled)
    elif mode == "random":
        if seed is None:
            raise ValueError("randomized rounding needs a seed")
        floor = torch.floor(scaled)
        u = torch.rand(x01.shape, generator=generator(seed, device=x01.device),
                       device=x01.device, dtype=x01.dtype)
        q = floor + (u < scaled - floor).to(scaled.dtype)
    else:
        raise ValueError(mode)
    return torch.clamp(q, 0.0, 255.0) / 255.0


def discretized_adversarial_check(model_fn: Callable, x_adv: Tensor, y: Tensor, seed: int,
                                  mode: str = "round") -> Tensor:
    """The found mask after 8-bit quantization: does the attack survive a
    PNG?"""
    xq = discretize_image(x_adv, mode=mode, seed=fold_in(seed, 1))
    with torch.no_grad():
        logits = model_fn(xq, fold_in(seed, 2))
    return logits.argmax(-1) != y
