"""Fresh weights drawn as flax's initialisers draw them (the distributions;
torch cannot reproduce JAX's threefry bits).

- ``lecun_normal_``: flax's default ``Conv`` / ``Dense`` kernel init,
  ``variance_scaling(1, 'fan_in', 'truncated_normal')``: a normal
  truncated at two standard deviations, its std corrected by
  0.87962566103423978 so that the kept draws have variance 1 / fan_in.
- ``ddpm_init_``: NCSN++'s ``ddpm_init(scale)``,
  ``variance_scaling(scale, 'fan_avg', 'uniform')`` with a scale of 0
  taken as 1e-10 (diffpure_tpu/models/layers.py:90-97).
Fans are flax's: a kernel's receptive field times its in / out channels.
"""
from __future__ import annotations

import math

import torch

# std of a unit normal truncated to [-2, 2] (flax / JAX's constant)
_TRUNC_STD = 0.87962566103423978


def fans(t: torch.Tensor, w_in_out: bool = False):
    """(fan_in, fan_out) of a PyTorch weight: (out, in, *kernel), or
    (in, out) for an NIN ``W`` (``w_in_out``)."""
    if w_in_out:
        return t.shape[0], t.shape[1]
    receptive = math.prod(t.shape[2:])
    return t.shape[1] * receptive, t.shape[0] * receptive


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fans(t)[0]) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def ddpm_init_(t: torch.Tensor, generator: torch.Generator, scale: float = 1.0,
               w_in_out: bool = False) -> torch.Tensor:
    scale = 1e-10 if scale == 0 else scale
    fan_in, fan_out = fans(t, w_in_out)
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    return torch.nn.init.uniform_(t, -limit, limit, generator=generator)
