"""Noise schedules of the discrete diffusion processes (port of
diffpure_tpu/diffusion/schedules.py, the whole module).

Float64 numpy throughout, as in JAX: the tables built from these betas are
cast to float32 only where a step gathers them (diffusion/discrete.py
``_extract``; ref guided_diffusion/gaussian_diffusion.py:140-141).
"""
from __future__ import annotations

import math
from typing import Sequence, Set, Union

import numpy as np


def linear_beta_schedule(num_timesteps: int, beta_start: float = 1e-4,
                         beta_end: float = 2e-2) -> np.ndarray:
    """Linear beta schedule (float64).

    Note the guided-diffusion convention scales the endpoints by 1000/N so the
    limiting process is invariant to the step count
    (ref: guided_diffusion/gaussian_diffusion.py:26-45); call with already
    scaled endpoints for that behavior. The SDEdit/DDPM convention uses the raw
    endpoints (ref: runners/diffpure_ddpm.py:19-23, configs/celeba.yml).
    """
    return np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)


def scaled_linear_beta_schedule(num_timesteps: int) -> np.ndarray:
    """guided_diffusion 'linear' schedule: endpoints scaled by 1000/N.

    ref: guided_diffusion/gaussian_diffusion.py:33-39.
    """
    scale = 1000.0 / num_timesteps
    return linear_beta_schedule(num_timesteps, scale * 1e-4, scale * 2e-2)


def cosine_beta_schedule(num_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """Cosine schedule from Nichol & Dhariwal (improved DDPM).

    ref: guided_diffusion/gaussian_diffusion.py:41-70 (betas_for_alpha_bar).
    """
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = []
    for i in range(num_timesteps):
        t1 = i / num_timesteps
        t2 = (i + 1) / num_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def vp_discrete_betas(beta_min: float = 0.1, beta_max: float = 20.0,
                      N: int = 1000) -> np.ndarray:
    """Discrete betas of the VP-SDE: linspace(beta_min/N, beta_max/N, N).

    ref: score_sde/sde_lib.py:130, runners/diffpure_sde.py:70.
    """
    return np.linspace(beta_min / N, beta_max / N, N, dtype=np.float64)


def get_named_beta_schedule(name: str, num_timesteps: int) -> np.ndarray:
    """Named schedule lookup mirroring the reference surface.

    ref: guided_diffusion/gaussian_diffusion.py:26-50.
    """
    if name == "linear":
        return scaled_linear_beta_schedule(num_timesteps)
    if name == "cosine":
        return cosine_beta_schedule(num_timesteps)
    raise NotImplementedError(f"unknown beta schedule: {name}")


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Choose a subset of original diffusion steps for respacing.

    Supports the "ddimN" shorthand (exact stride required) and comma-separated
    per-section counts. Semantics match the reference exactly
    (ref: guided_diffusion/respace.py:15-68).
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        if count <= 1:
            frac_stride = 1.0
        else:
            frac_stride = (size - 1) / (count - 1)
        cur_idx = 0.0
        taken = []
        for _ in range(count):
            taken.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken
        start_idx += size
    return set(all_steps)
