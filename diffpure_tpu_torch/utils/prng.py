"""Counter-based seeds: the port's stand-in for ``jax.random.fold_in``.

A stream is named by an integer seed and a path of counters; each stream
seeds its own ``torch.Generator``. Any draw can therefore be replayed from
(seed, path) alone, which the adjoint gradient (next slice) relies on.
Torch's generators do not reproduce JAX's threefry bits: parity tests inject
the noise JAX drew instead.
"""
from __future__ import annotations

import random

import numpy as np
import torch

_MASK = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """Mix ``data`` into ``seed`` (splitmix64 finaliser); 63-bit result."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) >> 1


def generator(seed: int, *path: int, device=None) -> torch.Generator:
    """A generator on ``device`` seeded by ``fold_in(...fold_in(seed, p0)...)``."""
    for p in path:
        seed = fold_in(seed, p)
    g = torch.Generator(device=device if device is not None else "cpu")
    g.manual_seed(seed)
    return g


def seed_everything(seed: int) -> int:
    """Seed Python's, numpy's and torch's global generators (data
    subsetting, any draw outside the counter-based streams) and return the
    run's root seed (diffpure_tpu/utils/prng.py:16 returns its root key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return int(seed)
