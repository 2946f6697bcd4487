"""Expectation over transformation: the mean of a function over several
draws of the defence's noise (port of diffpure_tpu/attacks/eot.py).

JAX scans over stacked keys to keep one traced copy of the defended
forward; eager PyTorch has no program size to save, so the sequential form
is a plain loop that keeps one repetition alive at a time (O(1) memory in
n). Keys become integer seeds: repetition i runs with fold_in(seed, i).
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from diffpure_tpu_torch.utils.prng import fold_in

Tensor = torch.Tensor


def eot_seeds(seed: int, n: int) -> List[int]:
    return [fold_in(seed, i) for i in range(n)]


def eot_average(fn: Callable[..., Tuple[Tensor, ...]], seed: int, n: int,
                parallel: bool = False) -> Tuple[Tensor, ...]:
    """Mean of the tensors fn returns over n repetitions.

    parallel=False: ``fn(fold_in(seed, i))`` for i < n, one at a time.
    parallel=True: one call ``fn(seed, reps=n)`` that batches all n
    repetitions along the batch axis and returns each tensor with a leading
    axis of n (the repetitions then draw their noise from one call's
    stream, not from n streams). n == 1 short-circuits to fn(fold_in(seed, 0)).
    """
    if n == 1:
        return fn(fold_in(seed, 0))
    if parallel:
        return tuple(v.mean(dim=0) for v in fn(seed, reps=n))
    acc = None
    for s in eot_seeds(seed, n):
        out = fn(s)
        acc = out if acc is None else tuple(a + o for a, o in zip(acc, out))
    return tuple(v / n for v in acc)
