"""Batched accuracy (port of diffpure_tpu/eval/accuracy.py:13)."""
from __future__ import annotations

import math
from typing import Callable

import torch

from diffpure_tpu_torch.utils.prng import fold_in

Tensor = torch.Tensor


def get_accuracy(model_fn: Callable[[Tensor, int], Tensor], x: Tensor,
                 y: Tensor, seed: int, bs: int = 64) -> float:
    """Fraction of ``x`` classified as ``y``, in minibatches of ``bs``;
    batch i gets noise seed ``fold_in(seed, i)``."""
    correct = 0
    for i in range(math.ceil(x.shape[0] / bs)):
        logits = model_fn(x[i * bs:(i + 1) * bs], fold_in(seed, i))
        correct += int((logits.argmax(-1) == y[i * bs:(i + 1) * bs]).sum())
    return correct / x.shape[0]
