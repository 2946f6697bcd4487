"""The products every reference model shares, in NCHW, with their operands
in the model's precision (precision.py). Parameters are plain ``nn``
modules, so a state dict loads by name."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.precision import Precision

Tensor = torch.Tensor


def conv(m: nn.Conv2d, x: Tensor, prec: Precision, stride: Optional[int] = None,
         padding: Optional[int] = None) -> Tensor:
    bias = m.bias if m.bias is not None else None
    return F.conv2d(prec.q(x), prec.q(m.weight), bias,
                    stride=m.stride if stride is None else stride,
                    padding=m.padding if padding is None else padding)


def conv1d(m: nn.Conv1d, x: Tensor, prec: Precision) -> Tensor:
    return F.conv1d(prec.q(x), prec.q(m.weight), m.bias)


def linear(m: nn.Linear, x: Tensor, prec: Precision) -> Tensor:
    return F.linear(prec.q(x), prec.q(m.weight), m.bias)


def matmul(a: Tensor, b: Tensor, prec: Precision) -> Tensor:
    return torch.matmul(prec.q(a), prec.q(b))


def group_norm(m: nn.GroupNorm, x: Tensor) -> Tensor:
    return F.group_norm(x, m.num_groups, m.weight, m.bias, m.eps)


def upsample(x: Tensor) -> Tensor:
    """Nearest-neighbour 2x."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def downsample(x: Tensor) -> Tensor:
    """2x2 mean pool."""
    return F.avg_pool2d(x, 2, 2)


class BatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm from the running statistics."""

    def forward(self, x: Tensor) -> Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)
