"""Shared classifier pieces (port of diffpure_tpu/classifiers/common.py:16)."""
from __future__ import annotations

import torch
import torch.nn as nn

Tensor = torch.Tensor


class BatchNormInference(nn.Module):
    """BatchNorm with stored running statistics over NHWC maps.

    Keys match ``nn.BatchNorm2d`` (weight, bias, running_mean, running_var,
    num_batches_tracked), so robustbench state dicts load strictly.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: Tensor) -> Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return x * inv + (self.bias - self.running_mean * inv)


# the CIFAR-10 normalisation inside the CIFAR classifiers (ref
# classifiers/cifar10_resnet.py, robustbench dm_wide_resnet.py)
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2471, 0.2435, 0.2616)
# the ImageNet normalisation of the torchvision classifiers
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(x: Tensor, mean, std) -> Tensor:
    """(x - mean) / std with per-channel constants over NHWC (port of
    diffpure_tpu/classifiers/common.py:36)."""
    m = torch.tensor(mean, dtype=x.dtype, device=x.device)
    s = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - m) / s
