"""Naive 2x resampling over NHWC maps (port of
diffpure_tpu/ops/upfirdn2d.py:101-113). FIR resampling waits for ROADMAP
Slice 1 item 5."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def naive_upsample_2d(x: Tensor, factor: int = 2) -> Tensor:
    """Nearest-neighbour upsample (ref up_or_down_sampling.py:67-71)."""
    N, H, W, C = x.shape
    x = x.reshape(N, H, 1, W, 1, C).expand(N, H, factor, W, factor, C)
    return x.reshape(N, H * factor, W * factor, C)


def naive_downsample_2d(x: Tensor, factor: int = 2) -> Tensor:
    """Mean-pool downsample (ref up_or_down_sampling.py:74-77)."""
    N, H, W, C = x.shape
    x = x.reshape(N, H // factor, factor, W // factor, factor, C)
    return x.mean(dim=(2, 4))
