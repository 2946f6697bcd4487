"""GroupNorm (+ SiLU) with fp32 statistics over NHWC maps (port of
diffpure_tpu/ops/groupnorm.py:26-56)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def ncsn_num_groups(channels: int) -> int:
    """min(C // 4, 32) (ref layerspp.py:67)."""
    return min(channels // 4, 32)


def group_norm(x: Tensor, scale: Tensor, bias: Tensor, num_groups: int,
               eps: float = 1e-6) -> Tensor:
    """Torch-semantics GroupNorm over NHWC input.

    Statistics per (batch, group) over (H, W, C/G), two-pass in fp32; the
    result is cast back to the input dtype.
    """
    N, H, W, C = x.shape
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    xg = x.float().reshape(N, H, W, num_groups, C // num_groups)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    x32 = ((xg - mean) * torch.rsqrt(var + eps)).reshape(N, H, W, C)
    out = x32 * scale.float() + bias.float()
    return out.to(x.dtype)


def group_norm_silu(x: Tensor, scale: Tensor, bias: Tensor, num_groups: int,
                    eps: float = 1e-6) -> Tensor:
    """GroupNorm followed by SiLU (the UNet res-block prologue)."""
    return F.silu(group_norm(x, scale, bias, num_groups, eps))
