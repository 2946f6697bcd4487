"""GroupNorm (+ SiLU) with fp32 statistics over NHWC maps (port of
diffpure_tpu/ops/groupnorm.py).

Two GN+SiLU functions, as in JAX:
  - ``group_norm_silu`` (:51), the plain chain: GroupNorm cast back to the
    input dtype, then SiLU in that dtype;
  - ``group_norm_silu_fused`` (JAX's ``group_norm_silu_pallas``, :81): the
    same function with the affine and SiLU in fp32 and one cast at the end.
    Its CUDA kernel (``csrc/group_norm_silu.cu``) runs on CUDA tensors, its
    plain version ``group_norm_silu_fused_reference`` on CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from diffpure_tpu_torch.ops import _cuda

Tensor = torch.Tensor


def ncsn_num_groups(channels: int) -> int:
    """min(C // 4, 32) (ref layerspp.py:67)."""
    return min(channels // 4, 32)


def _normalized32(x: Tensor, num_groups: int, eps: float) -> Tensor:
    """(x - mean) * rstd per (example, group), fp32, two-pass statistics."""
    N, H, W, C = x.shape
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    xg = x.float().reshape(N, H, W, num_groups, C // num_groups)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    return ((xg - mean) * torch.rsqrt(var + eps)).reshape(N, H, W, C)


def group_norm(x: Tensor, scale: Tensor, bias: Tensor, num_groups: int,
               eps: float = 1e-6) -> Tensor:
    """Torch-semantics GroupNorm over NHWC input.

    Statistics per (batch, group) over (H, W, C/G), two-pass in fp32; the
    result is cast back to the input dtype.
    """
    out = _normalized32(x, num_groups, eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def group_norm_silu(x: Tensor, scale: Tensor, bias: Tensor, num_groups: int,
                    eps: float = 1e-6) -> Tensor:
    """GroupNorm followed by SiLU (the UNet res-block prologue)."""
    return F.silu(group_norm(x, scale, bias, num_groups, eps))


def group_norm_silu_fused_reference(x: Tensor, scale: Tensor, bias: Tensor,
                                    num_groups: int, eps: float = 1e-6) -> Tensor:
    """Plain version of ``group_norm_silu_fused``: fp32 statistics,
    normalise, affine and SiLU, one cast at the end (the arithmetic of
    JAX's ``_gn_silu_kernel``, :59, with a two-pass variance)."""
    h = _normalized32(x, num_groups, eps) * scale.float() + bias.float()
    return (h * torch.sigmoid(h)).to(x.dtype)


def group_norm_silu_fused(x: Tensor, scale: Tensor, bias: Tensor,
                          num_groups: int, eps: float = 1e-6) -> Tensor:
    """silu(GroupNorm(x)) with one rounding, x (N, H, W, C) fp32 or bf16,
    scale and bias (C,): plain on CPU, the CUDA kernel on CUDA.

    JAX gates its kernel on the TPU backend, ``set_fused_gn_silu`` and the
    map fitting VMEM (layers.py:83-84). The port has no global kernel
    switches (ROADMAP item 3) and the kernel takes every map size, so none
    of those gates is kept. Forward only on the card: JAX differentiates
    the plain chain; here the wrapper raises when autograd would need the
    kernel's gradient.
    """
    if x.device.type == "cpu":
        return group_norm_silu_fused_reference(x, scale, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu_fused runs on cpu or cuda, not {x.device}")
    _cuda.refuse_card_grad("group_norm_silu_fused", x, scale, bias)
    if x.dtype not in _cuda.DTYPE_CODE or x.ndim != 4 or x.shape[3] % num_groups:
        raise ValueError(f"group_norm_silu_fused takes NHWC fp32 or bf16 whose channels "
                         f"split into {num_groups} groups; got {x.dtype} {tuple(x.shape)}")
    N, H, W, C = x.shape
    dev = x.device
    p_x = _cuda.check_operand(x, "x", dev, x.dtype)
    gamma = scale.to(device=dev, dtype=torch.float32).contiguous()
    beta = bias.to(device=dev, dtype=torch.float32).contiguous()
    p_g = _cuda.check_operand(gamma, "scale", dev, torch.float32, (C,))
    p_b = _cuda.check_operand(beta, "bias", dev, torch.float32, (C,))
    out = torch.empty_like(x)
    err = _cuda.lib().diffpure_gn_silu(
        _cuda.DTYPE_CODE[x.dtype], p_x, p_g, p_b, N, H * W, C, num_groups, eps,
        out.data_ptr(), _cuda.stream(dev))
    _cuda.check(err, "group_norm_silu_fused kernel")
    group_norm_silu_fused.launches += 1
    return out


# Kernel launches since the last reset (plain CPU calls do not count).
group_norm_silu_fused.launches = 0
