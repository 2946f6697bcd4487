"""Fused bias-add + leaky ReLU + gain (port of diffpure_tpu/ops/fused_act.py).

``fused_leaky_relu`` runs its plain version on a CPU tensor and the CUDA
kernel of ``csrc/fused_act.cu`` (which replaces ``fused_leaky_relu_pallas``,
:47) on a CUDA tensor, or raises. Like the JAX op it exists for API parity
with the score_sde reference's ``fused_bias_act`` (ref
score_sde/op/fused_act.py:60-105): no model calls it at runtime. Layout:
the bias is per channel, on the last axis. Forward only on the card: the
wrapper raises when autograd would need the kernel's gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from diffpure_tpu_torch.ops import _cuda

Tensor = torch.Tensor

DEFAULT_SLOPE = 0.2
DEFAULT_SCALE = 2.0 ** 0.5  # ref fused_act.py:63 (sqrt(2) gain)


def fused_leaky_relu_reference(x: Tensor, bias: Optional[Tensor] = None,
                               negative_slope: float = DEFAULT_SLOPE,
                               scale: float = DEFAULT_SCALE) -> Tensor:
    """y = leaky_relu(x + bias) * scale in x's dtype (JAX's
    ``fused_leaky_relu``, :32-38, with the bias in x's dtype)."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return torch.where(x >= 0, x, x * negative_slope) * scale


def fused_leaky_relu(x: Tensor, bias: Optional[Tensor] = None,
                     negative_slope: float = DEFAULT_SLOPE,
                     scale: float = DEFAULT_SCALE) -> Tensor:
    """leaky_relu(x + bias, negative_slope) * scale, bias (C,) over x's last
    axis or None; fp32 or bf16, the result in x's dtype: plain on CPU, the
    CUDA kernel on CUDA (fp32 arithmetic, one rounding)."""
    if x.device.type == "cpu":
        return fused_leaky_relu_reference(x, bias, negative_slope, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu runs on cpu or cuda, not {x.device}")
    _cuda.refuse_card_grad("fused_leaky_relu", x, bias)
    if x.dtype not in _cuda.DTYPE_CODE or x.ndim == 0:
        raise ValueError(f"fused_leaky_relu takes fp32 or bf16 with a channel axis; "
                         f"got {x.dtype} {tuple(x.shape)}")
    dev, C = x.device, x.shape[-1]
    p_x = _cuda.check_operand(x, "x", dev, x.dtype)
    p_b = None
    if bias is not None:
        bias = bias.to(device=dev, dtype=x.dtype).contiguous()
        p_b = _cuda.check_operand(bias, "bias", dev, x.dtype, (C,))
    out = torch.empty_like(x)
    err = _cuda.lib().diffpure_fused_leaky_relu(
        _cuda.DTYPE_CODE[x.dtype], p_x, p_b, x.numel(), C, negative_slope, scale,
        out.data_ptr(), _cuda.stream(dev))
    _cuda.check(err, "fused_leaky_relu kernel")
    fused_leaky_relu.launches += 1
    return out


# Kernel launches since the last reset (plain CPU calls do not count).
fused_leaky_relu.launches = 0
