"""Mixed-precision policies and a dynamic loss scaler (port of
diffpure_tpu/training/precision.py; ref guided_diffusion/fp16_util.py).

The bf16 policy keeps fp32 parameters, computes in bf16 and returns fp32:
bf16 shares fp32's exponent range, so it needs no loss scaling. The
scaler is kept for fp16 experiments (ref fp16_util.py:156-243).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Policy:
    """Parameter / compute / output dtypes (ref unet.py:626-640)."""
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tensors: Sequence[Tensor]) -> list:
        return [t.to(self.compute_dtype) for t in tensors]

    def cast_to_param(self, tensors: Sequence[Tensor]) -> list:
        return [t.to(self.param_dtype) for t in tensors]

    def cast_output(self, x: Tensor) -> Tensor:
        return x.to(self.output_dtype)


def bf16_policy() -> Policy:
    """fp32 parameters, a bf16 torso, fp32 out."""
    return Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                  output_dtype=torch.float32)


def fp32_policy() -> Policy:
    return Policy()


@dataclasses.dataclass
class DynamicLossScaler:
    """Scale the loss by 2**log_scale; on finite gradients the log scale
    grows by ``growth``, on an overflow it backs off by ``backoff``
    (ref fp16_util.py:217-230)."""
    log_scale: float = 20.0
    growth: float = 1e-3
    backoff: float = 1.0

    @staticmethod
    def create(initial_log_scale: float = 20.0) -> "DynamicLossScaler":
        return DynamicLossScaler(log_scale=float(initial_log_scale))

    @property
    def scale(self) -> float:
        return 2.0 ** self.log_scale

    def scale_loss(self, loss: Tensor) -> Tensor:
        return loss * self.scale

    def unscale_grads(self, grads: Sequence[Tensor]) -> list:
        inv = 1.0 / self.scale
        return [g * inv for g in grads]

    def update(self, finite: bool) -> "DynamicLossScaler":
        step = self.growth if finite else -self.backoff
        return dataclasses.replace(self, log_scale=self.log_scale + step)


def grads_finite(grads: Sequence[Tensor]) -> bool:
    return all(bool(torch.isfinite(g).all()) for g in grads)
