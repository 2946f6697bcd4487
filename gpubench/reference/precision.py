"""The precision the reference computes its products in.

``fp32`` is the reference itself: float32 operands, float32 accumulation
(run with TF32 off). ``fp64`` is the reference in float64 (its models
cast to float64 by the caller), for a cell whose compared number the
float32 reference's own rounding moves. The lower modes are the controls of the correctness
check, the reference put in the program's place one precision down:

- ``tf32``: every conv and matmul operand rounded to TF32's 10-bit
  mantissa (round to nearest even), as the tensor cores round float32
  operands under TF32; accumulation stays float32. The rounding is done
  here, so the control is the same on the CPU and on the card.
- ``fp8``: every conv and matmul operand scaled by its absolute maximum
  over 448 and cast to float8 e4m3 and back (per-tensor scaling, as fp8
  inference does); accumulation float32.

GroupNorm, softmax and the elementwise work stay float32 in every mode.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

MODES = ("fp64", "fp32", "tf32", "fp8")
FP8_MAX = 448.0


def round_mantissa(x: Tensor, bits: int) -> Tensor:
    """float32 x rounded to ``bits`` explicit mantissa bits, nearest even."""
    shift = 23 - bits
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> shift) & 1
    i = (i + lsb + ((1 << (shift - 1)) - 1)) & ~((1 << shift) - 1)
    return i.view(torch.float32)


def _lower(x: Tensor, mode: str) -> Tensor:
    if mode == "tf32":
        return round_mantissa(x, 10)
    amax = x.abs().amax().float()
    s = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Lower(torch.autograd.Function):
    """The operand rounded going forward, and its cotangent rounded going
    back: the backward's products take lowered operands too."""

    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return _lower(x, mode)

    @staticmethod
    def backward(ctx, g):
        return _lower(g, ctx.mode), None


class Precision:
    """Shared by every layer of one reference model; ``mode`` may be set
    between calls."""

    def __init__(self, mode: str = "fp32"):
        self.mode = mode

    @property
    def mode(self) -> str:
        return self._mode

    @mode.setter
    def mode(self, mode: str) -> None:
        if mode not in MODES:
            raise ValueError(f"precision {mode!r}: one of {MODES}")
        self._mode = mode

    def q(self, x: Tensor) -> Tensor:
        """A product's operand in this precision (float32 storage below
        float64)."""
        if self._mode == "fp32":
            return x
        if self._mode == "fp64":
            return x.double()
        return _Lower.apply(x, self._mode)
