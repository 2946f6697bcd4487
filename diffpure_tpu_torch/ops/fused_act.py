"""Fused bias-add + leaky ReLU + gain (port of diffpure_tpu/ops/fused_act.py).

``fused_leaky_relu`` runs its plain version on a CPU tensor and the CUDA
kernel of ``csrc/fused_act.cu`` (which replaces ``fused_leaky_relu_pallas``,
:47) on a CUDA tensor, or raises. Like the JAX op it exists for API parity
with the score_sde reference's ``fused_bias_act`` (ref
score_sde/op/fused_act.py:60-105): no model calls it at runtime. Layout:
the bias is per channel, on the last axis. Its gradient is the closed form
in PyTorch ops on both devices (``_FusedLeakyRelu``), differentiable again,
as JAX's autodiff of its plain expression is.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from diffpure_tpu_torch.ops import _cuda

Tensor = torch.Tensor

DEFAULT_SLOPE = 0.2
DEFAULT_SCALE = 2.0 ** 0.5  # ref fused_act.py:63 (sqrt(2) gain)

# The launch plan's constants, as csrc/fused_act.cu has them.
FLR_ROUTES = ("registers", "shared")
FLR_THREADS = 256       # a CTA of the shared route; the registers route's aim
FLR_UNROLL = 4          # 16-byte loads a thread keeps in flight (1 with one vector)
FLR_SM_THREADS = 1024   # threads an SM holds at __launch_bounds__(1024) (64 registers)
FLR_SMEM_BIAS_MAX = 48 * 1024  # the shared route's staged bias row at most
FLR_SMS = 132           # an H100 SXM's SMs: the plan's default


@dataclass(frozen=True)
class FlrPlan:
    """How ``diffpure_fused_leaky_relu`` covers an (rows, C) view of x:
    ``route`` (registers or shared), ``vw`` elements a 16-byte vector,
    ``threads`` a CTA, ``grid`` CTAs, ``rows`` a CTA takes a trip
    (registers), ``smem`` dynamic shared bytes (the shared route's staged
    bias row), ``resident`` the CTAs the SMs hold at once, ``unroll`` the
    loads a thread keeps in flight (1 where it has a single vector, else
    FLR_UNROLL); ``ints`` the 6 ints the kernel takes."""
    route: str
    vw: int
    threads: int
    grid: int
    rows: int
    smem: int
    resident: int
    unroll: int
    ints: tuple
    c_ints: object


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def flr_plan(shape: Sequence[int], dtype: torch.dtype, sms: int = FLR_SMS) -> FlrPlan:
    """The launch plan of #11 for x of ``shape`` (bias over the last axis)
    in ``dtype``. The registers route where C is a multiple of the vector
    width and a row has at most 1024 vectors, else the shared route. The
    grid is sized to the bytes: a vector a thread while the CTAs the SMs
    hold at once take them all (a toy size: one short wave), past that
    those CTAs, each thread looping over trips of FLR_UNROLL vectors.
    Cached by its arguments (``shape`` a tuple): the wrapper plans every
    call."""
    vw = 16 // (torch.finfo(dtype).bits // 8)
    C = int(shape[-1])
    total = 1
    for d in shape:
        total *= int(d)
    if C < 1 or total < 1:
        raise ValueError(f"fused_leaky_relu has nothing to plan for shape {tuple(shape)}")
    R, cv = total // C, C // vw
    route = "registers" if C % vw == 0 and cv <= FLR_SM_THREADS else "shared"
    if route == "registers":
        lanes = max(1, FLR_THREADS // cv)
        threads = lanes * cv
        resident = sms * (FLR_SM_THREADS // threads)
        unroll = 1 if _cdiv(R, lanes) <= resident else FLR_UNROLL
        rows, smem = lanes * unroll, 0  # rows a CTA takes a trip
        grid = min(_cdiv(R, rows), resident)
    else:
        threads = FLR_THREADS
        resident = sms * (FLR_SM_THREADS // threads)
        nvec = max(total // vw, 1)
        grid, rows = min(_cdiv(nvec, threads), resident), 0
        unroll = 1 if grid * threads >= nvec else FLR_UNROLL
        smem = (C + vw) * 4
        if smem > FLR_SMEM_BIAS_MAX:
            smem = 0  # the bias from global memory
    ints = (FLR_ROUTES.index(route), threads, grid, rows, smem, unroll)
    return FlrPlan(route, vw, threads, grid, rows, smem, resident, unroll, ints,
                   (ctypes.c_int * len(ints))(*ints))


def fused_leaky_relu_reference(x: Tensor, bias: Optional[Tensor] = None,
                               negative_slope: float = DEFAULT_SLOPE,
                               scale: float = DEFAULT_SCALE) -> Tensor:
    """y = leaky_relu(x + bias) * scale in x's dtype (JAX's
    ``fused_leaky_relu``, :32-38, with the bias in x's dtype)."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return torch.where(x >= 0, x, x * negative_slope) * scale


def _launch(x: Tensor, bias: Optional[Tensor], negative_slope: float,
            scale: float) -> Tensor:
    """The kernel on CUDA tensors (bias in x's dtype or None) under
    flr_plan's plan."""
    if x.dtype not in _cuda.DTYPE_CODE or x.ndim == 0:
        raise ValueError(f"fused_leaky_relu takes fp32 or bf16 with a channel axis; "
                         f"got {x.dtype} {tuple(x.shape)}")
    dev, C = x.device, x.shape[-1]
    p_x = _cuda.check_operand(x, "x", dev, x.dtype)
    p_b = None
    if bias is not None:
        bias = bias.contiguous()
        p_b = _cuda.check_operand(bias, "bias", dev, x.dtype, (C,))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    plan = flr_plan(x.shape, x.dtype, _cuda.num_sms(dev))
    err = _cuda.lib().diffpure_fused_leaky_relu(
        _cuda.DTYPE_CODE[x.dtype], p_x, p_b, x.numel(), C, negative_slope, scale,
        out.data_ptr(), plan.c_ints, _cuda.stream(dev))
    _cuda.check(err, "fused_leaky_relu kernel")
    fused_leaky_relu.launches += 1
    return out


def _forward(x: Tensor, bias: Optional[Tensor], negative_slope: float,
             scale: float) -> Tensor:
    """The plain version on a CPU tensor, the kernel on a CUDA one."""
    if x.device.type == "cpu":
        return fused_leaky_relu_reference(x, bias, negative_slope, scale)
    return _launch(x, bias, negative_slope, scale)


class _FusedLeakyRelu(torch.autograd.Function):
    """The kernel forward on CUDA tensors, the plain one on CPU tensors (one
    Function either way, so the CPU tests reach the backward). The backward
    is the closed form in PyTorch ops, so it differentiates again: dx =
    where(h >= 0, g * scale, g * scale * slope) with h = x + bias, in the
    order JAX's autodiff takes; dbias sums dx over every axis but the
    last."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        ctx.cfg = (negative_slope, scale)
        ctx.save_for_backward(x, bias)
        return _forward(x, bias, negative_slope, scale)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        negative_slope, scale = ctx.cfg
        gs = g * scale
        dx = torch.where((x if bias is None else x + bias) >= 0, gs, gs * negative_slope)
        return dx, None if bias is None else dx.reshape(-1, x.shape[-1]).sum(0), None, None


def fused_leaky_relu(x: Tensor, bias: Optional[Tensor] = None,
                     negative_slope: float = DEFAULT_SLOPE,
                     scale: float = DEFAULT_SCALE) -> Tensor:
    """leaky_relu(x + bias, negative_slope) * scale, bias (C,) over x's last
    axis or None; fp32 or bf16, the result in x's dtype: plain on CPU, the
    CUDA kernel on CUDA (fp32 arithmetic, one rounding); differentiable in
    x and bias on both, through ``_FusedLeakyRelu`` where autograd records
    (a call that needs no gradient skips the Function's host cost)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_leaky_relu runs on cpu or cuda, not {x.device}")
    if bias is not None:
        bias = bias.to(device=x.device, dtype=x.dtype)
    if torch.is_grad_enabled() and (x.requires_grad or (bias is not None and bias.requires_grad)):
        return _FusedLeakyRelu.apply(x, bias, negative_slope, scale)
    return _forward(x, bias, negative_slope, scale)


# Kernel launches since the last reset (plain CPU calls do not count).
fused_leaky_relu.launches = 0
