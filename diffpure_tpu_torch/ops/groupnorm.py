"""GroupNorm (+ SiLU) with fp32 statistics over NHWC maps (port of
diffpure_tpu/ops/groupnorm.py).

Two GN+SiLU functions, as in JAX:
  - ``group_norm_silu`` (:51), the plain chain: GroupNorm cast back to the
    input dtype, then SiLU in that dtype;
  - ``group_norm_silu_fused`` (JAX's ``group_norm_silu_pallas``, :81): the
    same function with the affine and SiLU in fp32 and one cast at the end.
    Its CUDA kernel (``csrc/group_norm_silu.cu``) runs on CUDA tensors, its
    plain version ``group_norm_silu_fused_reference`` on CPU tensors; its
    launch plan is ``gn_silu_plan``. It is an autograd ``Function``
    (``_cuda.KernelFunction``) whose backward is autograd of the plain
    chain ``group_norm_silu``: JAX's default path differentiates that
    chain, not the kernel's one-rounding form.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

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
    """GroupNorm followed by SiLU (the UNet res-block prologue), written
    h * sigmoid(h) as JAX writes it (:52), so that bf16 rounds at the same
    places, in the forward and in autograd's backward."""
    h = group_norm(x, scale, bias, num_groups, eps)
    return h * torch.sigmoid(h)


def group_norm_silu_fused_reference(x: Tensor, scale: Tensor, bias: Tensor,
                                    num_groups: int, eps: float = 1e-6) -> Tensor:
    """Plain version of ``group_norm_silu_fused``: fp32 statistics,
    normalise, affine and SiLU, one cast at the end (the arithmetic of
    JAX's ``_gn_silu_kernel``, :59, with a two-pass variance)."""
    h = _normalized32(x, num_groups, eps) * scale.float() + bias.float()
    return (h * torch.sigmoid(h)).to(x.dtype)


# Kernel #10's registers route (csrc/gn_silu.cuh): the most vectors a
# thread holds, by vector width (32 elements for vectors of 4 and 8, 8
# single elements), and the count it aims at where the card's thread slots
# allow; the most threads a slice takes; the block of the slices that a
# warp or less holds; the route's bounds (vectors a slice, bytes of a
# block's staged gamma and beta).
GNS_NV_MAX = {8: 4, 4: 8, 1: 8}
GNS_NV_AIM = 2
GNS_MAX_THREADS = 1024
GNS_BLOCK = 128
GNS_MAX_VECS = 8192
GNS_MAX_SMEM = 48 * 1024
GNS_SMS = 132         # the H100's SMs (the wrappers pass the card's count)


@dataclasses.dataclass(frozen=True)
class GnSiluPlan:
    """How the GroupNorm(+SiLU) kernels hold the N * G (example, group)
    slices: ``route`` "registers" (each slice in the registers of ``tps``
    threads, ``nv`` vectors of ``vw`` elements each; ``threads`` a block,
    ``threads // tps`` slices a block) or "l2" (above the register budget:
    a block of ``threads`` a slice, read three times); the 5 ints the C
    side reads, (route, vw, nv, tps, threads), as a C array."""
    route: str
    vw: int
    nv: int
    tps: int
    threads: int
    blocks: int
    ints: Tuple[int, ...]
    c_ints: object = dataclasses.field(compare=False, hash=False, repr=False)


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@functools.lru_cache(maxsize=None)
def gn_silu_plan(N: int, HW: int, C: int, G: int, dtype: torch.dtype,
                 sms: int = GNS_SMS) -> GnSiluPlan:
    """The launch plan of the GroupNorm(+SiLU) kernels for an (N, HW, C)
    map in G groups. Vectors of 16 bytes where the group's channels allow
    (4 fp32, 8 bf16; else 4 or single elements). A slice of V vectors takes
    the power of two of threads that gives each GNS_NV_AIM vectors, at
    least a warp unless the slice is smaller, and at most what keeps all N
    G slices within about half the card's thread slots (1024 an SM), so
    that they run in one wave at up to 64 registers a thread; more where a
    thread would hold more than GNS_NV_MAX vectors, up to 1024 threads;
    past that, the L2 route."""
    if C % G:
        raise ValueError(f"{C} channels do not split into {G} groups")
    cg = C // G
    widths = (8, 4, 1) if dtype == torch.bfloat16 else (4, 1)
    vw = next(w for w in widths if cg % w == 0)
    nvec, nv_max = HW * cg // vw, GNS_NV_MAX[vw]
    cap = max(32, 1 << max(0, (sms * GNS_MAX_THREADS) // (N * G)).bit_length() - 1)
    tps = max(min(_pow2ceil(-(-nvec // GNS_NV_AIM)), cap), min(32, _pow2ceil(nvec)))
    tps = min(tps, GNS_MAX_THREADS)
    while -(-nvec // tps) > nv_max and tps < GNS_MAX_THREADS:
        tps *= 2
    nv = -(-nvec // tps)
    threads = tps if tps > 32 else GNS_BLOCK
    if nv <= nv_max and nvec <= GNS_MAX_VECS and 8 * (threads // tps) * cg <= GNS_MAX_SMEM:
        route, blocks = 0, -(-(N * G) // (threads // tps))
    else:
        route, nv, tps, threads, blocks = 1, 1, 1024, 1024, N * G  # nv: unused
    ints = (route, vw, nv, tps, threads)
    return GnSiluPlan(("registers", "l2")[route], vw, nv, tps, threads, blocks, ints,
                      (ctypes.c_int * len(ints))(*ints))


def _gn_silu_kernel(cfg, x, scale, bias):
    num_groups, eps = cfg
    if x.dtype not in _cuda.DTYPE_CODE or x.ndim != 4 or x.shape[3] % num_groups:
        raise ValueError(f"group_norm_silu_fused takes NHWC fp32 or bf16 whose channels "
                         f"split into {num_groups} groups; got {x.dtype} {tuple(x.shape)}")
    N, H, W, C = x.shape
    dev = x.device
    p_x = _cuda.check_operand(x, "x", dev, x.dtype)
    gamma = scale.detach().to(device=dev, dtype=torch.float32).contiguous()
    beta = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    p_g = _cuda.check_operand(gamma, "scale", dev, torch.float32, (C,))
    p_b = _cuda.check_operand(beta, "bias", dev, torch.float32, (C,))
    plan = gn_silu_plan(N, H * W, C, num_groups, x.dtype, _cuda.num_sms(dev))
    out = torch.empty_like(x)
    err = _cuda.lib().diffpure_gn_silu(
        _cuda.DTYPE_CODE[x.dtype], p_x, p_g, p_b, N, H * W, C, num_groups, eps,
        out.data_ptr(), plan.c_ints, _cuda.stream(dev))
    _cuda.check(err, "group_norm_silu_fused kernel")
    group_norm_silu_fused.launches += 1
    return out


_GN_SILU = (_gn_silu_kernel,
            lambda cfg, x, scale, bias: group_norm_silu_fused_reference(x, scale, bias, *cfg),
            _cuda.autograd_vjp(lambda cfg, x, scale, bias: group_norm_silu(x, scale, bias,
                                                                            *cfg)))


def group_norm_silu_fused(x: Tensor, scale: Tensor, bias: Tensor,
                          num_groups: int, eps: float = 1e-6) -> Tensor:
    """silu(GroupNorm(x)) with one rounding, x (N, H, W, C) fp32 or bf16,
    scale and bias (C,): plain on CPU, the CUDA kernel on CUDA.
    Differentiable: the gradient is autograd of the plain chain
    ``group_norm_silu``, as JAX's default path takes it.

    JAX gates its kernel on the TPU backend, ``set_fused_gn_silu`` and the
    map fitting VMEM (layers.py:83-84). The port has no global kernel
    switches (ROADMAP item 3) and the kernel takes every map size, so none
    of those gates is kept.

    On the card the kernel is bound by latency and bytes: one read and one
    write of the map, with each (example, group) slice held in registers in
    between (``gn_silu_plan``: a warp or less a slice at small maps, up to
    1024 threads at large ones; above 128 KB of fp32 a slice, a route that
    re-reads it from L2), fp32 two-pass statistics from the registers, and
    one rounding at the store.
    """
    _cuda.check_device("group_norm_silu_fused", x)
    return _cuda.KernelFunction.apply(_GN_SILU, (num_groups, eps), x, scale, bias)


# Kernel launches since the last reset (plain CPU calls do not count).
group_norm_silu_fused.launches = 0
