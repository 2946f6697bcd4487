"""Tiled two-pass GroupNorm(+FiLM)(+SiLU) for the large maps of the 256-px
UNets (port of diffpure_tpu/ops/tiled_groupnorm.py).

  pass 1, ``group_stats``: per-(example, row tile, channel) sums of x and
     x^2 in fp32 (the CUDA kernel in ``csrc/tiled_groupnorm.cu`` replaces
     ``_stats_kernel`` of ``group_stats_affine``, :37-96);
  combine, plain tensor code as in JAX (:98-133): group statistics, then a
     per-(example, channel) affine A, B folding the GN scale/bias, the ADM
     FiLM (1 + s), shift and an optional pre-GN shift;
  pass 2, ``gn_film_silu_apply``: out = [silu](x A + B), one read and one
     write (replaces ``_norm_kernel`` of ``group_norm_film_silu_tiled``,
     :44, :136).

Each launching wrapper runs its plain version on a CPU tensor and its
kernel on a CUDA tensor, or raises. The variance is the one-pass
E[x^2] - mean^2 of the JAX combine.

Gradients, as JAX's ``custom_vjp`` (:193-222): ``group_norm_film_silu``
is an autograd ``Function`` (``_cuda.KernelFunction``) whose forward is
the two kernels (their plain versions on the CPU) and whose backward is
autograd of ``group_norm_film_silu_reference``, the two-pass chain, not
of the kernels' one-pass combine. The models reach pass 1 and 2 only
through it and through ``halo_conv.gn_silu_conv_block``. The two passes,
public on their own (chip_smoke.py calls them so), get a ``Function``
each, whose backward is autograd of their own plain version, so that a
direct call on a differentiable tensor has its gradient too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops.groupnorm import group_norm

Tensor = torch.Tensor

# the stats kernel's grid: about this many blocks of (rows x W pixels, 256
# channels), so that every SM has several in flight
_TARGET_BLOCKS = 1024


def _rows_per_tile(N: int, H: int, C: int) -> int:
    chunks = -(-C // 256)
    tiles = max(1, min(H, -(-_TARGET_BLOCKS // (N * chunks))))
    return -(-H // tiles)


def group_sums_reference(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of ``group_stats``: one tile per example, (N, 1, C)."""
    x32 = x.float()
    return x32.sum(dim=(1, 2))[:, None], (x32 * x32).sum(dim=(1, 2))[:, None]


def _stats_kernel(x: Tensor) -> Tuple[Tensor, Tensor]:
    if x.dtype not in _cuda.DTYPE_CODE or x.ndim != 4 or x.shape[3] % 4:
        raise ValueError(f"group_stats takes NHWC fp32 or bf16 with C % 4 == 0; "
                         f"got {x.dtype} {tuple(x.shape)}")
    N, H, W, C = x.shape
    rows = _rows_per_tile(N, H, C)
    tiles = -(-H // rows)
    p_x = _cuda.check_operand(x, "x", x.device, x.dtype)
    sums = torch.empty(N, tiles, C, device=x.device, dtype=torch.float32)
    sqs = torch.empty_like(sums)
    err = _cuda.lib().diffpure_group_stats(
        _cuda.DTYPE_CODE[x.dtype], p_x, N, H, W, C, rows, sums.data_ptr(),
        sqs.data_ptr(), _cuda.stream(x.device))
    _cuda.check(err, "group_stats kernel")
    group_stats.launches += 1
    return sums, sqs


def _sums_plain(cfg, x):
    return group_sums_reference(x)


_STATS = ((lambda cfg, x: _stats_kernel(x)), _sums_plain, _cuda.autograd_vjp(_sums_plain))


def group_stats(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Sums of x and x^2 per (example, row tile, channel), fp32 (N, tiles,
    C): plain on CPU, the CUDA kernel on CUDA; differentiable."""
    _cuda.check_device("group_stats", x)
    return _cuda.KernelFunction.apply(_STATS, None, x)


def _affine(sums: Tensor, sqs: Tensor, hw: int, scale: Tensor, bias: Tensor,
            num_groups: int, eps: float, film_scale: Optional[Tensor],
            film_shift: Optional[Tensor], pre_shift: Optional[Tensor]
            ) -> Tuple[Tensor, Tensor]:
    """The JAX combine (:98-133): partial sums -> (A, B), (N, C) fp32."""
    N, _, C = sums.shape
    G = num_groups
    if C % G:
        raise ValueError(f"{C} channels do not split into {G} groups")
    n_per_group = hw * (C // G)
    s_c, q_c = sums.sum(dim=1), sqs.sum(dim=1)
    mean_g = s_c.reshape(N, G, C // G).sum(-1) / n_per_group
    var_g = q_c.reshape(N, G, C // G).sum(-1) / n_per_group - mean_g * mean_g
    if pre_shift is not None:
        # mean' = mean + E[t], var' = var + 2 cov(x, t) + var(t), as in JAX
        sh = pre_shift.float()
        t_mean_g = sh.reshape(N, G, C // G).mean(-1)
        xt_g = (sh * s_c).reshape(N, G, C // G).sum(-1) / n_per_group
        t2_g = (sh * sh).reshape(N, G, C // G).sum(-1) * hw / n_per_group
        var_g = var_g + 2.0 * (xt_g - mean_g * t_mean_g) \
            + (t2_g - t_mean_g * t_mean_g)
        mean_g = mean_g + t_mean_g
    rstd_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(C // G, dim=-1)
    rstd_c = rstd_g.repeat_interleave(C // G, dim=-1)
    A = rstd_c * scale.float()[None, :]
    B = bias.float()[None, :] - mean_c * A
    if film_scale is not None:
        fs = 1.0 + film_scale.float()
        A = A * fs
        B = B * fs + film_shift.float()
    if pre_shift is not None:
        B = B + sh * A
    return A.contiguous(), B.contiguous()


def group_stats_affine(x: Tensor, scale: Tensor, bias: Tensor, num_groups: int,
                       eps: float = 1e-5, film_scale: Optional[Tensor] = None,
                       film_shift: Optional[Tensor] = None,
                       pre_shift: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor]:
    """(A, B), per-(example, channel) fp32, such that
    GN(x + pre_shift) * (1 + film_scale) + film_shift == x A + B."""
    sums, sqs = group_stats(x)
    return _affine(sums, sqs, x.shape[1] * x.shape[2], scale, bias, num_groups,
                   eps, film_scale, film_shift, pre_shift)


def group_stats_affine_reference(x: Tensor, scale: Tensor, bias: Tensor,
                                 num_groups: int, eps: float = 1e-5,
                                 film_scale: Optional[Tensor] = None,
                                 film_shift: Optional[Tensor] = None,
                                 pre_shift: Optional[Tensor] = None
                                 ) -> Tuple[Tensor, Tensor]:
    """Plain version of ``group_stats_affine``: the same combine over plain
    per-example sums."""
    sums, sqs = group_sums_reference(x)
    return _affine(sums, sqs, x.shape[1] * x.shape[2], scale, bias, num_groups,
                   eps, film_scale, film_shift, pre_shift)


def gn_film_silu_apply_reference(x: Tensor, A: Tensor, B: Tensor,
                                 apply_silu: bool = True) -> Tensor:
    """Plain version of ``gn_film_silu_apply``."""
    h = x.float() * A[:, None, None, :] + B[:, None, None, :]
    if apply_silu:
        h = h * torch.sigmoid(h)
    return h.to(x.dtype)


def _apply_kernel(x: Tensor, A: Tensor, B: Tensor, apply_silu: bool) -> Tensor:
    if x.dtype not in _cuda.DTYPE_CODE or x.ndim != 4 or x.shape[3] % 4:
        raise ValueError(f"gn_film_silu_apply takes NHWC fp32 or bf16 with "
                         f"C % 4 == 0; got {x.dtype} {tuple(x.shape)}")
    N, H, W, C = x.shape
    dev = x.device
    p_x = _cuda.check_operand(x, "x", dev, x.dtype)
    p_a = _cuda.check_operand(A, "A", dev, torch.float32, (N, C))
    p_b = _cuda.check_operand(B, "B", dev, torch.float32, (N, C))
    out = torch.empty_like(x)
    err = _cuda.lib().diffpure_gn_apply(
        _cuda.DTYPE_CODE[x.dtype], p_x, p_a, p_b, N, H, W, C, int(apply_silu),
        out.data_ptr(), _cuda.stream(dev))
    _cuda.check(err, "gn_film_silu_apply kernel")
    gn_film_silu_apply.launches += 1
    return out


def _apply_plain(apply_silu, x, A, B):
    return gn_film_silu_apply_reference(x, A, B, apply_silu)


_APPLY = ((lambda apply_silu, x, A, B: _apply_kernel(x, A, B, apply_silu)), _apply_plain,
          _cuda.autograd_vjp(_apply_plain))


def gn_film_silu_apply(x: Tensor, A: Tensor, B: Tensor,
                       apply_silu: bool = True) -> Tensor:
    """[silu](x A + B) in x's dtype, A and B (N, C) fp32: plain on CPU, the
    CUDA kernel on CUDA; differentiable."""
    _cuda.check_device("gn_film_silu_apply", x)
    return _cuda.KernelFunction.apply(_APPLY, bool(apply_silu), x, A, B)


def _gnfs_kernel(cfg, x, scale, bias, film_scale, film_shift):
    num_groups, eps, apply_silu = cfg
    sums, sqs = _stats_kernel(x)
    A, B = _affine(sums, sqs, x.shape[1] * x.shape[2], scale, bias, num_groups, eps,
                   film_scale, film_shift, None)
    return _apply_kernel(x, A, B, apply_silu)


def _gnfs_plain(cfg, x, scale, bias, film_scale, film_shift):
    num_groups, eps, apply_silu = cfg
    A, B = group_stats_affine_reference(x, scale, bias, num_groups, eps, film_scale,
                                        film_shift)
    return gn_film_silu_apply_reference(x, A, B, apply_silu)


def _gnfs_grad(cfg, x, scale, bias, film_scale, film_shift):
    num_groups, eps, apply_silu = cfg
    return group_norm_film_silu_reference(x, scale, bias, num_groups, eps, film_scale,
                                          film_shift, apply_silu)


_GNFS = (_gnfs_kernel, _gnfs_plain, _cuda.autograd_vjp(_gnfs_grad))


def group_norm_film_silu_tiled(x: Tensor, scale: Tensor, bias: Tensor,
                               num_groups: int, eps: float = 1e-5,
                               film_scale: Optional[Tensor] = None,
                               film_shift: Optional[Tensor] = None,
                               apply_silu: bool = True) -> Tensor:
    """silu(GN(x) * (1 + film_scale) + film_shift) in 2 reads + 1 write.
    x (N, H, W, C); scale, bias (C,); film_scale, film_shift (N, C) or None.
    Differentiable: the gradient is autograd of
    ``group_norm_film_silu_reference`` (JAX's ``_gnfs_bwd``, :213)."""
    _cuda.check_device("group_norm_film_silu", x)
    return _cuda.KernelFunction.apply(_GNFS, (num_groups, eps, bool(apply_silu)), x,
                                      scale, bias, film_scale, film_shift)


# The model's entry point (JAX's custom_vjp wrapper of the tiled op, :194).
group_norm_film_silu = group_norm_film_silu_tiled


def group_norm_film_silu_reference(x: Tensor, scale: Tensor, bias: Tensor,
                                   num_groups: int, eps: float = 1e-5,
                                   film_scale: Optional[Tensor] = None,
                                   film_shift: Optional[Tensor] = None,
                                   apply_silu: bool = True) -> Tensor:
    """Plain version (:175): fp32 statistics, the GN scale and bias rounded
    to x's dtype first, as in JAX."""
    h = group_norm(x, scale.to(x.dtype), bias.to(x.dtype), num_groups,
                   eps).float()
    if film_scale is not None:
        h = h * (1.0 + film_scale.float()[:, None, None, :]) \
            + film_shift.float()[:, None, None, :]
    if apply_silu:
        h = h * torch.sigmoid(h)
    return h.to(x.dtype)


# Kernel launches since the last reset (plain CPU calls do not count).
group_stats.launches = 0
gn_film_silu_apply.launches = 0
