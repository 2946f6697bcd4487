"""Fused normalise + SiLU + 3x3 conv (+ skip) for the large maps of the
256-px UNets (port of diffpure_tpu/ops/halo_conv.py).

    out = conv3x3(silu(x * A + B), w) + b  [+ skip | + skip @ w_proj]

``gn_silu_conv3x3_halo`` launches the CUDA kernel in ``csrc/halo_conv.cu``
(replacing ``gn_silu_conv3x3_halo_pallas``, :168) on a CUDA tensor and runs
its plain version ``gn_silu_conv3x3_reference`` (:241) on a CPU tensor.
``gn_silu_conv_block`` (:298) is the two-kernel stage: the GroupNorm stats
pass (ops/tiled_groupnorm.py) gives A, B with GN scale/bias and the FiLM
scale-shift folded in, then the halo conv. SAME padding pads the
activation. The kernel takes every shape of the ImageNet-256 path
(H % 4 == 0, W % 32 == 0, cin and cr % 32 == 0, cout % 64 == 0) and raises
on others: the TPU wrapper's fallback to the XLA reference, which exists
for the TPU's 16 MB of VMEM (``_pick_tile_halo``, :37-70, 185-192), is not
ported. Forward only on the card, as ops/tiled_groupnorm.py.

Weights keep the JAX layouts at these functions: w (3, 3, cin, cout) HWIO,
w_proj (cr, cout).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops.conv import conv2d_nhwc
from diffpure_tpu_torch.ops.groupnorm import group_norm
from diffpure_tpu_torch.ops.tiled_groupnorm import group_stats_affine

Tensor = torch.Tensor


def _compute_dtype(x: Tensor) -> torch.dtype:
    return x.dtype if x.dtype in (torch.bfloat16, torch.float32) else torch.float32


def _conv_skip(h: Tensor, w: Tensor, bias: Tensor, skip: Optional[Tensor],
               w_proj: Optional[Tensor], cdt: torch.dtype) -> Tensor:
    """conv3x3(h) + b [+ skip | + skip @ w_proj] in fp32, each product in
    cdt (rounded to cdt, as JAX's products are)."""
    y = conv2d_nhwc(h.to(cdt), w.permute(3, 2, 0, 1).to(cdt)).float()
    y = y + bias.float()
    if skip is not None:
        if w_proj is not None:
            y = y + torch.matmul(skip.to(cdt), w_proj.to(cdt)).float()
        else:
            y = y + skip.float()
    return y


def gn_silu_conv3x3_reference(x: Tensor, A: Tensor, B: Tensor, w: Tensor,
                              bias: Tensor, *, skip: Optional[Tensor] = None,
                              w_proj: Optional[Tensor] = None,
                              out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """Plain version of ``gn_silu_conv3x3_halo``."""
    h = x.float() * A[:, None, None, :].float() + B[:, None, None, :].float()
    h = h * torch.sigmoid(h)
    y = _conv_skip(h, w, bias, skip, w_proj, _compute_dtype(x))
    return y.to(out_dtype or x.dtype)


def gn_conv_block_reference(x: Tensor, gn_scale: Tensor, gn_bias: Tensor,
                            film_scale: Optional[Tensor],
                            film_shift: Optional[Tensor], w: Tensor,
                            bias: Tensor, skip: Optional[Tensor],
                            w_proj: Optional[Tensor], num_groups: int,
                            eps: float, pre_shift: Optional[Tensor] = None
                            ) -> Tensor:
    """Plain version of the whole stage (:264):
    conv3x3(silu(GN(x + pre_shift) (1 + fs) + ft), w) + b [+ skip(@w_proj)]."""
    x32 = x.float()
    if pre_shift is not None:
        x32 = x32 + pre_shift.float()[:, None, None, :]
    h = group_norm(x32, gn_scale, gn_bias, num_groups, eps)
    if film_scale is not None:
        h = h * (1.0 + film_scale.float()[:, None, None, :]) \
            + film_shift.float()[:, None, None, :]
    h = h * torch.sigmoid(h)
    return _conv_skip(h, w, bias, skip, w_proj, _compute_dtype(x)).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class PackedHalo:
    """Conv weights in the kernel's layout for one dtype: bf16 w (cout,
    9 cin) and w_proj (cout, cr), each output channel's row contiguous;
    fp32 w (9 cin, cout) and w_proj (cr, cout)."""
    w: Tensor
    w_proj: Optional[Tensor]
    cin: int
    cout: int


def pack_halo_weights(w: Tensor, w_proj: Optional[Tensor], dtype: torch.dtype,
                      device) -> PackedHalo:
    """w (3, 3, cin, cout) HWIO, w_proj (cr, cout) or None."""
    cin, cout = w.shape[2], w.shape[3]
    with torch.no_grad():
        w = w.detach().to(device, dtype)
        wp = None if w_proj is None else w_proj.detach().to(device, dtype)
        if dtype == torch.bfloat16:
            wk = w.permute(3, 0, 1, 2).reshape(cout, 9 * cin)
            wp = None if wp is None else wp.t()
        else:
            wk = w.reshape(9 * cin, cout)
        return PackedHalo(wk.contiguous(), None if wp is None else wp.contiguous(),
                          cin, cout)


def _launch(x: Tensor, A: Tensor, B: Tensor, w: Tensor, bias: Tensor,
            skip: Optional[Tensor], w_proj: Optional[Tensor],
            packed: Optional[PackedHalo]) -> Tensor:
    dev, dtype = x.device, x.dtype
    if dtype not in _cuda.DTYPE_CODE or x.ndim != 4:
        raise ValueError(f"the halo conv takes NHWC fp32 or bf16, not {dtype} "
                         f"{tuple(x.shape)}")
    N, H, W, cin = x.shape
    cout = w.shape[-1]
    cr = skip.shape[-1] if skip is not None else 0
    if tuple(w.shape) != (3, 3, cin, cout) or H % 4 or W % 32 or cin % 32 \
            or cout % 64 or cr % 32:
        raise ValueError(f"the halo conv takes H % 4 == 0, W % 32 == 0, cin and "
                         f"cr % 32 == 0, cout % 64 == 0 and a (3, 3, cin, cout) "
                         f"kernel; got x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"skip channels {cr}")
    if skip is not None and w_proj is None and cr != cout:
        raise ValueError(f"an identity skip needs {cout} channels, not {cr}")
    if w_proj is not None and (skip is None or tuple(w_proj.shape) != (cr, cout)):
        raise ValueError("w_proj needs a skip and the shape (cr, cout)")
    pk = packed or pack_halo_weights(w, w_proj, dtype, dev)
    if pk.cin != cin or pk.cout != cout or pk.w.dtype != dtype or pk.w.device != dev \
            or (pk.w_proj is None) != (w_proj is None):
        raise ValueError("packed weights do not match the input")
    p_x = _cuda.check_operand(x, "x", dev, dtype)
    p_a = _cuda.check_operand(A, "A", dev, torch.float32, (N, cin))
    p_b = _cuda.check_operand(B, "B", dev, torch.float32, (N, cin))
    b32 = bias.detach().to(dev, torch.float32).contiguous()
    p_bias = _cuda.check_operand(b32, "bias", dev, torch.float32, (cout,))
    p_skip = 0 if skip is None else _cuda.check_operand(
        skip, "skip", dev, dtype, (N, H, W, cr))
    out = torch.empty(N, H, W, cout, device=dev, dtype=dtype)
    err = _cuda.lib().diffpure_halo_conv(
        _cuda.DTYPE_CODE[dtype], p_x, N, H, W, cin, p_a, p_b, pk.w.data_ptr(),
        p_bias, p_skip, cr, 0 if pk.w_proj is None else pk.w_proj.data_ptr(),
        cout, out.data_ptr(), _cuda.stream(dev))
    _cuda.check(err, "halo conv kernel")
    return out


def gn_silu_conv3x3_halo(x: Tensor, A: Tensor, B: Tensor, w: Tensor,
                         bias: Tensor, *, skip: Optional[Tensor] = None,
                         w_proj: Optional[Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None,
                         packed: Optional[PackedHalo] = None) -> Tensor:
    """conv3x3(silu(x A + B), w) + b [+ skip | + skip @ w_proj]: plain on
    CPU, the CUDA kernel on CUDA. x (N, H, W, cin); A, B (N, cin) fp32;
    skip (N, H, W, cr), an identity skip when w_proj is None (cr == cout)."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_reference(x, A, B, w, bias, skip=skip,
                                         w_proj=w_proj, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"the halo conv runs on cpu or cuda, not {x.device}")
    _cuda.refuse_card_grad("gn_silu_conv3x3_halo", x, A, B, w, bias, skip, w_proj)
    if (out_dtype or x.dtype) != x.dtype:
        raise ValueError("the halo conv writes its output in x's dtype")
    out = _launch(x, A, B, w, bias, skip, w_proj, packed)
    gn_silu_conv3x3_halo.launches += 1
    return out


def gn_silu_conv_block(x: Tensor, gn_scale: Tensor, gn_bias: Tensor,
                       film_scale: Optional[Tensor],
                       film_shift: Optional[Tensor], w: Tensor, bias: Tensor,
                       skip: Optional[Tensor], w_proj: Optional[Tensor],
                       pre_shift: Optional[Tensor], num_groups: int,
                       eps: float, packed: Optional[PackedHalo] = None
                       ) -> Tensor:
    """GN(+FiLM)+SiLU+conv3x3(+skip) as [stats pass -> halo conv]; pre_shift
    (N, C) is added before the GN, folded into the affine."""
    A, B = group_stats_affine(x, gn_scale, gn_bias, num_groups, eps,
                              film_scale, film_shift, pre_shift=pre_shift)
    return gn_silu_conv3x3_halo(x, A, B, w, bias, skip=skip, w_proj=w_proj,
                                out_dtype=x.dtype, packed=packed)


# Kernel launches since the last reset (plain CPU calls do not count).
gn_silu_conv3x3_halo.launches = 0
