"""Fused BigGAN residual block (NCSN++ ResnetBlockBigGANpp, eval mode).

Port of diffpure_tpu/ops/fused_resblock.py. Two forms of one function:

- ``fused_resblock_reference``: plain PyTorch, the port of the JAX
  ``fused_resblock_reference`` (:587) and the oracle of the kernel;
- ``fused_resblock`` / ``fused_resblock_cat``: the wrappers of the CUDA
  kernel in ``csrc/fused_resblock.cu`` (replacing ``fused_resblock_pallas``
  :290 and ``fused_resblock_cat_pallas`` :728). On a CPU tensor they run the
  plain version; on a CUDA tensor they launch the kernel or raise.

The block: GN1 (fp32 stats, eps 1e-6) + SiLU -> optional naive 2x
down/up-sample of h and of the skip input -> conv3x3 + b0 + temb row ->
GN2 + SiLU -> conv3x3 + b1 -> optional 1x1 projection (+ bias) of the skip
-> (skip + h) * 1/sqrt(2). Weights are in PyTorch layout: convs OIHW, the
projection (cout, cin).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops.conv import conv2d_nhwc
from diffpure_tpu_torch.ops.groupnorm import group_norm
from diffpure_tpu_torch.ops.upfirdn2d import naive_downsample_2d, \
    naive_upsample_2d

Tensor = torch.Tensor
INV_SQRT2 = float(1.0 / np.sqrt(2.0))
_RESAMPLE = {"none": 0, "down": 1, "up": 2}


def fused_resblock_reference(x: Tensor, temb_row: Tensor, params: Tuple,
                             *, num_groups1: int, num_groups2: int,
                             eps: float = 1e-6, rescale: bool = True,
                             resample: str = "none") -> Tensor:
    """Plain version. params = (gn1_scale, gn1_bias, w0 (cout, cin, 3, 3),
    b0, gn2_scale, gn2_bias, w1 (cout, cout, 3, 3), b1, wskip (cout, cin) |
    None, bskip | None).

    Convs run in x's dtype and their outputs are taken to fp32; GroupNorm
    and the sums are fp32, as in the JAX reference.
    """
    gn1s, gn1b, w0, b0, gn2s, gn2b, w1, b1, wskip, bskip = params
    cdt = x.dtype
    h = F.silu(group_norm(x.float(), gn1s, gn1b, num_groups1, eps))
    if resample == "down":
        h = naive_downsample_2d(h)
        x = naive_downsample_2d(x)
    elif resample == "up":
        h = naive_upsample_2d(h)
        x = naive_upsample_2d(x)
    h = conv2d_nhwc(h.to(cdt), w0.to(cdt)).float()
    h = h + b0.float() + temb_row.float()[:, None, None, :]
    h = F.silu(group_norm(h, gn2s, gn2b, num_groups2, eps))
    h = conv2d_nhwc(h.to(cdt), w1.to(cdt)).float() + b1.float()
    if wskip is not None:
        xs = torch.matmul(x.to(cdt), wskip.to(cdt).t()).float() + bskip.float()
    else:
        xs = x.float()
    out = xs + h
    if rescale:
        out = out * INV_SQRT2
    return out.to(cdt)


@dataclasses.dataclass(frozen=True)
class PackedResblock:
    """Block weights in the kernel's layout, for one compute dtype."""
    cin: int
    cout: int
    gn1s: Tensor   # (cin,) fp32
    gn1b: Tensor
    w0: Tensor     # (cout, 9 * cin): column (3 * dy + dx) * cin + c
    b0: Tensor     # (cout,) fp32
    gn2s: Tensor   # (cout,) fp32
    gn2b: Tensor
    w1: Tensor     # (cout, 9 * cout [+ cin]): conv1's columns, then wskip's
    bias1: Tensor  # (cout,) fp32: b1 [+ bskip]
    has_proj: bool


def pack_resblock_params(params: Tuple, dtype: torch.dtype,
                         device) -> PackedResblock:
    """Repack PyTorch-layout block weights for the kernel (done once per
    module and dtype by the caller, not per launch)."""
    gn1s, gn1b, w0, b0, gn2s, gn2b, w1, b1, wskip, bskip = params
    cout, cin = w0.shape[:2]

    def f32(t):
        return t.detach().to(device, torch.float32).contiguous()

    with torch.no_grad():
        w0p = w0.detach().permute(0, 2, 3, 1).reshape(cout, 9 * cin)
        w1p = w1.detach().permute(0, 2, 3, 1).reshape(cout, 9 * cout)
        bias1 = f32(b1)
        if wskip is not None:
            w1p = torch.cat([w1p, wskip.detach().reshape(cout, cin)], 1)
            bias1 = bias1 + f32(bskip)
        return PackedResblock(
            cin=cin, cout=cout, gn1s=f32(gn1s), gn1b=f32(gn1b),
            w0=w0p.to(device, dtype).contiguous(), b0=f32(b0),
            gn2s=f32(gn2s), gn2b=f32(gn2b),
            w1=w1p.to(device, dtype).contiguous(), bias1=bias1.contiguous(),
            has_proj=wskip is not None)


def _launch(x1: Tensor, x2: Optional[Tensor], temb_row: Tensor,
            pk: PackedResblock, g1: int, g2: int, eps: float, rescale: bool,
            resample: str) -> Tensor:
    dev, dtype = x1.device, x1.dtype
    if dtype not in _cuda.DTYPE_CODE:
        raise ValueError(f"fused_resblock takes fp32 or bf16, not {dtype}")
    if x1.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x1.shape)}")
    N, H, W, c1 = x1.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    cin, cout = c1 + c2, pk.cout
    if resample not in _RESAMPLE:
        raise ValueError(f"resample must be none|down|up, not {resample!r}")
    if pk.cin != cin or pk.w0.dtype != dtype or pk.w0.device != dev:
        raise ValueError("packed weights do not match the input "
                         f"(cin {pk.cin} vs {cin}, {pk.w0.dtype} on {pk.w0.device})")
    if c1 % 4 or c2 % 4 or cout % 4:
        raise ValueError(f"channel counts must be multiples of 4: {c1}, {c2}, {cout}")
    if cin % g1 or cout % g2:
        raise ValueError(f"groups {g1}, {g2} do not divide channels {cin}, {cout}")
    if resample == "down" and (H % 2 or W % 2):
        raise ValueError(f"down-sampling needs even H, W, got {H}x{W}")
    if not pk.has_proj and cin != cout:
        raise ValueError(f"an identity skip needs cin == cout, got {cin}, {cout}")
    if x2 is not None and (not pk.has_proj or resample != "none"):
        raise ValueError("the concat kernel needs a projection and resample 'none'")
    Ho, Wo = {"none": (H, W), "down": (H // 2, W // 2),
              "up": (H * 2, W * 2)}[resample]

    p_x1 = _cuda.check_operand(x1, "x1", dev, dtype)
    p_x2 = None if x2 is None else _cuda.check_operand(
        x2, "x2", dev, dtype, (N, H, W, c2))
    temb = temb_row.to(dtype).contiguous()  # the TPU kernel casts temb to x's dtype
    p_temb = _cuda.check_operand(temb, "temb_row", dev, dtype, (N, cout))

    out = torch.empty((N, Ho, Wo, cout), device=dev, dtype=dtype)
    esize, pix = out.element_size(), N * Ho * Wo
    # act1, xs (the resampled x; up/down only), h1 (fp32), act2; buf owns
    # the memory while the kernels are queued on the stream
    buf, (act1, xs, h1, act2), ws = _cuda.scratch(
        dev, pix * cin * esize, pix * cin * esize if resample != "none" else 0,
        pix * cout * 4, pix * cout * esize)
    err = _cuda.lib().diffpure_resblock_fwd(
        _cuda.DTYPE_CODE[dtype], p_x1, p_x2, c1, c2, N, H, W,
        _RESAMPLE[resample], p_temb,
        pk.gn1s.data_ptr(), pk.gn1b.data_ptr(), g1, pk.w0.data_ptr(),
        pk.b0.data_ptr(), pk.gn2s.data_ptr(), pk.gn2b.data_ptr(), g2,
        pk.w1.data_ptr(), pk.bias1.data_ptr(), int(pk.has_proj), cout,
        eps, INV_SQRT2 if rescale else 1.0,
        act1, xs, h1, act2, ws, _cuda.SPLITK_WORKSPACE, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "fused_resblock kernel")
    return out


def fused_resblock(x: Tensor, temb_row: Tensor, params: Tuple, *,
                   num_groups1: int, num_groups2: int, eps: float = 1e-6,
                   rescale: bool = True, resample: str = "none",
                   packed: Optional[PackedResblock] = None) -> Tensor:
    """The block on one NHWC input: plain on CPU, the CUDA kernel on CUDA.
    ``packed``: the weights from ``pack_resblock_params`` (packed here when
    omitted)."""
    _cuda.refuse_grad(x, temb_row, *params)
    if x.device.type == "cpu":
        return fused_resblock_reference(
            x, temb_row, params, num_groups1=num_groups1,
            num_groups2=num_groups2, eps=eps, rescale=rescale,
            resample=resample)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock runs on cpu or cuda, not {x.device}")
    pk = packed or pack_resblock_params(params, x.dtype, x.device)
    out = _launch(x, None, temb_row, pk, num_groups1, num_groups2, eps,
                  rescale, resample)
    fused_resblock.launches += 1
    return out


def fused_resblock_cat(x1: Tensor, x2: Tensor, temb_row: Tensor,
                       params: Tuple, *, num_groups1: int, num_groups2: int,
                       eps: float = 1e-6, rescale: bool = True,
                       packed: Optional[PackedResblock] = None) -> Tensor:
    """The block on concat(x1, x2) along channels, without materialising
    the concat on CUDA; GN1 statistics span the seam. Needs a projection."""
    _cuda.refuse_grad(x1, x2, temb_row, *params)
    if params[8] is None:
        raise ValueError("concat blocks always project the skip")
    if x1.device.type == "cpu":
        return fused_resblock_reference(
            torch.cat([x1, x2], dim=-1), temb_row, params,
            num_groups1=num_groups1, num_groups2=num_groups2, eps=eps,
            rescale=rescale)
    if x1.device.type != "cuda":
        raise ValueError(f"fused_resblock_cat runs on cpu or cuda, not {x1.device}")
    pk = packed or pack_resblock_params(params, x1.dtype, x1.device)
    out = _launch(x1, x2, temb_row, pk, num_groups1, num_groups2, eps,
                  rescale, "none")
    fused_resblock_cat.launches += 1
    return out


# Kernel launches since the last reset (plain CPU calls do not count).
fused_resblock.launches = 0
fused_resblock_cat.launches = 0
