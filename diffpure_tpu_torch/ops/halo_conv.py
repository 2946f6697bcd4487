"""Fused normalise + SiLU + 3x3 conv (+ skip) for the large maps of the
256-px UNets (port of diffpure_tpu/ops/halo_conv.py).

    out = conv3x3(silu(x * A + B), w) + b  [+ skip | + skip @ w_proj]

``gn_silu_conv3x3_halo`` launches the CUDA kernel in ``csrc/halo_conv.cu``
(replacing ``gn_silu_conv3x3_halo_pallas``, :168) on a CUDA tensor and runs
its plain version ``gn_silu_conv3x3_reference`` (:241) on a CPU tensor.
``gn_silu_conv_block`` (:298) is the two-kernel stage: the GroupNorm stats
pass (ops/tiled_groupnorm.py) gives A, B with GN scale/bias and the FiLM
scale-shift folded in, then the halo conv. SAME padding pads the
activation. The kernel takes every shape of the ImageNet-256 path (bf16:
W % 32 == 0, cin and cr % 64 == 0, cout % 128 == 0 and H even, tiled as
``halo_plan`` says; fp32: H % 4 == 0, W % 32 == 0, cin and cr % 32 == 0,
cout % 64 == 0) and raises on others: the TPU wrapper's fallback to the
XLA reference, which exists for the TPU's 16 MB of VMEM
(``_pick_tile_halo``, :37-70, 185-192), is not ported.

Gradients, as JAX's ``custom_vjp`` on ``gn_silu_conv_block`` (:297-386):
the stage is an autograd ``Function`` (``_cuda.KernelFunction``) that
saves its inputs and whose backward is autograd of
``gn_conv_block_reference`` (``_gcb_bwd``, :345), recomputed from the HWIO
weights (never from the kernel's pack), with the film, skip, w_proj and
pre_shift inputs present or absent as the call has them.
``gn_silu_conv3x3_halo``, which the models reach only through the stage,
gets a ``Function`` of its own (backward: autograd of
``gn_silu_conv3x3_reference``), so that a direct call is differentiable.

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
from diffpure_tpu_torch.ops.tiled_groupnorm import _affine, _stats_kernel, \
    group_stats_affine_reference

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


# The bf16 kernel's K chunk: 64 input channels, one 128-byte row of a
# weight stage.
KC = 64
# SMs of the card the plan fills (NVIDIA H100 SXM).
SMS = 132
# bf16 tiles (rows of 32 pixels, output channels), largest first; of two
# the same size, the wider in channels (it activates each window element
# once for more output channels: 2 x 256 beats 4 x 128 at every 32^2 shape
# of the ADM census on an H100).
TILES = ((4, 256), (2, 256), (4, 128), (2, 128))
# The least share of its waves' SM slots a grid must fill.
MIN_FILL = 0.9


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """The bf16 kernel's tile for one shape: ``rows`` x 32 output pixels x
    ``bn`` output channels, ``tiles`` tiles, walked by one persistent block
    per SM; ``reason`` says why there are fewer tiles than SMs, where there
    are."""
    rows: int
    bn: int
    tiles: int
    reason: str = ""


def halo_plan(N: int, H: int, W: int, cin: int, cr: int, cout: int,
              sms: int = SMS) -> HaloPlan:
    """The largest tile of TILES whose tiles fill their waves of ``sms``
    to at least MIN_FILL (larger tiles activate each window element for
    more output channels and read the weights for more pixels); where none
    does, the tile that gives the most tiles. Raises on a shape the bf16
    kernel does not take. No split-K: the result stays deterministic."""
    if W % 32 or cin % KC or cr % KC or cin <= 0:
        raise ValueError(f"the bf16 halo conv takes W % 32 == 0 and cin, cr % {KC} == 0; "
                         f"got W={W}, cin={cin}, cr={cr}")
    fits = [(r, bn, N * (H // r) * (W // 32) * (cout // bn)) for r, bn in TILES
            if H % r == 0 and cout % bn == 0]
    if not fits:
        raise ValueError(f"the bf16 halo conv takes H % 2 == 0 and cout % 128 == 0; "
                         f"got H={H}, cout={cout}")
    pixels = f"{N * H * W} output pixels x {cout} channels"
    for r, bn, tiles in fits:
        if tiles / (-(-tiles // sms) * sms) >= MIN_FILL:
            return HaloPlan(r, bn, tiles, "" if tiles >= sms else
                            f"{pixels}: {tiles} tiles of {r * 32} x {bn} fill {tiles} "
                            f"of {sms} SMs in one wave; a smaller tile doubles the waves")
    r, bn, tiles = max(fits, key=lambda f: f[2])
    return HaloPlan(r, bn, tiles, f"{pixels} make at most {tiles} tiles of "
                                  f"{r * 32} x {bn}" if tiles < sms else "")


@dataclasses.dataclass(frozen=True)
class PackedHalo:
    """Conv weights in the kernel's layout for one dtype. bf16: w (steps,
    cout, 64), step (c // 64) * 9 + tap for input channel c of the conv,
    then the projection's steps 9 cin / 64 + c // 64; each row of 64
    channels in the 128-byte swizzle of wgmma's shared-memory operand
    (16-byte group g of row n stored at g ^ (n % 8)), so that one TMA bulk
    copy per step lands it ready for the tensor cores; w_proj is the view
    of the projection's steps. fp32: w (9 cin, cout) and w_proj (cr,
    cout)."""
    w: Tensor
    w_proj: Optional[Tensor]
    cin: int
    cout: int


def _swizzle128(wk: Tensor) -> Tensor:
    """(steps, cout, 64) with each row's 16-byte groups g stored at g ^ (n % 8)."""
    steps, cout, _ = wk.shape
    g = torch.arange(8, device=wk.device)
    src = g[None, :] ^ (torch.arange(cout, device=wk.device)[:, None] % 8)  # (cout, 8)
    idx = src[None, :, :, None].expand(steps, cout, 8, 8)
    return torch.gather(wk.reshape(steps, cout, 8, 8), 2, idx).reshape(steps, cout, KC)


def pack_halo_weights(w: Tensor, w_proj: Optional[Tensor], dtype: torch.dtype,
                      device) -> PackedHalo:
    """w (3, 3, cin, cout) HWIO, w_proj (cr, cout) or None."""
    cin, cout = w.shape[2], w.shape[3]
    with torch.no_grad():
        w = w.detach().to(device, dtype)
        wp = None if w_proj is None else w_proj.detach().to(device, dtype)
        if dtype != torch.bfloat16:
            return PackedHalo(w.reshape(9 * cin, cout).contiguous(),
                              None if wp is None else wp.contiguous(), cin, cout)
        cr = 0 if wp is None else wp.shape[0]
        if cin % KC or cr % KC:
            raise ValueError(f"the bf16 halo pack takes cin, cr % {KC} == 0; "
                             f"got cin={cin}, cr={cr}")
        # (chunk, tap, n, c): step chunk * 9 + tap
        steps = [w.reshape(9, cin // KC, KC, cout).permute(1, 0, 3, 2)
                 .reshape(9 * cin // KC, cout, KC)]
        if wp is not None:
            steps.append(wp.reshape(cr // KC, KC, cout).permute(0, 2, 1))
        wk = _swizzle128(torch.cat(steps).contiguous()).contiguous()
        return PackedHalo(wk, None if wp is None else wk[9 * cin // KC:], cin, cout)


def check_halo_shape(dtype: torch.dtype, x_shape, w_shape, cr: int, proj: bool,
                     sms: int = SMS) -> Optional[HaloPlan]:
    """Raise on what the kernel for ``dtype`` does not take; the bf16 plan.
    x (N, H, W, cin), w (3, 3, cin, cout), a skip of cr channels (0: none),
    projected or not."""
    if dtype not in _cuda.DTYPE_CODE or len(x_shape) != 4:
        raise ValueError(f"the halo conv takes NHWC fp32 or bf16, not {dtype} "
                         f"{tuple(x_shape)}")
    N, H, W, cin = x_shape
    cout = w_shape[-1]
    if tuple(w_shape) != (3, 3, cin, cout):
        raise ValueError(f"the halo conv takes a (3, 3, {cin}, cout) kernel, not "
                         f"{tuple(w_shape)}")
    if cr and not proj and cr != cout:
        raise ValueError(f"an identity skip needs {cout} channels, not {cr}")
    if proj and not cr:
        raise ValueError("w_proj needs a skip")
    if dtype == torch.bfloat16:
        return halo_plan(N, H, W, cin, cr, cout, sms)
    if H % 4 or W % 32 or cin % 32 or cout % 64 or cr % 32:
        raise ValueError(f"the fp32 halo conv takes H % 4 == 0, W % 32 == 0, cin and "
                         f"cr % 32 == 0, cout % 64 == 0; got x {tuple(x_shape)}, "
                         f"cout {cout}, skip channels {cr}")
    return None


def _launch(x: Tensor, A: Tensor, B: Tensor, w: Tensor, bias: Tensor,
            skip: Optional[Tensor], w_proj: Optional[Tensor],
            packed: Optional[PackedHalo]) -> Tensor:
    dev, dtype = x.device, x.dtype
    if w_proj is not None and skip is not None and tuple(w_proj.shape) != (skip.shape[-1],
                                                                          w.shape[-1]):
        raise ValueError("w_proj needs the shape (cr, cout)")
    N, H, W, cin = x.shape
    cout = w.shape[-1]
    cr = skip.shape[-1] if skip is not None else 0
    plan = check_halo_shape(dtype, x.shape, w.shape, cr, w_proj is not None,
                            sms=_cuda.num_sms(dev))
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
        cout, out.data_ptr(), plan.rows if plan else 0, plan.bn if plan else 0,
        _cuda.stream(dev))
    _cuda.check(err, "halo conv kernel")
    return out


def _halo_kernel(x, A, B, w, bias, skip, w_proj, packed):
    out = _launch(x, A, B, w, bias, skip, w_proj, packed)
    gn_silu_conv3x3_halo.launches += 1
    return out


def _halo_plain(cfg, x, A, B, w, bias, skip, w_proj):
    out_dtype, _ = cfg
    return gn_silu_conv3x3_reference(x, A, B, w, bias, skip=skip, w_proj=w_proj,
                                     out_dtype=out_dtype)


_HALO = ((lambda cfg, *t: _halo_kernel(*t, cfg[1])), _halo_plain,
         _cuda.autograd_vjp(_halo_plain))


def gn_silu_conv3x3_halo(x: Tensor, A: Tensor, B: Tensor, w: Tensor,
                         bias: Tensor, *, skip: Optional[Tensor] = None,
                         w_proj: Optional[Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None,
                         packed: Optional[PackedHalo] = None) -> Tensor:
    """conv3x3(silu(x A + B), w) + b [+ skip | + skip @ w_proj]: plain on
    CPU, the CUDA kernel on CUDA; differentiable. x (N, H, W, cin); A, B
    (N, cin) fp32; skip (N, H, W, cr), an identity skip when w_proj is None
    (cr == cout)."""
    _cuda.check_device("the halo conv", x)
    if x.device.type == "cuda" and (out_dtype or x.dtype) != x.dtype:
        raise ValueError("the halo conv writes its output in x's dtype")
    return _cuda.KernelFunction.apply(_HALO, (out_dtype, packed), x, A, B, w, bias,
                                      skip, w_proj)


def _block_kernel(cfg, x, gn_scale, gn_bias, film_scale, film_shift, w, bias, skip,
                  w_proj, pre_shift):
    num_groups, eps, packed = cfg
    sums, sqs = _stats_kernel(x)
    A, B = _affine(sums, sqs, x.shape[1] * x.shape[2], gn_scale, gn_bias, num_groups,
                   eps, film_scale, film_shift, pre_shift)
    return _halo_kernel(x, A, B, w, bias, skip, w_proj, packed)


def _block_plain(cfg, x, gn_scale, gn_bias, film_scale, film_shift, w, bias, skip,
                 w_proj, pre_shift):
    num_groups, eps, _ = cfg
    A, B = group_stats_affine_reference(x, gn_scale, gn_bias, num_groups, eps,
                                        film_scale, film_shift, pre_shift)
    return gn_silu_conv3x3_reference(x, A, B, w, bias, skip=skip, w_proj=w_proj)


def _block_grad(cfg, x, gn_scale, gn_bias, film_scale, film_shift, w, bias, skip,
                w_proj, pre_shift):
    num_groups, eps, _ = cfg
    return gn_conv_block_reference(x, gn_scale, gn_bias, film_scale, film_shift, w, bias,
                                   skip, w_proj, num_groups, eps, pre_shift=pre_shift)


_BLOCK = (_block_kernel, _block_plain, _cuda.autograd_vjp(_block_grad))


def gn_silu_conv_block(x: Tensor, gn_scale: Tensor, gn_bias: Tensor,
                       film_scale: Optional[Tensor],
                       film_shift: Optional[Tensor], w: Tensor, bias: Tensor,
                       skip: Optional[Tensor], w_proj: Optional[Tensor],
                       pre_shift: Optional[Tensor], num_groups: int,
                       eps: float, packed: Optional[PackedHalo] = None
                       ) -> Tensor:
    """GN(+FiLM)+SiLU+conv3x3(+skip) as [stats pass -> halo conv]; pre_shift
    (N, C) is added before the GN, folded into the affine. Differentiable:
    the gradient is autograd of ``gn_conv_block_reference``."""
    _cuda.check_device("the halo conv", x)
    return _cuda.KernelFunction.apply(
        _BLOCK, (num_groups, eps, packed), x, gn_scale, gn_bias, film_scale, film_shift,
        w, bias, skip, w_proj, pre_shift)


# Kernel launches since the last reset (plain CPU calls do not count).
gn_silu_conv3x3_halo.launches = 0
