"""Fused BigGAN residual block (NCSN++ ResnetBlockBigGANpp, eval mode).

Port of diffpure_tpu/ops/fused_resblock.py. Two forms of one function and
of its input gradient:

- ``fused_resblock_reference``: plain PyTorch, the port of the JAX
  ``fused_resblock_reference`` (:587) and the oracle of the kernels;
  ``fused_resblock_bwd_reference`` / ``fused_resblock_cat_bwd_reference``:
  its input gradient by autograd, the oracle of the backward kernels;
- ``fused_resblock`` / ``fused_resblock_cat``: the block as a
  ``torch.autograd.Function`` (the counterpart of the JAX ``custom_vjp``s,
  :1025-1150) whose forward is the CUDA kernel in ``csrc/fused_resblock.cu``
  (replacing ``fused_resblock_pallas`` :290 and ``fused_resblock_cat_pallas``
  :728) and whose backward gives dx and dtemb through
  ``fused_resblock_bwd`` / ``fused_resblock_cat_bwd``, the wrappers of the
  CUDA kernel in ``csrc/fused_resblock_bwd.cu`` (replacing
  ``fused_resblock_bwd_pallas`` :506 and ``fused_resblock_cat_bwd_pallas``
  :941). Weight cotangents come from autograd of the plain version, and only
  when asked for, as JAX takes them from a subgraph XLA drops when unused.
  On CPU tensors every wrapper runs the plain version; on CUDA tensors it
  launches its kernel or raises. The bf16 forward runs its two convs on the
  wgmma GEMM of ``csrc/igemm_wgmma.cuh``, tiled as ``resblock_plan`` says,
  with weights from ``pack_resblock_params``' swizzled stages; it takes
  channel counts that are multiples of 64 and maps its TMA boxes tile
  (``check_resblock_shape``), and raises on others.

The block: GN1 (fp32 stats, eps 1e-6) + SiLU -> optional naive 2x
down/up-sample of h and of the skip input -> conv3x3 + b0 + temb row ->
GN2 + SiLU -> conv3x3 + b1 -> optional 1x1 projection (+ bias) of the skip
-> (skip + h) * 1/sqrt(2). Weights are in PyTorch layout: convs OIHW, the
projection (cout, cin).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops.conv import conv2d_nhwc
from diffpure_tpu_torch.ops.groupnorm import group_norm
from diffpure_tpu_torch.ops.halo_conv import pack_halo_weights
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


def _input_grads(fn, inputs, g):
    """fp32 gradients of fn(*inputs) against the cotangent g, by autograd
    (the weights are held constant)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        grads = torch.autograd.grad(fn(*leaves), leaves, g)
    return tuple(d.float() for d in grads)


def fused_resblock_bwd_reference(x: Tensor, temb_row: Tensor, params: Tuple,
                                 g: Tensor, *, num_groups1: int,
                                 num_groups2: int, eps: float = 1e-6,
                                 rescale: bool = True, resample: str = "none"
                                 ) -> Tuple[Tensor, Tensor]:
    """Plain (dx, dtemb_row) of the block for the output cotangent g, in
    fp32 (the contract of fused_resblock_bwd_pallas)."""
    return _input_grads(
        lambda xx, tt: fused_resblock_reference(
            xx, tt, params, num_groups1=num_groups1, num_groups2=num_groups2,
            eps=eps, rescale=rescale, resample=resample),
        (x, temb_row), g)


def fused_resblock_cat_bwd_reference(x1: Tensor, x2: Tensor, temb_row: Tensor,
                                     params: Tuple, g: Tensor, *,
                                     num_groups1: int, num_groups2: int,
                                     eps: float = 1e-6, rescale: bool = True
                                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain (dx1, dx2, dtemb_row) of the block on concat(x1, x2), fp32."""
    return _input_grads(
        lambda a, b, tt: fused_resblock_reference(
            torch.cat([a, b], dim=-1), tt, params, num_groups1=num_groups1,
            num_groups2=num_groups2, eps=eps, rescale=rescale),
        (x1, x2, temb_row), g)


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
    # bf16 with cin, cout % 64 == 0: the wgmma GEMM's weight stages (the
    # halo conv's layout, ops/halo_conv.py pack_halo_weights): (steps, cout,
    # 64), step (c // 64) * 9 + tap for input channel c, the projection's
    # steps (cin / 64 of them) after conv1's, each row of 64 channels in the
    # 128-byte swizzle, so that one bulk copy lands a stage ready for wgmma.
    w0s: Optional[Tensor] = None  # (9 cin / 64, cout, 64)
    w1s: Optional[Tensor] = None  # (9 cout / 64 [+ cin / 64], cout, 64)
    # the device pointers the launch passes, taken once here: gn1s, gn1b,
    # w0, b0, gn2s, gn2b, w1, bias1, w0s, w1s (0 for None)
    ptrs: Tuple[int, ...] = ()


def _f32(t: Tensor, device) -> Tensor:
    return t.detach().to(device, torch.float32).contiguous()


def pack_resblock_params(params: Tuple, dtype: torch.dtype,
                         device) -> PackedResblock:
    """Repack PyTorch-layout block weights for the kernel (done once per
    module and dtype by the caller, not per launch)."""
    gn1s, gn1b, w0, b0, gn2s, gn2b, w1, b1, wskip, bskip = params
    cout, cin = w0.shape[:2]
    with torch.no_grad():
        w0p = w0.detach().permute(0, 2, 3, 1).reshape(cout, 9 * cin)
        w1p = w1.detach().permute(0, 2, 3, 1).reshape(cout, 9 * cout)
        bias1 = _f32(b1, device)
        if wskip is not None:
            w1p = torch.cat([w1p, wskip.detach().reshape(cout, cin)], 1)
            bias1 = bias1 + _f32(bskip, device)
        w0s = w1s = None
        if dtype == torch.bfloat16 and cin % KC == 0 and cout % KC == 0:
            w0s = pack_halo_weights(w0.permute(2, 3, 1, 0), None, dtype, device).w
            w1s = pack_halo_weights(
                w1.permute(2, 3, 1, 0),
                None if wskip is None else wskip.reshape(cout, cin).t(), dtype, device).w
        t = dict(gn1s=_f32(gn1s, device), gn1b=_f32(gn1b, device),
                 w0=w0p.to(device, dtype).contiguous(), b0=_f32(b0, device),
                 gn2s=_f32(gn2s, device), gn2b=_f32(gn2b, device),
                 w1=w1p.to(device, dtype).contiguous(), bias1=bias1.contiguous(),
                 w0s=w0s, w1s=w1s)
        return PackedResblock(cin=cin, cout=cout, has_proj=wskip is not None,
                              ptrs=tuple(0 if v is None else v.data_ptr()
                                         for v in t.values()), **t)


# The bf16 wgmma GEMM's K step: 64 input channels, one 128-byte row.
KC = 64
# SMs of the card the plan fills (NVIDIA H100 SXM).
SMS = 132
# Its tiles (M rows, N channels), largest first: a 128 x 256 tile reads
# (128 + 256) x 128 bytes per K step for 128 x 256 x 64 multiply-adds.
# (64 x 256 would never be picked for the NCSN++ census at batch 1-256.)
RB_TILES = ((128, 256), (128, 128), (64, 128), (128, 64))
# The least share of its waves' SM slots a grid of tiles must fill.
RB_MIN_FILL = 0.9
# Split-K: at most this many slices, each at least this many K steps.
RB_MAX_SPLITS = 32
RB_MIN_STEPS = 2
# The bf16 GroupNorm pass's shared scratch (GN_MAX_C, GN_MAX_G in
# csrc/fused_resblock.cu).
RB_GN_MAX_C = 1024
RB_GN_MAX_G = 64


@dataclasses.dataclass(frozen=True)
class ResblockPlan:
    """The bf16 GEMM's work for one block shape: tiles of ``bm`` output
    pixels (rows) x ``bn`` output channels, ``mtiles`` x ``ntiles`` of
    them; an M tile is the TMA box of ``box`` = (Wo columns, bh rows, bimg
    images) of the output grid; conv0 and conv1 split their K steps
    (``steps``) into ``splits`` slices of ``per`` steps each (the last may
    be shorter), walked by min(mtiles ntiles splits, SMs) persistent
    blocks."""
    bm: int
    bn: int
    box: Tuple[int, int, int]
    mtiles: int
    ntiles: int
    steps: Tuple[int, int]
    splits: Tuple[int, int]
    per: Tuple[int, int]


def _box(bm: int, Ho: int, Wo: int) -> Optional[Tuple[int, int, int]]:
    """The box of bm rows that tiles the output grid: whole rows of one
    image, or whole images; None where none does."""
    hw = Ho * Wo
    if bm % Wo:
        return None
    if hw % bm == 0:
        return Wo, bm // Wo, 1
    if bm % hw == 0:
        return Wo, Ho, bm // hw
    return None


@functools.lru_cache(maxsize=None)
def resblock_plan(N: int, Ho: int, Wo: int, cin: int, cr: int, cout: int,
                  sms: int = SMS, ws_elems: int = _cuda.SPLITK_WORKSPACE) -> ResblockPlan:
    """The largest tile of RB_TILES whose tiles fill their waves of ``sms``
    to at least RB_MIN_FILL; where none does, the tile that gives the most
    tiles, and each conv's K split into up to sms // tiles slices of at
    least RB_MIN_STEPS steps whose fp32 partials fit ``ws_elems`` (summed
    in slice order by a second pass: no atomics). cin: conv0's input
    channels, cr: the projection's (0 for an identity skip), cout: the
    output's; Ho x Wo: the output grid. Raises on a shape the kernel does
    not take."""
    if cin % KC or cr % KC or cout % KC or cin <= 0 or cout <= 0:
        raise ValueError(f"the bf16 resblock kernel takes channel counts that are "
                         f"multiples of {KC}; got cin={cin}, skip={cr}, cout={cout}")
    M = N * Ho * Wo
    fits = []
    for bm, bn in RB_TILES:
        box = _box(bm, Ho, Wo)
        if cout % bn == 0 and box is not None and max(box) <= 256:
            fits.append((bm, bn, box, -(-M // bm), cout // bn))
    if not fits:
        raise ValueError(f"the bf16 resblock kernel's TMA boxes do not tile a "
                         f"{Ho}x{Wo} map: it takes Wo dividing 64 or 128 and Ho * Wo a "
                         f"multiple or a divisor of that tile")
    def fills(tiles):
        return tiles / (-(-tiles // sms) * sms) >= RB_MIN_FILL

    pick = next((f for f in fits if fills(f[3] * f[4])), None) \
        or max(fits, key=lambda f: f[3] * f[4])
    bm, bn, box, mtiles, ntiles = pick
    tiles = mtiles * ntiles
    steps = (9 * cin // KC, 9 * cout // KC + cr // KC)
    splits, per = [], []
    for k in steps:
        s = 1
        if not fills(tiles):
            s = max(1, min(sms // tiles, k // RB_MIN_STEPS, RB_MAX_SPLITS,
                           ws_elems // (M * cout)))
        p = -(-k // s)
        splits.append(-(-k // p))
        per.append(p)
    return ResblockPlan(bm, bn, box, mtiles, ntiles, steps, tuple(splits), tuple(per))


def check_resblock_shape(dtype: torch.dtype, N: int, H: int, W: int, c1: int,
                         c2: int, cout: int, resample: str, has_proj: bool,
                         g1: int, g2: int, sms: int = SMS) -> Optional[ResblockPlan]:
    """Raise on what the kernel for ``dtype`` does not take; the bf16 plan
    (None for fp32, whose kernel takes any channel counts that are
    multiples of 4)."""
    if dtype != torch.bfloat16:
        return None
    if c1 % KC or c2 % KC:
        raise ValueError(f"the bf16 resblock kernel takes inputs of channel counts that "
                         f"are multiples of {KC}; got {c1} + {c2}")
    cin = c1 + c2
    if max(cin, cout) > RB_GN_MAX_C or max(g1, g2) > RB_GN_MAX_G or cin % g1 or cout % g2:
        raise ValueError(f"the bf16 resblock kernel's GroupNorm pass takes at most "
                         f"{RB_GN_MAX_C} channels in at most {RB_GN_MAX_G} groups that divide "
                         f"them; got {cin} in {g1}, {cout} in {g2}")
    Ho, Wo = {"none": (H, W), "down": (H // 2, W // 2), "up": (H * 2, W * 2)}[resample]
    return resblock_plan(N, Ho, Wo, cin, cin if has_proj else 0, cout, sms)


@dataclasses.dataclass(frozen=True)
class PackedResblockBwd:
    """The backward kernel's transposed weights, for one compute dtype (the
    forward's pack supplies the rest). Row c of a transposed conv holds
    column (3 * dy + dx) * cout + o = w[o, c, 2 - dy, 2 - dx]: the 3x3 SAME
    conv that is the transpose of the forward's (_flip_transpose_w9, :500)."""
    w1t: Tensor                # (cout, 9 * cout)
    w0t: Tensor                # (cin, 9 * cout); the cat block's rows split
                               # at the seam: [0, c1) give dx1, the rest dx2
    wskipt: Optional[Tensor]   # (cin, cout), or None for an identity skip


def _flip_transpose(w: Tensor) -> Tensor:
    """(co, ci, 3, 3) conv weight -> (ci, 9 * co) transposed-conv matrix."""
    co, ci = w.shape[:2]
    return w.detach().flip(2, 3).permute(1, 2, 3, 0).reshape(ci, 9 * co)


def pack_resblock_bwd_params(params: Tuple, dtype: torch.dtype,
                             device) -> PackedResblockBwd:
    """Transposed weights for the backward kernel (cached by the caller
    like the forward pack)."""
    w0, w1, wskip = params[2], params[6], params[8]
    with torch.no_grad():
        return PackedResblockBwd(
            w1t=_flip_transpose(w1).to(device, dtype).contiguous(),
            w0t=_flip_transpose(w0).to(device, dtype).contiguous(),
            wskipt=None if wskip is None else
            wskip.detach().t().to(device, dtype).contiguous())


def _block_shapes(x1: Tensor, x2: Optional[Tensor], pk: PackedResblock,
                  g1: int, g2: int, resample: str):
    """Check what both kernels take; return (N, H, W, c1, c2, Ho, Wo)."""
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
    if cin // g1 > 256 or cout // g2 > 256:
        raise ValueError("the GroupNorm kernels take at most 256 channels per group")
    if resample == "down" and (H % 2 or W % 2):
        raise ValueError(f"down-sampling needs even H, W, got {H}x{W}")
    if not pk.has_proj and cin != cout:
        raise ValueError(f"an identity skip needs cin == cout, got {cin}, {cout}")
    if x2 is not None and (not pk.has_proj or resample != "none"):
        raise ValueError("the concat kernel needs a projection and resample 'none'")
    Ho, Wo = {"none": (H, W), "down": (H // 2, W // 2),
              "up": (H * 2, W * 2)}[resample]
    return N, H, W, c1, c2, Ho, Wo


def _launch(x1: Tensor, x2: Optional[Tensor], temb_row: Tensor,
            pk: PackedResblock, g1: int, g2: int, eps: float, rescale: bool,
            resample: str) -> Tensor:
    dev, dtype = x1.device, x1.dtype
    N, H, W, c1, c2, Ho, Wo = _block_shapes(x1, x2, pk, g1, g2, resample)
    cin, cout = c1 + c2, pk.cout
    plan = check_resblock_shape(dtype, N, H, W, c1, c2, cout, resample, pk.has_proj,
                                g1, g2, _cuda.num_sms(dev))
    if plan is not None and pk.w0s is None:
        raise ValueError("packed weights lack the bf16 kernel's stages")
    p_x1 = _cuda.check_operand(x1, "x1", dev, dtype)
    p_x2 = None if x2 is None else _cuda.check_operand(
        x2, "x2", dev, dtype, (N, H, W, c2))
    # the TPU kernel casts temb to x's dtype
    temb = temb_row if temb_row.dtype == dtype and temb_row.is_contiguous() \
        else temb_row.to(dtype).contiguous()
    p_temb = _cuda.check_operand(temb, "temb_row", dev, dtype, (N, cout))

    out = torch.empty((N, Ho, Wo, cout), device=dev, dtype=dtype)
    esize, pix = out.element_size(), N * Ho * Wo
    # act1, xs (the resampled x; up/down only), h1 (fp32), act2; buf owns
    # the memory while the kernels are queued on the stream
    buf, (act1, xs, h1, act2), ws = _cuda.scratch(
        dev, pix * cin * esize, pix * cin * esize if resample != "none" else 0,
        pix * cout * 4, pix * cout * esize)
    gn1s, gn1b, w0, b0, gn2s, gn2b, w1, bias1, w0s, w1s = pk.ptrs
    bm = bn = bh = bimg = 0
    splits, per = (0, 0), (0, 0)
    if plan is not None:
        bm, bn, (_, bh, bimg), splits, per = plan.bm, plan.bn, plan.box, plan.splits, plan.per
    err = _cuda.lib().diffpure_resblock_fwd(
        _cuda.DTYPE_CODE[dtype], p_x1, p_x2, c1, c2, N, H, W,
        _RESAMPLE[resample], p_temb, gn1s, gn1b, g1, w0, b0, gn2s, gn2b, g2,
        w1, bias1, int(pk.has_proj), cout, eps, INV_SQRT2 if rescale else 1.0,
        act1, xs, h1, act2, ws, _cuda.SPLITK_WORKSPACE, out.data_ptr(), w0s, w1s,
        bm, bn, bh, bimg, splits[0], per[0], splits[1], per[1], _cuda.stream(dev))
    _cuda.check(err, "fused_resblock kernel")
    return out


def _launch_bwd(x1: Tensor, x2: Optional[Tensor], temb_row: Tensor, g: Tensor,
                pk: PackedResblock, pkb: PackedResblockBwd, g1: int, g2: int,
                eps: float, rescale: bool, resample: str):
    dev, dtype = x1.device, x1.dtype
    N, H, W, c1, c2, Ho, Wo = _block_shapes(x1, x2, pk, g1, g2, resample)
    cin, cout = c1 + c2, pk.cout
    if pkb.w0t.dtype != dtype or pkb.w0t.device != dev \
            or tuple(pkb.w0t.shape) != (cin, 9 * cout) \
            or (pkb.wskipt is not None) != pk.has_proj:
        raise ValueError("packed backward weights do not match the input")
    p_x1 = _cuda.check_operand(x1, "x1", dev, dtype)
    p_x2 = None if x2 is None else _cuda.check_operand(
        x2, "x2", dev, dtype, (N, H, W, c2))
    temb = temb_row.to(dtype).contiguous()
    p_temb = _cuda.check_operand(temb, "temb_row", dev, dtype, (N, cout))
    gc = g.to(dtype).contiguous()
    p_g = _cuda.check_operand(gc, "g", dev, dtype, (N, Ho, Wo, cout))

    f32 = dict(device=dev, dtype=torch.float32)
    dx1 = torch.empty((N, H, W, c1), **f32)
    dx2 = None if x2 is None else torch.empty((N, H, W, c2), **f32)
    dtemb = torch.empty((N, cout), **f32)
    esize, pix = gc.element_size(), N * Ho * Wo
    # act1, h1, d_a2, d_c1, d_h, the skip adjoint (projected blocks only)
    buf, (act1, h1, da2, dc1, dh, dskip), ws = _cuda.scratch(
        dev, pix * cin * esize, pix * cout * 4, pix * cout * 4,
        pix * cout * esize, pix * cin * 4, pix * cin * 4 if pk.has_proj else 0)
    err = _cuda.lib().diffpure_resblock_bwd(
        _cuda.DTYPE_CODE[dtype], p_x1, p_x2, c1, c2, N, H, W,
        _RESAMPLE[resample], p_temb, p_g,
        pk.gn1s.data_ptr(), pk.gn1b.data_ptr(), g1, pk.w0.data_ptr(),
        pk.b0.data_ptr(), pk.gn2s.data_ptr(), pk.gn2b.data_ptr(), g2,
        pkb.w1t.data_ptr(), pkb.w0t.data_ptr(),
        None if pkb.wskipt is None else pkb.wskipt.data_ptr(), cout,
        eps, INV_SQRT2 if rescale else 1.0,
        act1, h1, da2, dc1, dh, dskip, ws, _cuda.SPLITK_WORKSPACE,
        dx1.data_ptr(), None if dx2 is None else dx2.data_ptr(),
        dtemb.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "fused_resblock backward kernel")
    return dx1, dx2, dtemb


def _on_card(x: Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain version)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    return x.device.type == "cuda"


@dataclasses.dataclass(frozen=True)
class _Block:
    """What a call fixes besides its tensors."""
    num_groups1: int
    num_groups2: int
    eps: float
    rescale: bool
    resample: str
    packed: Optional[PackedResblock]
    packed_bwd: Optional[PackedResblockBwd]

    def kw(self, resample=True):
        kw = dict(num_groups1=self.num_groups1, num_groups2=self.num_groups2,
                  eps=self.eps, rescale=self.rescale)
        if resample:
            kw["resample"] = self.resample
        return kw


class _FusedResblock(torch.autograd.Function):
    """The block (x2 is None) or the concat block. Saves only its inputs;
    the backward recomputes up to GN2's input inside the kernel."""

    @staticmethod
    def forward(ctx, blk: _Block, x1, x2, temb_row, *params):
        ctx.blk = blk
        ctx.save_for_backward(x1, x2, temb_row, *params)
        if not _on_card(x1, "fused_resblock"):
            x = x1 if x2 is None else torch.cat([x1, x2], dim=-1)
            return fused_resblock_reference(x, temb_row, params, **blk.kw())
        pk = blk.packed or pack_resblock_params(params, x1.dtype, x1.device)
        out = _launch(x1, x2, temb_row, pk, blk.num_groups1,
                      blk.num_groups2, blk.eps, blk.rescale, blk.resample)
        (fused_resblock if x2 is None else fused_resblock_cat).launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        blk = ctx.blk
        x1, x2, temb_row, *params = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx1 = dx2 = dtemb = None
        if any(need[1:4]):
            pk = dict(packed=blk.packed, packed_bwd=blk.packed_bwd)
            if x2 is None:
                dx1, dtemb = fused_resblock_bwd(x1, temb_row, params, g,
                                                **blk.kw(), **pk)
            else:
                dx1, dx2, dtemb = fused_resblock_cat_bwd(
                    x1, x2, temb_row, params, g, **blk.kw(False), **pk)
                dx2 = dx2.to(x2.dtype)
            dx1, dtemb = dx1.to(x1.dtype), dtemb.to(temb_row.dtype)
        dparams = [None] * len(params)
        if any(need[4:]):  # weight cotangents: autograd of the plain version
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(n) if p is not None else None
                          for p, n in zip(params, need[4:])]
                x = x1 if x2 is None else torch.cat([x1, x2], dim=-1)
                out = fused_resblock_reference(x.detach(), temb_row.detach(),
                                               tuple(leaves), **blk.kw())
                grads = iter(torch.autograd.grad(
                    out, [p for p, n in zip(leaves, need[4:]) if n], g))
            dparams = [next(grads) if n else None for n in need[4:]]
        return (None, dx1 if need[1] else None, dx2 if need[2] else None,
                dtemb if need[3] else None, *dparams)


def fused_resblock(x: Tensor, temb_row: Tensor, params: Tuple, *,
                   num_groups1: int, num_groups2: int, eps: float = 1e-6,
                   rescale: bool = True, resample: str = "none",
                   packed: Optional[PackedResblock] = None,
                   packed_bwd: Optional[PackedResblockBwd] = None) -> Tensor:
    """The block on one NHWC input, differentiable: plain on CPU, the CUDA
    kernels on CUDA. ``packed`` / ``packed_bwd``: the weights from
    ``pack_resblock_params`` / ``pack_resblock_bwd_params`` (packed here
    when omitted)."""
    blk = _Block(num_groups1, num_groups2, eps, rescale, resample, packed,
                 packed_bwd)
    return _FusedResblock.apply(blk, x, None, temb_row, *params)


def fused_resblock_cat(x1: Tensor, x2: Tensor, temb_row: Tensor,
                       params: Tuple, *, num_groups1: int, num_groups2: int,
                       eps: float = 1e-6, rescale: bool = True,
                       packed: Optional[PackedResblock] = None,
                       packed_bwd: Optional[PackedResblockBwd] = None
                       ) -> Tensor:
    """The block on concat(x1, x2) along channels, without materialising
    the concat on CUDA; GN1 statistics span the seam. Needs a projection."""
    if params[8] is None:
        raise ValueError("concat blocks always project the skip")
    blk = _Block(num_groups1, num_groups2, eps, rescale, "none", packed,
                 packed_bwd)
    return _FusedResblock.apply(blk, x1, x2, temb_row, *params)


def fused_resblock_bwd(x: Tensor, temb_row: Tensor, params: Tuple, g: Tensor,
                       *, num_groups1: int, num_groups2: int,
                       eps: float = 1e-6, rescale: bool = True,
                       resample: str = "none",
                       packed: Optional[PackedResblock] = None,
                       packed_bwd: Optional[PackedResblockBwd] = None
                       ) -> Tuple[Tensor, Tensor]:
    """(dx, dtemb_row) in fp32 for the output cotangent g: plain on CPU,
    the backward kernel on CUDA."""
    if not _on_card(x, "fused_resblock_bwd"):
        return fused_resblock_bwd_reference(
            x, temb_row, params, g, num_groups1=num_groups1,
            num_groups2=num_groups2, eps=eps, rescale=rescale,
            resample=resample)
    pk = packed or pack_resblock_params(params, x.dtype, x.device)
    pkb = packed_bwd or pack_resblock_bwd_params(params, x.dtype, x.device)
    dx, _, dtemb = _launch_bwd(x, None, temb_row, g, pk, pkb, num_groups1,
                               num_groups2, eps, rescale, resample)
    fused_resblock_bwd.launches += 1
    return dx, dtemb


def fused_resblock_cat_bwd(x1: Tensor, x2: Tensor, temb_row: Tensor,
                           params: Tuple, g: Tensor, *, num_groups1: int,
                           num_groups2: int, eps: float = 1e-6,
                           rescale: bool = True,
                           packed: Optional[PackedResblock] = None,
                           packed_bwd: Optional[PackedResblockBwd] = None
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """(dx1, dx2, dtemb_row) in fp32 for the concat block."""
    if params[8] is None:
        raise ValueError("concat blocks always project the skip")
    if not _on_card(x1, "fused_resblock_cat_bwd"):
        return fused_resblock_cat_bwd_reference(
            x1, x2, temb_row, params, g, num_groups1=num_groups1,
            num_groups2=num_groups2, eps=eps, rescale=rescale)
    pk = packed or pack_resblock_params(params, x1.dtype, x1.device)
    pkb = packed_bwd or pack_resblock_bwd_params(params, x1.dtype, x1.device)
    out = _launch_bwd(x1, x2, temb_row, g, pk, pkb, num_groups1,
                      num_groups2, eps, rescale, "none")
    fused_resblock_cat_bwd.launches += 1
    return out


# Kernel launches since the last reset (plain CPU calls do not count).
fused_resblock.launches = 0
fused_resblock_cat.launches = 0
fused_resblock_bwd.launches = 0
fused_resblock_cat_bwd.launches = 0
