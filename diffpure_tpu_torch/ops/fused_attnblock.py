"""Fused NCSN++ attention block (AttnBlockpp, eval mode).

Port of diffpure_tpu/ops/fused_attnblock.py: ``fused_attnblock_reference``
(:151) in plain PyTorch, and ``fused_attnblock``, a
``torch.autograd.Function`` whose forward is the CUDA kernel in
``csrc/fused_attnblock.cu`` (replacing ``fused_attnblock_pallas``, :106) and
whose backward is autograd of the plain version, as JAX's ``_fab_bwd``
(:200-206) is: the TPU has no attention backward kernel either. On a CPU
tensor the forward runs the plain version; on a CUDA tensor it launches the
kernel or raises.

The block: GN -> q, k, v = NIN(h) -> softmax(q k^T C^-1/2) in fp32 -> @ v
-> NIN -> + x, times 1/sqrt(2) when rescaled. NIN weights are (in, out).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops.fused_resblock import INV_SQRT2
from diffpure_tpu_torch.ops.groupnorm import group_norm

Tensor = torch.Tensor


def fused_attnblock_reference(x: Tensor, params: Tuple, *, num_groups: int,
                              eps: float = 1e-6, rescale: bool = True
                              ) -> Tensor:
    """Plain version. params = (gn_scale, gn_bias, Wq, bq, Wk, bk, Wv, bv,
    Wout, bout). Products run in x's dtype with fp32 results, as in the JAX
    reference."""
    gns, gnb, wq, bq, wk, bk, wv, bv, wo, bo = params
    N, H, W, C = x.shape
    cdt = x.dtype
    h2 = group_norm(x.float(), gns, gnb, num_groups, eps).reshape(
        N, H * W, C).to(cdt)

    def nin(w, b):
        return torch.matmul(h2, w.to(cdt)).float() + b.float()

    q, k, v = nin(wq, bq), nin(wk, bk), nin(wv, bv)
    s = torch.bmm(q.to(cdt), k.to(cdt).transpose(1, 2)).float() \
        * float(C) ** (-0.5)
    p = torch.softmax(s, dim=-1)
    a = torch.bmm(p.to(cdt), v.to(cdt)).float()
    o = torch.matmul(a.to(cdt), wo.to(cdt)).float() + bo.float()
    out = x.float() + o.reshape(N, H, W, C)
    if rescale:
        out = out * INV_SQRT2
    return out.to(cdt)


@dataclasses.dataclass(frozen=True)
class PackedAttnblock:
    """Attention-block weights in the kernel's layout, for one dtype."""
    channels: int
    gns: Tensor    # (C,) fp32
    gnb: Tensor
    wqkv: Tensor   # (3C, C) = [Wq | Wk | Wv]^T: one row per output channel
    bqkv: Tensor   # (3C,) fp32
    wo: Tensor     # (C, C) = Wout^T
    bo: Tensor     # (C,) fp32


def pack_attnblock_params(params: Tuple, dtype: torch.dtype,
                          device) -> PackedAttnblock:
    gns, gnb, wq, bq, wk, bk, wv, bv, wo, bo = params

    def f32(t):
        return t.detach().to(device, torch.float32).contiguous()

    with torch.no_grad():
        return PackedAttnblock(
            channels=wq.shape[0], gns=f32(gns), gnb=f32(gnb),
            wqkv=torch.cat([wq, wk, wv], 1).t().detach().to(device, dtype).contiguous(),
            bqkv=f32(torch.cat([bq, bk, bv])),
            wo=wo.t().detach().to(device, dtype).contiguous(), bo=f32(bo))


def _launch(x: Tensor, params: Tuple, num_groups: int, eps: float,
            rescale: bool, packed: Optional[PackedAttnblock]) -> Tensor:
    dev, dtype = x.device, x.dtype
    if dtype not in _cuda.DTYPE_CODE:
        raise ValueError(f"fused_attnblock takes fp32 or bf16, not {dtype}")
    N, H, W, C = x.shape
    if H * W > 256 or C % 32 or C % num_groups:
        raise ValueError(f"the attention kernel takes H*W <= 256, C % 32 == 0 "
                         f"and C divisible by the groups; got {H}x{W}x{C}, "
                         f"{num_groups} groups")
    pk = packed or pack_attnblock_params(params, dtype, dev)
    if pk.channels != C or pk.wqkv.dtype != dtype or pk.wqkv.device != dev:
        raise ValueError("packed weights do not match the input")
    p_x = _cuda.check_operand(x, "x", dev, dtype)
    out = torch.empty_like(x)
    rows = N * H * W * x.element_size()
    # h = GN(x), q|k|v, attention output; buf owns the memory while queued
    buf, (h, qkv, att), ws = _cuda.scratch(dev, rows * C, rows * 3 * C, rows * C)
    err = _cuda.lib().diffpure_attnblock_fwd(
        _cuda.DTYPE_CODE[dtype], p_x, N, H, W, C, pk.gns.data_ptr(),
        pk.gnb.data_ptr(), num_groups, pk.wqkv.data_ptr(), pk.bqkv.data_ptr(),
        pk.wo.data_ptr(), pk.bo.data_ptr(), eps,
        INV_SQRT2 if rescale else 1.0, h, qkv, att, ws,
        _cuda.SPLITK_WORKSPACE, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "fused_attnblock kernel")
    return out


class _FusedAttnblock(torch.autograd.Function):
    """Saves only its inputs; the backward recomputes the plain version."""

    @staticmethod
    def forward(ctx, cfg, x, *params):
        num_groups, eps, rescale, packed = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(x, *params)
        if x.device.type == "cpu":
            return fused_attnblock_reference(x, params, num_groups=num_groups,
                                             eps=eps, rescale=rescale)
        if x.device.type != "cuda":
            raise ValueError(f"fused_attnblock runs on cpu or cuda, not {x.device}")
        out = _launch(x, params, num_groups, eps, rescale, packed)
        fused_attnblock.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        num_groups, eps, rescale, _ = ctx.cfg
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = fused_attnblock_reference(
                leaves[0], tuple(leaves[1:]), num_groups=num_groups, eps=eps,
                rescale=rescale)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(leaves, need) if n], g))
        return (None, *[next(grads) if n else None for n in need])


def fused_attnblock(x: Tensor, params: Tuple, *, num_groups: int,
                    eps: float = 1e-6, rescale: bool = True,
                    packed: Optional[PackedAttnblock] = None) -> Tensor:
    """The block on one NHWC map, differentiable: plain on CPU, the CUDA
    kernel on CUDA."""
    return _FusedAttnblock.apply((num_groups, eps, rescale, packed), x, *params)


# Kernel launches since the last reset (plain CPU calls do not count).
fused_attnblock.launches = 0
