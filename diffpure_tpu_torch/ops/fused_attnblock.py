"""Fused NCSN++ attention block (AttnBlockpp, eval mode).

Port of diffpure_tpu/ops/fused_attnblock.py: ``fused_attnblock_reference``
(:151) in plain PyTorch, and ``fused_attnblock``, an autograd
``Function`` whose forward is the CUDA kernel in
``csrc/fused_attnblock.cu`` (bf16) and ``csrc/attnblock_f32.cu`` (fp32)
(replacing ``fused_attnblock_pallas``, :106) and
whose backward is autograd of the plain version, as JAX's ``_fab_bwd``
(:200-206) is: the TPU has no attention backward kernel either
(``_cuda.KernelFunction``). On a CPU tensor the forward runs the plain
version; on a CUDA tensor it launches the kernel or raises.

bf16 runs a chain on the tensor cores: the GroupNorm pass, the q | k | v
NIN on the wgmma GEMM of ``csrc/igemm_wgmma.cuh`` (weights from
``pack_attnblock_params``' pre-swizzled stages, tiles and split-K from
``attnblock_plan``), and the HW x HW core with the output NIN folded in,
on wgmma + TMA; it takes what ``check_attnblock_shape`` passes and raises
on the rest. fp32 runs a chain on the FMA units (TF32 stays off): the
GroupNorm pass of kernel #10 without its SiLU, the q | k | v NIN as an fp32
GEMM, and a register-tiled core with the output NIN folded in, planned by
``attnblock_f32_plan``.

The block: GN -> q, k, v = NIN(h) -> softmax(q k^T C^-1/2) in fp32 -> @ v
-> NIN -> + x, times 1/sqrt(2) when rescaled. NIN weights are (in, out).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops.fused_resblock import INV_SQRT2, KC, RB_GN_MAX_G, SMS, \
    GemmPlan, _gemm_plan, _plan_ints
from diffpure_tpu_torch.ops.groupnorm import GnSiluPlan, gn_silu_plan, group_norm
from diffpure_tpu_torch.ops.halo_conv import _swizzle128

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
    """Attention-block weights in the kernel's layout, for one dtype: the
    NIN weights for fp32's chain (wqkv, wo) or bf16's (wqkvs, wos), never
    both; bf16 off multiples of 64 channels gets neither."""
    channels: int
    gns: Tensor    # (C,) fp32
    gnb: Tensor
    bqkv: Tensor   # (3C,) fp32
    bo: Tensor     # (C,) fp32
    # fp32: (3C, C) = [Wq | Wk | Wv]^T, one row per output channel; (C, C)
    # = Wout^T
    wqkv: Optional[Tensor] = None
    wo: Optional[Tensor] = None
    # bf16 with C % 64 == 0: the wgmma GEMM's projection stages (the
    # resblock skip projection's layout): (C / 64, outputs, 64), step j,
    # row o holding W[64 j + c, o] at c, each row in the 128-byte swizzle
    wqkvs: Optional[Tensor] = None  # (C / 64, 3C, 64) of [Wq | Wk | Wv]
    wos: Optional[Tensor] = None    # (C / 64, C, 64) of Wout
    # the device pointers the launch passes, taken once here: gns, gnb,
    # wqkv, bqkv, wo, bo, wqkvs, wos (0 for None)
    ptrs: Tuple[int, ...] = ()


def nin_stages(w: Tensor, dtype: torch.dtype, device) -> Tensor:
    """A (cin, cout) NIN weight as the wgmma GEMM's projection stages,
    (cin / 64, cout, 64): step j, row o holds w[64 j + c, o] at c."""
    cin, cout = w.shape
    wk = w.detach().to(device, dtype).reshape(cin // KC, KC, cout).permute(0, 2, 1)
    return _swizzle128(wk.contiguous()).contiguous()


def pack_attnblock_params(params: Tuple, dtype: torch.dtype,
                          device) -> PackedAttnblock:
    """Repack NIN-layout block weights for the kernels (done once per module
    and dtype by the caller, not per launch)."""
    gns, gnb, wq, bq, wk, bk, wv, bv, wo, bo = params

    def f32(t):
        return t.detach().to(device, torch.float32).contiguous()

    with torch.no_grad():
        C = wq.shape[0]
        wcat = torch.cat([wq, wk, wv], 1)
        t = dict(gns=f32(gns), gnb=f32(gnb), wqkv=None, bqkv=f32(torch.cat([bq, bk, bv])),
                 wo=None, bo=f32(bo), wqkvs=None, wos=None)
        if dtype != torch.bfloat16:
            t.update(wqkv=wcat.t().detach().to(device, dtype).contiguous(),
                     wo=wo.t().detach().to(device, dtype).contiguous())
        elif C % KC == 0:
            t.update(wqkvs=nin_stages(wcat, dtype, device), wos=nin_stages(wo, dtype, device))
        return PackedAttnblock(channels=C, ptrs=tuple(0 if v is None else v.data_ptr()
                                                      for v in t.values()), **t)


# The bf16 core's limits (csrc/fused_attnblock.cu): at most 4 chunks of 64
# channels, a score row of at most AT_KEYS keys.
AT_MAX_C = 256
AT_KEYS = 256


@dataclasses.dataclass(frozen=True)
class AttnblockPlan:
    """The bf16 chain's q | k | v GEMM (3C outputs), tiled and split as a
    resblock GEMM (ops/fused_resblock.py _gemm_plan: C / 64 projection K
    steps), and the 6 ints the C side reads, (bm, bn, bh, bimg, splits,
    per). The output NIN runs in the core and needs no plan."""
    gemm: GemmPlan
    ints: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def attnblock_plan(N: int, H: int, W: int, C: int, sms: int = SMS,
                   ws_elems: int = _cuda.SPLITK_WORKSPACE) -> AttnblockPlan:
    g = _gemm_plan(N, H, W, 3 * C, C // KC, sms, ws_elems)
    return AttnblockPlan(g, (g.bm, g.bn, g.box[1], g.box[2], g.splits, g.per))


def check_attnblock_shape(dtype: torch.dtype, N: int, H: int, W: int, C: int,
                          groups: int, sms: int = SMS) -> Optional[AttnblockPlan]:
    """Raise on what the kernels for ``dtype`` do not take; the bf16 plan
    (None for fp32, whose chain takes H * W <= 256 and C % 32 == 0 and is
    planned by ``attnblock_f32_plan``). The bf16 plan raises where the
    GEMMs' TMA boxes do not tile the map.

    What bounds the chains on this card, and what they do about it: bf16
    runs on the tensor cores, where at batch 8 the three launches' latencies
    and at batch 128 the q | k | v GEMM (K is only C / 64 steps) set the
    time; its core keeps whole score rows and a in registers and runs the
    output NIN from them. fp32 runs on the FMA units, where a thread's
    register tile must feed about 16 FMAs per 16-byte shared load (8 x 8
    outputs) for the FMAs, not shared memory, to set the pace: the q | k |
    v GEMM takes 128 x 96 tiles of 8 x 8 a thread, the core 16 queries a
    block with 8 x 8 tiles and the contraction split over four warps, K, V
    and Wout^T streaming from L2 through a cp.async ring, the output NIN
    from a on chip; ``attnblock_f32_plan`` tiles it."""
    if dtype not in _cuda.DTYPE_CODE:
        raise ValueError(f"fused_attnblock takes fp32 or bf16, not {dtype}")
    if H * W > AT_KEYS or C % groups:
        raise ValueError(f"the attention kernels take H*W <= {AT_KEYS} and C divisible "
                         f"by the groups; got {H}x{W}x{C}, {groups} groups")
    if dtype != torch.bfloat16:
        if C % AF_CK:
            raise ValueError(f"the fp32 attention kernel takes C % {AF_CK} == 0; got {C}")
        return None
    if C % KC or C > AT_MAX_C or groups > RB_GN_MAX_G:
        raise ValueError(f"the bf16 attention kernels take C a multiple of {KC} up to "
                         f"{AT_MAX_C} in at most {RB_GN_MAX_G} groups; got {C} in {groups}")
    return attnblock_plan(N, H, W, C, sms)


# The fp32 core (csrc/attnblock_f32.cu attn_f32_kernel): 16 queries a
# block, chunks of 32 channels (keys) through a ring of four stages of 256
# rows (two where shared memory does not hold four), score rows of 128 kj
# keys (kj 1 or 2), output passes of 128 kjo channels.
AF_QT = 16
AF_CK = 32
QK_BM, QK_BN = 128, 96  # the fp32 q | k | v GEMM's tile (attn_qkv_f32_kernel)
AF_SMEM_MAX = 232448  # bytes of shared memory a block may opt into


@dataclasses.dataclass(frozen=True)
class AttnblockF32Plan:
    """The fp32 chain: the GroupNorm pass (``gn``, kernel #10's planner),
    the core's key width ``kj`` (128 kj keys a score row), its output NIN's
    pass width ``kjo`` (128 kjo channels) and ``osplit`` (the output
    channels split over that many blocks of the same queries, where the
    (query tiles, examples) grid leaves most SMs idle), its grid and shared
    memory; ``ksplit``, the K slices of the q | k | v GEMM (128 x 96 tiles)
    where its tiles leave most SMs idle; ``stages``, the core's ring depth
    (4, or 2 where shared memory does not hold 4); and the 11 ints the C
    side reads (the GN's 5, then kj, kjo, 32, osplit, ksplit, stages)."""
    gn: GnSiluPlan
    kj: int
    kjo: int
    osplit: int
    ksplit: int
    stages: int
    grid: Tuple[int, int, int]
    smem: int
    ints: Tuple[int, ...]


def _f32_smem(C: int, kj: int, stages: int) -> int:
    return 4 * (AF_QT * (C + 4) + AF_QT * (128 * kj + 4) + stages * 256 * (AF_CK + 4))


@functools.lru_cache(maxsize=None)
def attnblock_f32_plan(N: int, H: int, W: int, C: int, groups: int,
                       sms: int = SMS) -> AttnblockF32Plan:
    """Tile the fp32 chain at (N, H, W, C): 16 queries a block, a score row
    of 128 keys (H * W <= 128) or 256; the output channels split in powers
    of two, into slices of at least 128 (a pass's width), while the blocks
    stay within the SMs. Raises where the shape's Q and a rows outgrow
    shared memory (C above about 2200)."""
    check_attnblock_shape(torch.float32, N, H, W, C, groups, sms)
    hw = H * W
    kj = 1 if hw <= 128 else 2
    tiles = -(-hw // AF_QT) * N
    osplit = 1
    while tiles * osplit * 2 <= sms and C % (osplit * 2 * AF_CK) == 0 \
            and C // (osplit * 2) >= 128:
        osplit *= 2
    kjo = 1 if C // osplit <= 128 else 2
    stages = 4 if _f32_smem(C, kj, 4) <= AF_SMEM_MAX else 2
    smem = _f32_smem(C, kj, stages)
    if smem > AF_SMEM_MAX:
        raise ValueError(f"the fp32 attention core holds 16 rows of q and of a in shared "
                         f"memory: {smem} bytes at C = {C}, above {AF_SMEM_MAX}")
    gn = gn_silu_plan(N, hw, C, groups, torch.float32, sms)
    # the GEMM: K slices of at least 64 channels (two steps) while its tiles
    # fill at most half the SMs and the partials fit the workspace
    gemm_tiles = -(-(N * hw) // QK_BM) * (3 * C // QK_BN)
    ksplit = 1
    while gemm_tiles * ksplit * 2 <= sms and C % (ksplit * 2 * 64) == 0 \
            and ksplit * 2 * N * hw * 3 * C <= _cuda.SPLITK_WORKSPACE:
        ksplit *= 2
    return AttnblockF32Plan(gn, kj, kjo, osplit, ksplit, stages, (-(-hw // AF_QT), N, osplit),
                            smem, gn.ints + (kj, kjo, AF_CK, osplit, ksplit, stages))


def _launch(x: Tensor, params: Tuple, num_groups: int, eps: float,
            rescale: bool, packed: Optional[PackedAttnblock]) -> Tensor:
    dev, dtype = x.device, x.dtype
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    N, H, W, C = x.shape
    sms = _cuda.num_sms(dev)
    plan = check_attnblock_shape(dtype, N, H, W, C, num_groups, sms) \
        or attnblock_f32_plan(N, H, W, C, num_groups, sms)
    pk = packed or pack_attnblock_params(params, dtype, dev)
    w = pk.wqkvs if dtype == torch.bfloat16 else pk.wqkv
    if pk.channels != C or w is None or w.dtype != dtype or w.device != dev:
        raise ValueError("packed weights do not match the input")
    p_x = _cuda.check_operand(x, "x", dev, dtype)
    out = torch.empty_like(x)
    rows = N * H * W * x.element_size()
    # h = GN(x) and q|k|v (the attention output stays in the core); buf
    # owns the memory while queued
    buf, (h, qkv), ws = _cuda.scratch(dev, rows * C, rows * 3 * C)
    gns, gnb, wqkv, bqkv, wo, bo, wqkvs, wos = pk.ptrs
    err = _cuda.lib().diffpure_attnblock_fwd(
        _cuda.DTYPE_CODE[dtype], p_x, N, H, W, C, gns, gnb, num_groups, wqkv, bqkv,
        wo, bo, eps, INV_SQRT2 if rescale else 1.0, h, qkv, ws,
        _cuda.SPLITK_WORKSPACE, out.data_ptr(), wqkvs, wos, _plan_ints(plan),
        _cuda.stream(dev))
    _cuda.check(err, "fused_attnblock kernel")
    return out


def _attn_kernel(cfg, x, *params):
    num_groups, eps, rescale, packed = cfg
    out = _launch(x, params, num_groups, eps, rescale, packed)
    fused_attnblock.launches += 1
    return out


def _attn_plain(cfg, x, *params):
    num_groups, eps, rescale, _ = cfg
    return fused_attnblock_reference(x, params, num_groups=num_groups, eps=eps,
                                     rescale=rescale)


_ATTN = (_attn_kernel, _attn_plain, _cuda.autograd_vjp(_attn_plain))


def fused_attnblock(x: Tensor, params: Tuple, *, num_groups: int,
                    eps: float = 1e-6, rescale: bool = True,
                    packed: Optional[PackedAttnblock] = None) -> Tensor:
    """The block on one NHWC map, differentiable: plain on CPU, the CUDA
    kernel on CUDA (``_cuda.KernelFunction``: it saves only its inputs, and
    its backward recomputes the plain version)."""
    _cuda.check_device("fused_attnblock", x)
    return _cuda.KernelFunction.apply(_ATTN, (num_groups, eps, rescale, packed), x, *params)


# Kernel launches since the last reset (plain CPU calls do not count).
fused_attnblock.launches = 0
