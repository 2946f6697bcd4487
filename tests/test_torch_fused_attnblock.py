"""The port's fused attention block (plain version, which its wrapper runs
on CPU tensors) against the TPU kernel #3 fused_attnblock_pallas in Pallas
interpret mode, and the plain parts of its bf16 chain on the card (the NIN
weight stages, the GEMM plans over the CIFAR NCSN++'s attention census,
the shape gate), and of its fp32 chain (attnblock_f32_plan over the
NCSN++'s and the score_sde DDPM's attention census). The CUDA kernels are
checked on the card by chip_smoke.py (phase 2, against the plain version at
batch 8, 16 and 128)."""
from collections import Counter

import numpy as np
import pytest
import torch

from diffpure_tpu.ops.fused_attnblock import fused_attnblock_pallas
from diffpure_tpu_torch.config import load_config
from diffpure_tpu_torch.models import layers, ncsnpp_from_config
from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops import fused_attnblock as fab
from diffpure_tpu_torch.ops import fused_resblock as frb
from diffpure_tpu_torch.ops import groupnorm
from torch_parity import DTYPES, REL, assert_close, attnblock_params, ddpm_census, \
    normal, to_jax, to_torch


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hw", [4, 8])  # HW = 16 and 64 positions
def test_attnblock_matches_pallas(hw, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(hw)
    C = 64
    x = normal(rng, 2, hw, hw, C)
    p = attnblock_params(rng, C)
    want = fused_attnblock_pallas(to_jax(x, jdt), tuple(to_jax(a) for a in p),
                                  num_groups=16, interpret=True)
    launches = fab.fused_attnblock.launches
    with torch.inference_mode():
        got = fab.fused_attnblock(to_torch(x, tdt),
                                  tuple(to_torch(a) for a in p), num_groups=16)
    assert got.dtype == tdt
    assert fab.fused_attnblock.launches == launches  # CPU: plain, no launch
    assert_close(got, want, REL[dtype], f"attnblock hw={hw * hw}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attnblock_keeps_examples_apart(dtype):
    """An Inf in one example leaves the others' outputs finite and equal to
    JAX's kernel on the same batch: what chip_smoke.py's phase 2 holds the
    CUDA chain to (phase_attn_isolation) against this plain version."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = normal(rng, 3, 4, 4, 64)
    x[1, 0, 0, 0] = np.inf
    p = attnblock_params(rng, 64)
    want = np.asarray(fused_attnblock_pallas(
        to_jax(x, jdt), tuple(to_jax(a) for a in p), num_groups=16, interpret=True),
        np.float32)
    with torch.inference_mode():
        got = fab.fused_attnblock(to_torch(x, tdt), tuple(to_torch(a) for a in p),
                                  num_groups=16).float()
    assert not torch.isfinite(got[1]).all()
    for e in (0, 2):
        assert torch.isfinite(got[e]).all()
        assert_close(got[e], want[e], REL[dtype], f"attnblock example {e}")


def test_pack_layout():
    rng = np.random.default_rng(0)
    p = tuple(to_torch(a) for a in attnblock_params(rng, 8))
    pk = fab.pack_attnblock_params(p, torch.float32, "cpu")
    assert torch.equal(pk.wqkv, torch.cat([p[2], p[4], p[6]], 1).t())
    assert torch.equal(pk.wo, p[8].t())
    assert torch.equal(pk.bqkv, torch.cat([p[3], p[5], p[7]]))
    assert pk.wqkvs is None and pk.wos is None


def stage_index(c, o):
    """Where a NIN stage pack keeps weight (input channel c, output channel
    o): step c // 64, row o, the 16-byte group of c swizzled by o % 8
    (wgmma's 128-byte swizzle)."""
    return c // 64, o, ((c % 64 // 8) ^ (o % 8)) * 8 + c % 8


def test_nin_stage_pack_holds_the_weights():
    """wqkvs holds [Wq | Wk | Wv][c, o] and wos Wout[c, o] at step c // 64,
    row o, swizzled; each is a permutation of its weights in bf16; the
    cached pointers are the tensors' (0 for the fp32 chain's weights, which
    bf16 does not hold). fp32, and bf16 off multiples of 64, get no
    stages."""
    rng = np.random.default_rng(7)
    C = 128
    p = tuple(to_torch(a) for a in attnblock_params(rng, C))
    pk = fab.pack_attnblock_params(p, torch.bfloat16, "cpu")
    wcat = torch.cat([p[2], p[4], p[6]], 1).to(torch.bfloat16)
    wo = p[8].to(torch.bfloat16)
    assert pk.wqkvs.shape == (C // 64, 3 * C, 64) and pk.wqkvs.dtype == torch.bfloat16
    assert pk.wos.shape == (C // 64, C, 64) and pk.wos.is_contiguous()
    for c, o in [(0, 0), (5, 70), (127, 383), (64, 9), (100, 255), (63, 128), (71, 1)]:
        assert pk.wqkvs[stage_index(c, o)] == wcat[c, o]
        assert pk.wos[stage_index(c, o % C)] == wo[c, o % C]
    assert torch.equal(pk.wqkvs.float().reshape(-1).sort().values,
                       wcat.float().reshape(-1).sort().values)
    assert torch.equal(pk.wos.float().reshape(-1).sort().values,
                       wo.float().reshape(-1).sort().values)
    assert pk.wqkv is None and pk.wo is None
    assert pk.ptrs == (pk.gns.data_ptr(), pk.gnb.data_ptr(), 0, pk.bqkv.data_ptr(), 0,
                       pk.bo.data_ptr(), pk.wqkvs.data_ptr(), pk.wos.data_ptr())
    assert fab.pack_attnblock_params(p, torch.float32, "cpu").wqkvs is None
    p96 = tuple(to_torch(a) for a in attnblock_params(rng, 96))
    assert fab.pack_attnblock_params(p96, torch.bfloat16, "cpu").wos is None


@pytest.fixture(scope="module")
def attn_census():
    """(H, C) -> attention block calls over one evaluation of the full-width
    CIFAR NCSN++ (configs/cifar10.yml), walked on the meta device with the
    blocks replaced by recorders of their input shapes."""
    seen = Counter()

    def block(self, x, temb):
        n, H = (x[0] if isinstance(x, tuple) else x).shape[:2]
        Ho = {"none": H, "down": H // 2, "up": 2 * H}[self.resample]
        return torch.empty(n, Ho, Ho, self.Conv_0.out_channels, device="meta")

    def attn(self, x):
        seen[(x.shape[1], x.shape[3])] += 1
        return x

    mp = pytest.MonkeyPatch()
    mp.setattr(layers.ResnetBlockBigGANpp, "forward", block)
    mp.setattr(layers.AttnBlockpp, "forward", attn)
    try:
        with torch.device("meta"):
            model = ncsnpp_from_config(load_config("configs/cifar10.yml"), dtype=torch.bfloat16)
        model(torch.empty(2, 32, 32, 3, device="meta"), torch.empty(2, device="meta"))
    finally:
        mp.undo()
    return dict(seen)


def test_attn_census_is_the_main_path(attn_census):
    """9 calls at 16x16x256 and the middle block at 4x4x256 per evaluation."""
    assert attn_census == {(16, 256): 9, (4, 256): 1}


@pytest.mark.parametrize("batch", [8, 16, 128])
def test_attnblock_plan_covers_the_census(attn_census, batch):
    """At every census shape: the q | k | v GEMM (3C outputs) on a tile the
    wgmma GEMM has, M tiles that cover the N H W rows once, each one TMA
    box of whole rows of one image or of whole images; C / 64 projection K
    steps in slices that cover them in order, with partials that fit the
    workspace; and the 6 ints the C side reads."""
    for (H, C), _ in sorted(attn_census.items()):
        plan = fab.check_attnblock_shape(torch.bfloat16, batch, H, H, C, 32)
        hw, M, g, nout = H * H, batch * H * H, plan.gemm, 3 * C
        assert (g.bm, g.bn) in frb.RB_TILES and nout % g.bn == 0 and g.nout == nout
        bw, bh, bimg = g.box
        assert bw == H and bw * bh * bimg == g.bm and max(g.box) <= 256
        assert g.mtiles == -(-M // g.bm) and g.ntiles == nout // g.bn
        rows = set()
        for t in range(g.mtiles):
            m0 = t * g.bm
            if bimg > 1:
                assert bh == H and m0 % hw == 0
            else:
                assert m0 % hw + g.bm <= hw and (m0 % hw) % H == 0
            rows.update(range(m0, min(M, m0 + g.bm)))
        assert rows == set(range(M))
        assert g.steps == C // 64
        cuts = [(z * g.per, min(g.steps, (z + 1) * g.per)) for z in range(g.splits)]
        assert cuts[0][0] == 0 and cuts[-1][1] == g.steps and all(a < b for a, b in cuts)
        assert all(cuts[i][1] == cuts[i + 1][0] for i in range(len(cuts) - 1))
        assert g.splits == 1 or g.splits * M * nout <= _cuda.SPLITK_WORKSPACE
        assert plan.ints == (g.bm, g.bn, bh, bimg, g.splits, g.per)


@pytest.mark.parametrize("dtype,H,W,C,groups,match", [
    (torch.bfloat16, 16, 16, 96, 32, "multiple of 64"),
    (torch.bfloat16, 16, 16, 320, 32, "up to 256"),
    (torch.bfloat16, 16, 16, 256, 128, "at most 64 groups"),
    (torch.bfloat16, 16, 16, 256, 48, "divisible by the groups"),
    (torch.bfloat16, 32, 32, 256, 32, "H\\*W <= 256"),
    (torch.bfloat16, 12, 12, 256, 32, "do not tile"),
    (torch.bfloat16, 6, 6, 256, 32, "do not tile"),
    (torch.float32, 16, 16, 48, 16, "C % 32"),
    (torch.float32, 32, 16, 256, 32, "H\\*W <= 256"),
    (torch.float16, 16, 16, 256, 32, "fp32 or bf16"),
])
def test_attnblock_shape_gate_raises(dtype, H, W, C, groups, match):
    """What the kernels do not take raises before any launch."""
    with pytest.raises(ValueError, match=match):
        fab.check_attnblock_shape(dtype, 8, H, W, C, groups)


@pytest.mark.parametrize("dtype,H,W,C", [
    (torch.bfloat16, 16, 16, 256), (torch.bfloat16, 4, 4, 256), (torch.bfloat16, 8, 8, 128),
    (torch.bfloat16, 2, 128, 192),
    (torch.float32, 16, 16, 256), (torch.float32, 12, 12, 96)])
def test_attnblock_shape_gate_takes(dtype, H, W, C):
    """The census shapes and others the kernels take; fp32 has no plan."""
    plan = fab.check_attnblock_shape(dtype, 8, H, W, C, 32)
    assert (plan is None) == (dtype == torch.float32)


def test_attnblock_has_no_route_off_the_cpu_but_the_kernel():
    """A tensor on neither the CPU nor a card raises; no launch is counted."""
    p = tuple(to_torch(a) for a in attnblock_params(np.random.default_rng(8), 64))
    x = torch.empty(1, 4, 4, 64, device="meta", dtype=torch.bfloat16)
    launches = fab.fused_attnblock.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        fab.fused_attnblock(x, p, num_groups=16)
    assert fab.fused_attnblock.launches == launches


@pytest.mark.parametrize("batch", [8, 16, 128])
def test_attnblock_f32_plan_covers_the_census(attn_census, batch):
    """The fp32 chain at every attention shape of the NCSN++ and the DDPM:
    the grid's 16-query tiles cover each (example, query) once, the output
    slices and passes of 128 kjo channels each output channel once, a score
    row of 128 kj keys holds the map, shared memory stays within 227 KB,
    the q | k | v GEMM's K slices tile C in steps of 32 with partials that
    fit the workspace, the GroupNorm pass is #10's plan, and the 11 ints the
    C side reads."""
    _, ddpm_attn = ddpm_census()
    for H, C in sorted(set(attn_census) | set(ddpm_attn)):
        p = fab.attnblock_f32_plan(batch, H, H, C, 32)
        hw = H * H
        qt, n, osplit = p.grid
        assert n == batch and osplit == p.osplit and qt == -(-hw // fab.AF_QT)
        q = np.arange(qt)[:, None] * fab.AF_QT + np.arange(fab.AF_QT)[None, :]
        q = q[q < hw]
        assert np.array_equal(np.sort(q), np.arange(hw))
        assert C % osplit == 0 and (C // osplit) % 4 == 0
        ocols, width = C // osplit, 128 * p.kjo
        o = [z * ocols + op * width + r for z in range(osplit)
             for op in range(-(-ocols // width)) for r in range(width) if op * width + r < ocols]
        assert sorted(o) == list(range(C))
        assert p.kj in (1, 2) and p.kjo in (1, 2) and 128 * p.kj >= hw
        assert p.stages in (2, 4)
        assert p.smem == 4 * (16 * (C + 4) + 16 * (128 * p.kj + 4) + p.stages * 256 * 36)
        assert p.smem <= fab.AF_SMEM_MAX
        assert C % (32 * p.ksplit) == 0 and 3 * C % fab.QK_BN == 0
        assert p.ksplit == 1 or p.ksplit * batch * hw * 3 * C <= _cuda.SPLITK_WORKSPACE
        assert p.gn == groupnorm.gn_silu_plan(batch, hw, C, 32, torch.float32)
        assert p.ints == p.gn.ints + (p.kj, p.kjo, fab.AF_CK, p.osplit, p.ksplit, p.stages)


def test_attnblock_f32_plan_fills_the_card_at_small_grids():
    """The DDPM's 4 x 4 block at batch 8 (8 query tiles): the output
    channels split over 2 blocks, the q | k | v GEMM's K over 4 slices; at
    16 x 16 (128 tiles) neither splits."""
    small, large = fab.attnblock_f32_plan(8, 4, 4, 256, 32), fab.attnblock_f32_plan(8, 16, 16, 256, 32)
    assert (small.osplit, small.ksplit, small.kj, small.kjo) == (2, 4, 1, 1)
    assert (large.osplit, large.ksplit, large.kj, large.kjo) == (1, 1, 2, 2)


def test_attnblock_f32_plan_raises_where_shared_memory_ends():
    """16 rows of q and of a (C + 4 floats each) stay in shared memory: the
    census's C = 256 takes a ring of four stages, C = 2208 one of two; past
    it the plan raises before any launch."""
    assert fab.attnblock_f32_plan(8, 16, 16, 256, 32).stages == 4
    assert fab.attnblock_f32_plan(8, 16, 16, 2208, 32).stages == 2
    with pytest.raises(ValueError, match="shared"):
        fab.attnblock_f32_plan(8, 16, 16, 2240, 32)
