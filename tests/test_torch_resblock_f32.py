"""The plain parts of the fp32 fused-resblock forward (csrc/resblock_f32.cu:
f32conv_kernel on the FMA units, rb_gn_kernel<float, float>): its tile,
ring and split-K plan over the full-width CIFAR NCSN++'s block census at
the batches of the run scripts and the benches, its shape gate, the weight
operand it reads, and the implicit GEMM's indexing (taps, SAME zeros, the
projection's x1 | x2 seam, K slices summed in order), emulated here in
PyTorch with the kernel's own formulas and held against the Pallas kernels
in interpret mode. The kernel itself runs only on the card (chip_smoke.py
phase 2 holds it against the plain version at batch 8 and 64)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffpure_tpu.ops.fused_resblock import fused_resblock_cat_pallas, \
    fused_resblock_pallas
from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops import fused_resblock as frb
from diffpure_tpu_torch.ops.groupnorm import group_norm, ncsn_num_groups
from diffpure_tpu_torch.ops.upfirdn2d import naive_downsample_2d, naive_upsample_2d
from test_torch_resblock_wgmma import census  # noqa: F401 (a fixture)
from torch_parity import REL, assert_close, normal, resblock_params, \
    resblock_params_torch, to_jax, to_torch

# an SM's shared memory (H100: 228 KB, of which a block may use 227 KB)
SMEM_PER_SM = 233472


def _slices(steps, splits, per):
    return [(z * per, min(steps, (z + 1) * per)) for z in range(splits)]


def _proj(name, rs, c1, c2, cout):
    return name == "fused_resblock_cat" or rs != "none" or c1 + c2 != cout


@pytest.mark.parametrize("batch", [1, 2, 8, 16, 64, 128])
def test_f32_plan_covers_the_census(census, batch):  # noqa: F811
    """At every census shape: 128 x 128 tiles that cover the N Ho Wo rows
    and the output channels once; per conv a thread tile of 8 x 16 or 8 x
    8, a ring that fits an SM's shared memory as often as the tile's blocks
    share an SM; K slices that cover the conv's steps in order, all full
    but the last, at least F32_MIN_STEPS each; partials that fit the
    workspace; a grid that fills its waves to RB_MIN_FILL, or splits K as
    far as its caps allow; 8 x 8 only where 8 x 16 would cut K into slices
    under F32_MIN_PER steps."""
    for (name, rs, H, c1, c2, cout), _ in sorted(census.items()):
        cin = c1 + c2
        proj = _proj(name, rs, c1, c2, cout)
        plan = frb.check_resblock_shape(torch.float32, batch, H, H, c1, c2, cout, rs, proj,
                                        32, 32)
        assert isinstance(plan, frb.ResblockF32Plan)
        Ho = {"none": H, "down": H // 2, "up": 2 * H}[rs]
        M = batch * Ho * Ho
        assert (plan.mtiles - 1) * frb.F32_BM < M <= plan.mtiles * frb.F32_BM
        assert (plan.ntiles - 1) * frb.F32_BN < cout <= plan.ntiles * frb.F32_BN
        tiles = plan.mtiles * plan.ntiles
        steps = (-(-9 * cin // 32), -(-(9 * cout + (cin if proj else 0)) // 32))
        for conv, k in zip(plan.convs, steps):
            assert conv.steps == k and conv.tn in frb.F32_TN
            assert conv.stages == frb.F32_STAGES[conv.tn] and 2 <= conv.stages <= 4
            assert conv.smem == 4 * conv.stages * (frb.F32_BM + frb.F32_BN) * frb.F32_ROW
            assert conv.smem <= frb.SMEM_PER_BLOCK
            assert frb.F32_BLOCKS_PER_SM[conv.tn] * (conv.smem + frb.SMEM_RESERVED) \
                <= SMEM_PER_SM
            cuts = _slices(k, conv.splits, conv.per)
            assert cuts[0][0] == 0 and cuts[-1][1] == k
            assert all(b - a == conv.per for a, b in cuts[:-1]) and cuts[-1][1] > cuts[-1][0]
            assert all(cuts[i][1] == cuts[i + 1][0] for i in range(len(cuts) - 1))
            assert conv.splits == 1 or conv.per >= frb.F32_MIN_STEPS
            if conv.splits > 1:
                assert conv.splits * M * cout <= _cuda.SPLITK_WORKSPACE
            slots = 132 * frb.F32_BLOCKS_PER_SM[conv.tn]
            if tiles / (-(-tiles // slots) * slots) >= frb.RB_MIN_FILL:
                assert conv.splits == 1
            else:  # as many slices as the SMs, the steps, the cap and the workspace allow
                s = max(1, min(slots // tiles, k // frb.F32_MIN_STEPS, frb.F32_MAX_SPLITS,
                               _cuda.SPLITK_WORKSPACE // (M * cout)))
                assert conv.per == -(-k // s) and tiles * conv.splits <= max(tiles, slots)
            if conv.tn == 8:
                s16, p16 = frb._f32_split(k, tiles, M, cout, 132 * frb.F32_BLOCKS_PER_SM[16],
                                          _cuda.SPLITK_WORKSPACE)
                assert s16 > 1 and p16 < frb.F32_MIN_PER
        assert plan.ints == tuple(v for c in plan.convs
                                  for v in (c.tn, c.stages, c.splits, c.per))


def test_f32_plan_fills_the_run_scripts_batch(census):  # noqa: F811
    """At batch 64 (the run scripts' --adv_batch_size) every conv's grid
    fills its waves to RB_MIN_FILL, a grid of a wave's blocks or more
    without splitting K, and the maps of 16 x 16 and more take the 8 x 16
    thread tile."""
    for (name, rs, H, c1, c2, cout), _ in sorted(census.items()):
        plan = frb.check_resblock_shape(torch.float32, 64, H, H, c1, c2, cout, rs,
                                        _proj(name, rs, c1, c2, cout), 32, 32)
        tiles = plan.mtiles * plan.ntiles
        for conv in plan.convs:
            slots = 132 * frb.F32_BLOCKS_PER_SM[conv.tn]
            blocks = tiles * conv.splits
            assert blocks / (-(-blocks // slots) * slots) >= frb.RB_MIN_FILL
            if tiles >= slots:
                assert conv.splits == 1
            if {"none": H, "down": H // 2, "up": 2 * H}[rs] >= 16:
                assert conv.tn == 16


@pytest.mark.parametrize("N,H,W,c1,c2,cout,rs,proj,g1,g2", [
    (8, 16, 16, 128, 0, 128, "none", False, 32, 32),
    (8, 12, 12, 36, 0, 20, "none", True, 9, 5),
    (2, 6, 6, 4, 0, 8, "down", True, 1, 2),
    (3, 16, 24, 100, 28, 64, "none", True, 32, 16),
    (1, 5, 7, 12, 0, 12, "up", False, 3, 3),
    (4, 8, 8, 512, 0, 1024, "none", True, 2, 4),
    (2, 4, 4, 2048, 0, 2048, "down", False, 8, 8),
    (16, 32, 32, 128, 128, 128, "none", True, 32, 32)])
def test_f32_gate_takes_what_the_old_route_took(N, H, W, c1, c2, cout, rs, proj, g1, g2):
    """Channel counts that are multiples of 4 on any map (the old fp32
    route's rule), the GroupNorm pass's widest groups too: a plan, with
    conv1's K the 3x3 conv's and the projection's."""
    plan = frb.check_resblock_shape(torch.float32, N, H, W, c1, c2, cout, rs, proj, g1, g2)
    assert isinstance(plan, frb.ResblockF32Plan)
    Ho, Wo = {"none": (H, W), "down": (H // 2, W // 2), "up": (2 * H, 2 * W)}[rs]
    assert plan.mtiles == -(-N * Ho * Wo // 128)
    assert plan.convs[1].steps == -(-(9 * cout + ((c1 + c2) if proj else 0)) // 32)


@pytest.mark.parametrize("c1,c2,cout", [(6, 0, 8), (8, 2, 8), (8, 0, 10), (130, 0, 128),
                                        (128, 126, 128)])
def test_f32_gate_raises_off_multiples_of_4(c1, c2, cout):
    with pytest.raises(ValueError, match="multiples of 4"):
        frb.check_resblock_shape(torch.float32, 8, 16, 16, c1, c2, cout, "none", True, 2, 2)


@pytest.mark.parametrize("proj", [True, False])
def test_f32_operand_holds_the_oihw_weights(proj):
    """The fp32 GEMM reads the pack's w0 (cout, 9 cin) and w1 (cout, 9 cout
    [+ cin]) as W[n, k], k = tap * C + c (tap 3 dy + dx) and the projection
    at 9 cout + c: index by index the OIHW weights in fp32, the bias1 of
    conv1's epilogue b1 [+ bskip]; no bf16 stages."""
    cin, cout = (96, 128) if proj else (128, 128)
    rng = np.random.default_rng(7)
    p = resblock_params_torch(resblock_params(rng, cin, cout, proj))
    pk = frb.pack_resblock_params(p, torch.float32, "cpu")
    assert pk.w0.dtype == torch.float32 and pk.w0s is None and pk.w1s is None
    assert pk.w1.shape == (cout, 9 * cout + (cin if proj else 0))
    for n, c, dy, dx in [(0, 0, 0, 0), (5, 70, 1, 2), (127, 95, 2, 2), (64, 9, 2, 0)]:
        k = 3 * dy + dx
        assert pk.w0[n, k * cin + c] == p[2][n, c, dy, dx]
        assert pk.w1[n, k * cout + c] == p[6][n, c, dy, dx]
        if proj:
            assert pk.w1[n, 9 * cout + c] == p[8][n, c]
    assert torch.equal(pk.bias1, p[7] + p[9] if proj else p[7])


def emulate_f32conv(act, p1, p2, c1, c2, w, bias, temb, resid, oscale, Ho, Wo, splits, per):
    """f32conv_kernel's arithmetic with its own index formulas: A[m, k] for
    k < 9 C is act at flat pixel m + dy Wo + dx, channel c (tap = k // C,
    c = k - tap C), zero where (oy + dy, ox + dx) leaves the map; for k >= 9
    C, channel k - 9 C of p1 (c1 channels) or, past the seam, of p2; one
    16-byte copy (4 k) at a time, as the kernel's cp.async. K in slices of
    ``per`` steps of 32 summed in slice order, then (sum + bias + temb[n] +
    resid) * oscale."""
    N = act.shape[0]
    C = act.shape[-1]
    M, K = N * Ho * Wo, w.shape[1]
    a_flat = act.reshape(M, C)
    m = torch.arange(M)
    oy, ox = (m % (Ho * Wo)) // Wo, m % Wo
    A = torch.zeros(M, K)
    for k in range(0, K, 4):
        if k < 9 * C:
            tap, c = k // C, k - (k // C) * C
            dy, dx = tap // 3 - 1, tap % 3 - 1
            ok = (oy + dy >= 0) & (oy + dy < Ho) & (ox + dx >= 0) & (ox + dx < Wo)
            src = (m + dy * Wo + dx).clamp(0, M - 1)
            A[:, k:k + 4] = torch.where(ok[:, None], a_flat[src, c:c + 4], 0.0)
        else:
            cp = k - 9 * C
            if cp < c1:
                A[:, k:k + 4] = p1.reshape(M, c1)[:, cp:cp + 4]
            else:
                A[:, k:k + 4] = p2.reshape(M, c2)[:, cp - c1:cp - c1 + 4]
    acc = torch.zeros(M, w.shape[0])
    for z in range(splits):
        k0, k1 = z * per * 32, min(K, (z + 1) * per * 32)
        acc = acc + A[:, k0:k1] @ w[:, k0:k1].t()
    v = acc + bias
    if temb is not None:
        v = v + temb.repeat_interleave(Ho * Wo, 0)
    if resid is not None:
        v = v + resid.reshape(M, -1)
    return (v * oscale).reshape(N, Ho, Wo, -1)


def emulate_f32_chain(x1, x2, temb, params, g1, g2, rs):
    """resblock_fwd_f32's four steps: the GroupNorm passes as the plain
    GroupNorm + SiLU + resample they compute, the convs by
    emulate_f32conv on the pack's w0 / w1, tiled and split by
    resblock_f32_plan at 132 SMs."""
    x = x1 if x2 is None else torch.cat([x1, x2], -1)
    N, H, W, cin = x.shape
    pk = frb.pack_resblock_params(params, torch.float32, "cpu")
    c1, c2, cout = x1.shape[-1], 0 if x2 is None else x2.shape[-1], pk.cout
    rsf = {"none": lambda t: t, "down": naive_downsample_2d, "up": naive_upsample_2d}[rs]
    act1 = rsf(F.silu(group_norm(x, params[0], params[1], g1, 1e-6)))
    xs = rsf(x)
    Ho, Wo = act1.shape[1:3]
    plan = frb.check_resblock_shape(torch.float32, N, H, W, c1, c2, cout, rs, pk.has_proj,
                                    g1, g2)
    cv0, cv1 = plan.convs
    h1 = emulate_f32conv(act1, None, None, 0, 0, pk.w0, pk.b0, temb, None, 1.0, Ho, Wo,
                         cv0.splits, cv0.per)
    act2 = F.silu(group_norm(h1, params[4], params[5], g2, 1e-6))
    s1 = x1 if rs == "none" else xs
    if pk.has_proj:
        p1, q1 = s1, (c1 if rs == "none" else cin)
        p2, q2 = (x2, c2) if rs == "none" else (None, 0)
        resid = None
    else:
        p1 = p2 = None
        q1 = q2 = 0
        resid = s1
    return emulate_f32conv(act2, p1, p2, q1, q2, pk.w1, pk.bias1, None, resid, frb.INV_SQRT2,
                           Ho, Wo, cv1.splits, cv1.per)


# (resample, H, cin, cout, projection, batch): a split K (small maps at
# batch 2), the down / up grids, an identity skip, channels off 32
BLOCKS = [("none", 8, 32, 64, True, 2), ("down", 8, 64, 64, False, 3),
          ("up", 4, 96, 64, True, 2), ("none", 6, 36, 36, False, 2),
          ("up", 4, 32, 32, False, 1)]


@pytest.mark.parametrize("rs,H,cin,cout,proj,N", BLOCKS)
def test_f32_gemm_indexing_matches_the_pallas_kernel(rs, H, cin, cout, proj, N):
    rng = np.random.default_rng(cin + cout + H)
    x = normal(rng, N, H, H, cin)
    temb = normal(rng, N, cout, scale=0.3)
    p = resblock_params(rng, cin, cout, proj)
    g1, g2 = ncsn_num_groups(cin), ncsn_num_groups(cout)
    want = fused_resblock_pallas(to_jax(x), to_jax(temb), tuple(to_jax(a) for a in p),
                                 num_groups1=g1, num_groups2=g2, resample=rs, interpret=True)
    got = emulate_f32_chain(to_torch(x), None, to_torch(temb), resblock_params_torch(p), g1,
                            g2, rs)
    assert_close(got, want, REL["float32"], f"f32 chain {rs} {cin}->{cout}")


# (c1, c2, cout, H, N): the seam at a group edge and inside a group, and a
# 4-channel-aligned seam off 8
CATS = [(64, 32, 64, 8, 2), (64, 96, 96, 4, 2), (36, 28, 32, 6, 1)]


@pytest.mark.parametrize("c1,c2,cout,H,N", CATS)
def test_f32_gemm_seam_matches_the_pallas_kernel(c1, c2, cout, H, N):
    rng = np.random.default_rng(c1 + c2 + H)
    x1, x2 = normal(rng, N, H, H, c1), normal(rng, N, H, H, c2, scale=2.0)
    temb = normal(rng, N, cout, scale=0.3)
    p = resblock_params(rng, c1 + c2, cout)
    g1, g2 = ncsn_num_groups(c1 + c2), ncsn_num_groups(cout)
    want = fused_resblock_cat_pallas(to_jax(x1), to_jax(x2), to_jax(temb),
                                     tuple(to_jax(a) for a in p), num_groups1=g1,
                                     num_groups2=g2, interpret=True)
    got = emulate_f32_chain(to_torch(x1), to_torch(x2), to_torch(temb),
                            resblock_params_torch(p), g1, g2, "none")
    assert_close(got, want, REL["float32"], f"f32 cat {c1}|{c2}->{cout}")
