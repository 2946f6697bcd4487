"""The plain parts of the fp32 fused-resblock backward (csrc/resblock_f32.cu:
the four products on f32conv_kernel, the GroupNorm passes on
rb_gn_kernel<float, float> and rb_gn_bwd_kernel<float, float>): its plan of
four GEMMs over the full-width CIFAR NCSN++'s block census at the batches of
the run scripts and the benches, its shape gate, the transposed weight
operands it reads, and the chain emulated here in PyTorch with the kernels'
own formulas (the GEMMs' tap / seam / K-slice indexing, GN1's backward from
the recompute's statistics, GN2's from one round of sums and squares, the
resample's transpose, the identity skip's fp32 add), held against the Pallas
backward kernels in interpret mode. The kernels run only on the card
(chip_smoke.py phase 2b holds them against autograd of the plain block at
batch 8, 16 and 64)."""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffpure_tpu.ops.fused_resblock import fused_resblock_bwd_pallas, \
    fused_resblock_cat_bwd_pallas
from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops import fused_resblock as frb
from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups
from diffpure_tpu_torch.ops.upfirdn2d import naive_downsample_2d, naive_upsample_2d
from test_torch_resblock_f32 import SMEM_PER_SM, _proj, _slices, emulate_f32conv
from test_torch_resblock_wgmma import census  # noqa: F401 (a fixture)
from torch_parity import REL, assert_close, normal, resblock_params, \
    resblock_params_torch, to_jax, to_torch

F32 = torch.float32
EPS = 1e-6
HO = {"none": lambda h: h, "down": lambda h: h // 2, "up": lambda h: 2 * h}


def _gemms(cin, cout, proj):
    """(output channels, K) of conv0's recompute, conv1^T, conv0^T and the
    skip adjoint (None without a projection)."""
    return ((cout, 9 * cin), (cout, 9 * cout), (cin, 9 * cout), (cin, cout) if proj else None)


@pytest.mark.parametrize("batch", [1, 2, 8, 16, 64, 128])
def test_bwd_f32_plan_covers_the_census(census, batch):  # noqa: F811
    """At every census shape, per GEMM: 128 x 128 tiles that cover the N Ho
    Wo rows and the GEMM's output channels (cout, cout, cin, cin) once; a
    thread tile of 8 x 16 or 8 x 8 and a ring that fits an SM's shared
    memory as often as the tile's blocks share an SM; K slices that cover
    the GEMM's steps in order, all full but the last; partials that fit the
    workspace; 8 x 8 only where 8 x 16 would cut K into slices under
    F32_MIN_PER steps; conv0's recompute planned as the forward's conv0; and
    the 16 ints the C side reads."""
    for (name, rs, H, c1, c2, cout), _ in sorted(census.items()):
        cin = c1 + c2
        proj = _proj(name, rs, c1, c2, cout)
        plan = frb.check_resblock_shape(F32, batch, H, H, c1, c2, cout, rs, proj, 32, 32,
                                        backward=True)
        fwd = frb.check_resblock_shape(F32, batch, H, H, c1, c2, cout, rs, proj, 32, 32)
        assert isinstance(plan, frb.ResblockBwdF32Plan) and len(plan.convs) == 4
        M = batch * HO[rs](H) ** 2
        assert (plan.mtiles - 1) * frb.F32_BM < M <= plan.mtiles * frb.F32_BM
        for conv, nt, gemm in zip(plan.convs, plan.ntiles, _gemms(cin, cout, proj)):
            if gemm is None:
                assert conv is None and nt == 0
                continue
            nout, k = gemm[0], -(-gemm[1] // frb.F32_BK)
            assert (nt - 1) * frb.F32_BN < nout <= nt * frb.F32_BN
            assert conv.steps == k and conv.tn in frb.F32_TN
            assert conv.stages == frb.F32_STAGES[conv.tn]
            assert conv.smem == frb.f32_smem(conv.stages) <= frb.SMEM_PER_BLOCK
            assert frb.F32_BLOCKS_PER_SM[conv.tn] * (conv.smem + frb.SMEM_RESERVED) \
                <= SMEM_PER_SM
            cuts = _slices(k, conv.splits, conv.per)
            assert cuts[0][0] == 0 and cuts[-1][1] == k and cuts[-1][1] > cuts[-1][0]
            assert all(b - a == conv.per for a, b in cuts[:-1])
            assert all(cuts[i][1] == cuts[i + 1][0] for i in range(len(cuts) - 1))
            if conv.splits > 1:
                assert conv.splits * M * nout <= _cuda.SPLITK_WORKSPACE
                assert conv.per >= frb.F32_MIN_STEPS
            tiles = plan.mtiles * nt
            if conv.tn == 8:
                s16, p16 = frb._f32_split(k, tiles, M, nout, 132 * frb.F32_BLOCKS_PER_SM[16],
                                          _cuda.SPLITK_WORKSPACE)
                assert s16 > 1 and p16 < frb.F32_MIN_PER
        assert (plan.mtiles, plan.ntiles[0], plan.convs[0]) == \
            (fwd.mtiles, fwd.ntiles, fwd.convs[0])
        assert plan.ints == tuple(v for c in plan.convs for v in (
            (0,) * 4 if c is None else (c.tn, c.stages, c.splits, c.per)))


@pytest.mark.parametrize("rs,H", [("up", 16), ("down", 16), ("none", 8), ("down", 32)])
def test_bwd_f32_gate_takes_identity_skips(rs, H):
    """An identity skip (no projection) has three GEMMs: g itself goes
    through the resample's transpose into GN1's backward."""
    plan = frb.check_resblock_shape(F32, 8, H, H, 128, 0, 128, rs, False, 32, 32,
                                    backward=True)
    assert plan.convs[3] is None and plan.ntiles[3] == 0 and plan.ints[12:] == (0,) * 4
    assert plan.mtiles == -(-8 * HO[rs](H) ** 2 // 128)


@pytest.mark.parametrize("N,H,W,c1,c2,cout,rs,proj,g1,g2", [
    (8, 12, 12, 36, 0, 20, "none", True, 9, 5),
    (3, 16, 24, 100, 28, 64, "none", True, 32, 16),
    (1, 5, 7, 12, 0, 12, "up", False, 3, 3),
    (2, 4, 4, 2048, 0, 2048, "down", False, 8, 8),
    (64, 16, 16, 256, 256, 256, "none", True, 32, 32)])
def test_bwd_f32_gate_takes_multiples_of_4(N, H, W, c1, c2, cout, rs, proj, g1, g2):
    """Channel counts that are multiples of 4 on any map, a seam at one,
    and maps beyond the cluster GroupNorm passes' scratch: a plan."""
    plan = frb.check_resblock_shape(F32, N, H, W, c1, c2, cout, rs, proj, g1, g2,
                                    backward=True)
    Ho, Wo = HO[rs](H), HO[rs](W)
    assert plan.mtiles == -(-N * Ho * Wo // 128)
    assert [c and c.steps for c in plan.convs] == [
        g and -(-g[1] // 32) for g in _gemms(c1 + c2, cout, proj)]


@pytest.mark.parametrize("c1,c2,cout", [(6, 0, 8), (8, 2, 8), (8, 0, 10), (130, 0, 128),
                                        (66, 62, 128), (126, 130, 128)])
def test_bwd_f32_gate_raises_off_multiples_of_4(c1, c2, cout):
    """Off multiples of 4, and a concat seam off one (66 | 62, 126 | 130):
    the GEMM's 16-byte copies and the GN passes' 4-wide vectors would
    straddle it."""
    with pytest.raises(ValueError, match="multiples of 4"):
        frb.check_resblock_shape(F32, 8, 16, 16, c1, c2, cout, "none", True, 2, 2,
                                 backward=True)


@pytest.mark.parametrize("cin,cout,proj", [(96, 128, True), (64, 64, False), (36, 20, True)])
def test_bwd_f32_operands_are_the_transposed_convs(cin, cout, proj):
    """w1t (cout, 9 cout) and w0t (cin, 9 cout), read as f32conv_kernel's
    (Nc, K) operand W[n, k] with k = tap * cout + o (tap 3 dy + dx), hold
    w[o, n, 2 - dy, 2 - dx] index by index, and the GEMM over a cotangent
    with them (K slices and all) is the adjoint of the forward's conv;
    wskipt (cin, cout) read as projection steps alone (Kmain = C = 0) is the
    adjoint of the 1x1 projection."""
    rng = np.random.default_rng(cin + cout)
    p = resblock_params_torch(resblock_params(rng, cin, cout, proj))
    pkb = frb.pack_resblock_bwd_params(p, F32, "cpu")
    assert pkb.w1t.shape == (cout, 9 * cout) and pkb.w0t.shape == (cin, 9 * cout)
    assert pkb.w1t.dtype == F32 and pkb.w1ts is None and pkb.w0ts is None
    for n, o, dy, dx in [(0, 0, 0, 0), (5, 7, 1, 2), (cin - 1, cout - 1, 2, 2), (9, 3, 2, 0)]:
        k = (3 * dy + dx) * cout + o
        assert pkb.w0t[n, k] == p[2][o, n, 2 - dy, 2 - dx]
        assert pkb.w1t[n % cout, k] == p[6][o, n % cout, 2 - dy, 2 - dx]
    N, H = 2, 6
    g = torch.from_numpy(normal(rng, N, H, H, cout))
    gn = g.permute(0, 3, 1, 2)
    steps = -(-9 * cout // 32)  # in two K slices
    for w, wt in ((p[2], pkb.w0t), (p[6], pkb.w1t)):
        got = emulate_f32conv(g, None, None, 0, 0, wt, 0.0, None, None, 1.0, H, H, 2,
                              -(-steps // 2))
        want = F.conv_transpose2d(gn, w, padding=1).permute(0, 2, 3, 1)
        assert_close(got, want, 1e-5, "transposed conv")
    if not proj:
        assert pkb.wskipt is None
        return
    assert pkb.wskipt.shape == (cin, cout) and torch.equal(pkb.wskipt, p[8].t())
    none = torch.zeros(N, H, H, 0)
    got = emulate_f32conv(none, g, None, cout, 0, pkb.wskipt, 0.0, None, None, frb.INV_SQRT2,
                          H, H, 1, -(-cout // 32))
    assert_close(got, g @ p[8] * frb.INV_SQRT2, 1e-6, "skip adjoint")


def _transposed(t, rs):
    """A cotangent on the resampled grid through the resample's transpose:
    1/4 of the one output pixel of a down block's 2x2 mean, the sum of the
    four copies of an up block's nearest 2x."""
    if rs == "down":
        return 0.25 * t.repeat_interleave(2, 1).repeat_interleave(2, 2)
    if rs == "up":
        N, H2, W2, C = t.shape
        return t.reshape(N, H2 // 2, 2, W2 // 2, 2, C).sum((2, 4))
    return t


def _group_stats(x, G, two_pass):
    """(mean, rstd) per (example, group) as the chain's GN passes take
    them: the recompute's two passes, or the backward's sums and squares
    (var = E[x^2] - mean^2, as JAX's kernel)."""
    N, C = x.shape[0], x.shape[-1]
    xg = x.reshape(N, -1, G, C // G)
    cnt = xg.shape[1] * xg.shape[3]
    mean = xg.sum((1, 3)) / cnt
    if two_pass:
        var = ((xg - mean[:, None, :, None]) ** 2).sum((1, 3)) / cnt
    else:
        var = (xg * xg).sum((1, 3)) / cnt - mean * mean
    return mean, torch.rsqrt(var + EPS)


def emulate_gn_silu_bwd(x, d, gamma, beta, G, stats, rs, add, add_scale):
    """rb_gn_bwd_kernel's arithmetic: xhat, y, dxhat = d^T silu'(y) gamma,
    the group means m1 of dxhat and m2 of dxhat xhat, out = rstd (dxhat -
    m1 - xhat m2); dsum the per-channel sums of out before add_scale add^T
    joins it. stats: (mean, rstd), or None for one round of its own."""
    N, H, W, C = x.shape
    mean, rstd = stats if stats is not None else _group_stats(x, G, two_pass=False)
    per_c = lambda v: v.repeat_interleave(C // G, 1)[:, None, None, :]  # noqa: E731
    xhat = (x - per_c(mean)) * per_c(rstd)
    y = xhat * gamma + beta
    sig = torch.sigmoid(y)
    dxhat = _transposed(d, rs) * (sig * (1 + y * (1 - sig))) * gamma
    gmean = lambda v: v.reshape(N, H * W, G, C // G).sum((1, 3)) / (H * W * C // G)  # noqa
    out = per_c(rstd) * (dxhat - per_c(gmean(dxhat)) - xhat * per_c(gmean(dxhat * xhat)))
    dsum = out.sum((1, 2))
    if add is not None:
        out = out + add_scale * _transposed(add, rs)
    return out, dsum


def emulate_bwd_f32_chain(x1, x2, temb, params, g, g1, g2, rs):
    """resblock_bwd_f32's seven steps: the GN1 recompute with its two-pass
    statistics, conv0's recompute, conv1^T, GN2's backward (d_c1, dtemb),
    conv0^T and the skip adjoint by emulate_f32conv on the packs' w0, w1t,
    w0t and wskipt, tiled and split by resblock_bwd_f32_plan at 132 SMs, and
    GN1's backward from the recompute's statistics, with the skip adjoint
    (or g times 1/sqrt(2), in fp32) through the resample's transpose; dx
    split at the seam."""
    x = x1 if x2 is None else torch.cat([x1, x2], -1)
    N, H, W, cin = x.shape
    c1 = x1.shape[-1]
    pk = frb.pack_resblock_params(params, F32, "cpu")
    pkb = frb.pack_resblock_bwd_params(params, F32, "cpu")
    cout = pk.cout
    plan = frb.check_resblock_shape(F32, N, H, W, c1, cin - c1, cout, rs, pk.has_proj, g1, g2,
                                    backward=True)
    Ho, Wo = g.shape[1:3]
    rsf = {"none": lambda t: t, "down": naive_downsample_2d, "up": naive_upsample_2d}[rs]
    stats = _group_stats(x, g1, two_pass=True)
    per_c = lambda v: v.repeat_interleave(cin // g1, 1)[:, None, None, :]  # noqa: E731
    act1 = rsf(F.silu((x - per_c(stats[0])) * per_c(stats[1]) * params[0] + params[1]))

    def gemm(i, act, w, bias, temb_, scale, p1=None, c_p1=0):
        cv = plan.convs[i]
        return emulate_f32conv(act, p1, None, c_p1, 0, w, bias, temb_, None, scale, Ho, Wo,
                               cv.splits, cv.per)
    h1 = gemm(0, act1, pk.w0, pk.b0, temb, 1.0)
    da2 = gemm(1, g, pkb.w1t, 0.0, None, frb.INV_SQRT2)
    dc1, dtemb = emulate_gn_silu_bwd(h1, da2, params[4], params[5], g2, None, "none", None, 0.0)
    dh = gemm(2, dc1, pkb.w0t, 0.0, None, 1.0)
    if pk.has_proj:
        add, scale = gemm(3, torch.zeros(N, Ho, Wo, 0), pkb.wskipt, 0.0, None, frb.INV_SQRT2,
                          p1=g, c_p1=cout), 1.0
    else:
        add, scale = g, frb.INV_SQRT2
    dx, _ = emulate_gn_silu_bwd(x, dh, params[0], params[1], g1, stats, rs, add, scale)
    return dx[..., :c1], dx[..., c1:], dtemb


@functools.lru_cache(maxsize=None)
def _jax_bwd(cat, g1, g2, rs):
    if cat:
        return jax.jit(functools.partial(fused_resblock_cat_bwd_pallas, num_groups1=g1,
                                         num_groups2=g2, interpret=True))
    return jax.jit(functools.partial(fused_resblock_bwd_pallas, num_groups1=g1,
                                     num_groups2=g2, resample=rs, interpret=True))


# (resample, H, cin, cout, projection, batch): every resample with and
# without a projection (the identity skips of up and down blocks, which no
# census shape has), split K (small maps), channels off 32
BLOCKS = [("none", 8, 32, 64, True, 2), ("down", 8, 64, 64, False, 3),
          ("up", 4, 96, 64, True, 2), ("none", 6, 36, 36, False, 2),
          ("up", 4, 32, 32, False, 1), ("down", 8, 32, 64, True, 2)]


@pytest.mark.parametrize("rs,H,cin,cout,proj,N", BLOCKS)
def test_bwd_f32_chain_matches_the_pallas_kernel(rs, H, cin, cout, proj, N):
    rng = np.random.default_rng(7 * cin + cout + H)
    x = normal(rng, N, H, H, cin)
    temb = normal(rng, N, cout, scale=0.3)
    g = normal(rng, N, HO[rs](H), HO[rs](H), cout)
    p = resblock_params(rng, cin, cout, proj)
    g1, g2 = ncsn_num_groups(cin), ncsn_num_groups(cout)
    want_dx, want_dt = _jax_bwd(False, g1, g2, rs)(
        to_jax(x), to_jax(temb), tuple(to_jax(a) for a in p), to_jax(g))
    dx, _, dt = emulate_bwd_f32_chain(to_torch(x), None, to_torch(temb),
                                      resblock_params_torch(p), to_torch(g), g1, g2, rs)
    assert_close(dx, want_dx, REL["float32"], f"dx {rs} {cin}->{cout}")
    assert_close(dt, want_dt, REL["float32"], f"dtemb {rs} {cin}->{cout}")


# (c1, c2, cout, H, N): the seam at a group edge and inside a group, and a
# 4-channel-aligned seam off 8
CATS = [(64, 32, 64, 8, 2), (64, 96, 96, 4, 2), (36, 28, 32, 6, 1)]


@pytest.mark.parametrize("c1,c2,cout,H,N", CATS)
def test_bwd_f32_seam_matches_the_pallas_kernel(c1, c2, cout, H, N):
    rng = np.random.default_rng(c1 + 3 * c2 + H)
    x1, x2 = normal(rng, N, H, H, c1), normal(rng, N, H, H, c2, scale=2.0)
    temb = normal(rng, N, cout, scale=0.3)
    g = normal(rng, N, H, H, cout)
    p = resblock_params(rng, c1 + c2, cout)
    g1, g2 = ncsn_num_groups(c1 + c2), ncsn_num_groups(cout)
    want = _jax_bwd(True, g1, g2, "none")(to_jax(x1), to_jax(x2), to_jax(temb),
                                          tuple(to_jax(a) for a in p), to_jax(g))
    got = emulate_bwd_f32_chain(to_torch(x1), to_torch(x2), to_torch(temb),
                                resblock_params_torch(p), to_torch(g), g1, g2, "none")
    for name, a, b in zip(("dx1", "dx2", "dtemb"), got, want):
        assert_close(a, b, REL["float32"], f"cat {c1}|{c2}->{cout} {name}")
