"""The plain parts of the bf16 fused-resblock backward on wgmma
(csrc/fused_resblock_bwd.cu on csrc/igemm_wgmma.cuh and csrc/gn_cluster.cuh):
its transposed weight stages against the flipped OIHW weights and against
JAX's _flip_transpose_w9, its plan of four GEMMs over the full-width CIFAR
NCSN++'s block census, its shape gate, and that its wrappers have no route
off the CPU but the kernel. The kernel runs only on the card (chip_smoke.py
phase 2b holds it against the plain version at batch 8 and 16); the plain
version's parity with diffpure_tpu is tests/test_torch_fused_resblock_bwd.py's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.ops.fused_resblock import _flip_transpose_w9
from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops import fused_resblock as frb
from test_torch_resblock_wgmma import census, stage_index  # noqa: F401 (a fixture)
from torch_parity import resblock_params, resblock_params_torch

BF = torch.bfloat16


def _stages_from(wt: np.ndarray) -> np.ndarray:
    """The stage pack a (taps, ci, co) conv stack (tap, input channel,
    output channel) must give: wt[k, i, o] at step (i // 64) * taps + k,
    row o, the 16-byte group of i swizzled by o % 8."""
    taps, ci, co = wt.shape
    out = np.zeros((taps * ci // 64, co, 64), wt.dtype)
    k, i, o = np.meshgrid(np.arange(taps), np.arange(ci), np.arange(co), indexing="ij")
    out[(i // 64) * taps + k, o, ((i % 64 // 8) ^ (o % 8)) * 8 + i % 8] = wt
    return out


@pytest.mark.parametrize("cin,cout,proj", [(128, 128, False), (192, 128, True),
                                           (128, 256, True)])
def test_transposed_stages_hold_the_flipped_weights(cin, cout, proj):
    """w1ts / w0ts hold the transposed convs' weights w[o, c, 2 - dy, 2 - dx]
    at step (o // 64) * 9 + 3 dy + dx, row c (o: the transposed conv's input
    channel, an output channel of the forward's); wskipts holds wskip[o, c]
    at step o // 64, row c; every row is swizzled. Index by index against the
    OIHW weights, and whole against JAX's _flip_transpose_w9 of the same
    numpy-seeded weights."""
    rng = np.random.default_rng(11)
    pj = resblock_params(rng, cin, cout, proj)
    p = resblock_params_torch(pj)
    pkb = frb.pack_resblock_bwd_params(p, BF, "cpu")
    w0, w1 = p[2].to(BF), p[6].to(BF)
    assert pkb.w1ts.shape == (9 * cout // 64, cout, 64) and pkb.w1ts.dtype == BF
    assert pkb.w0ts.shape == (9 * cout // 64, cin, 64) and pkb.w0ts.is_contiguous()
    for o, c, dy, dx in [(0, 0, 0, 0), (5, 70, 1, 2), (127, 127, 2, 2), (64, 9, 2, 0),
                         (100, 63, 0, 1), (33, 64, 1, 1)]:
        tap = 3 * dy + dx
        assert pkb.w1ts[stage_index(cout, tap, o, c)] == w1[o, c, 2 - dy, 2 - dx]
        assert pkb.w0ts[stage_index(cout, tap, o, c % cin)] == w0[o, c % cin, 2 - dy, 2 - dx]
    for w, stages in ((pj[6], pkb.w1ts), (pj[2], pkb.w0ts)):
        wt = np.asarray(_flip_transpose_w9(jnp.asarray(w).reshape(9, *w.shape[2:])))
        want = _stages_from(wt.astype(np.float32))  # (tap, its input o, its output c)
        assert np.array_equal(stages.float().numpy(),
                              torch.from_numpy(want).to(BF).float().numpy())
    if not proj:
        assert pkb.wskipts is None
        return
    ws = p[8].to(BF)
    assert pkb.wskipts.shape == (cout // 64, cin, 64) and pkb.wskipts.is_contiguous()
    for o, c in [(0, 0), (5, 70), (127, 127), (64, 9), (100, cin - 1)]:
        assert pkb.wskipts[o // 64, c, ((o % 64 // 8) ^ (c % 8)) * 8 + o % 8] == ws[o, c]
    want = _stages_from(pj[8].T[None])  # one "tap": input channel o, output channel c
    assert np.array_equal(pkb.wskipts.float().numpy(),
                          torch.from_numpy(want).to(BF).float().numpy())


def test_bwd_pack_keeps_the_fp32_layout_and_caches_pointers():
    """The fp32 chain's matrices stay; the fp32 pack and channel counts the
    bf16 kernel does not take get no stages (its gate raises); the cached
    pointers are the tensors'."""
    rng = np.random.default_rng(12)
    p = resblock_params_torch(resblock_params(rng, 64, 128))
    for dtype in (BF, torch.float32):
        pkb = frb.pack_resblock_bwd_params(p, dtype, "cpu")
        assert pkb.w1t.shape == (128, 9 * 128) and pkb.w0t.shape == (64, 9 * 128)
        assert pkb.wskipt.shape == (64, 128)
        assert (pkb.w1ts is None) == (dtype == torch.float32)
        assert pkb.ptrs[:3] == (pkb.w1t.data_ptr(), pkb.w0t.data_ptr(), pkb.wskipt.data_ptr())
        assert pkb.ptrs[3] == (0 if pkb.w1ts is None else pkb.w1ts.data_ptr())
        assert pkb.ptrs[5] == (0 if pkb.wskipts is None else pkb.wskipts.data_ptr())
    small = frb.pack_resblock_bwd_params(resblock_params_torch(resblock_params(rng, 32, 32, False)),
                                         BF, "cpu")
    assert small.w1ts is None and small.w0ts is None and small.ptrs[3:] == (0, 0, 0)


def _slices(steps, splits, per):
    return [(z * per, min(steps, (z + 1) * per)) for z in range(splits)]


@pytest.mark.parametrize("batch", [2, 8, 16])
def test_resblock_bwd_plan_covers_the_census(census, batch):  # noqa: F811
    """At every census shape, for each of the four GEMMs (conv0's
    recompute, conv1^T, conv0^T, the skip adjoint): a tile the kernel has
    whose width divides the GEMM's output (cout, cout, cin, cin: up to 512
    at the concat blocks, 384 across the seam); M tiles that cover the N Ho
    Wo rows once as TMA boxes of whole rows of one image or whole images;
    K slices (9 cin / 64, 9 cout / 64, 9 cout / 64, cout / 64 steps) that
    cover the steps in order; partials that fit the workspace; conv0's
    recompute planned as the forward's conv0; and the 24 ints the C side
    reads."""
    for (name, rs, H, c1, c2, cout), _ in sorted(census.items()):
        cin = c1 + c2
        proj = name == "fused_resblock_cat" or rs != "none" or cin != cout
        plan = frb.check_resblock_shape(BF, batch, H, H, c1, c2, cout, rs, proj, 32, 32,
                                        backward=True)
        fwd = frb.check_resblock_shape(BF, batch, H, H, c1, c2, cout, rs, proj, 32, 32)
        Ho = {"none": H, "down": H // 2, "up": 2 * H}[rs]
        hw, M = Ho * Ho, batch * Ho * Ho
        want = ((cout, 9 * cin // 64), (cout, 9 * cout // 64), (cin, 9 * cout // 64),
                (cin, cout // 64) if proj else None)
        assert len(plan.gemms) == 4 and (plan.gemms[3] is None) == (not proj)
        for gp, w in zip(plan.gemms, want):
            if w is None:
                continue
            assert (gp.nout, gp.steps) == w
            assert (gp.bm, gp.bn) in frb.RB_TILES and gp.nout % gp.bn == 0
            bw, bh, bimg = gp.box
            assert bw == Ho and bw * bh * bimg == gp.bm and max(gp.box) <= 256
            assert gp.mtiles == -(-M // gp.bm) and gp.ntiles == gp.nout // gp.bn
            rows = set()
            for t in range(gp.mtiles):
                m0 = t * gp.bm
                if bimg > 1:
                    assert bh == Ho and m0 % hw == 0
                else:
                    assert m0 % hw + gp.bm <= hw and (m0 % hw) % Ho == 0
                rows.update(range(m0, min(M, m0 + gp.bm)))
            assert rows == set(range(M))
            cuts = _slices(gp.steps, gp.splits, gp.per)
            assert cuts[0][0] == 0 and cuts[-1][1] == gp.steps
            assert all(a < b for a, b in cuts) and all(
                cuts[i][1] == cuts[i + 1][0] for i in range(len(cuts) - 1))
            if gp.splits > 1:
                assert gp.splits * M * gp.nout <= _cuda.SPLITK_WORKSPACE
                assert gp.mtiles * gp.ntiles * gp.splits <= 132
        g0 = plan.gemms[0]
        assert (g0.bm, g0.bn, g0.box, g0.splits, g0.per) == \
            (fwd.bm, fwd.bn, fwd.box, fwd.splits[0], fwd.per[0])
        ints = [v for gp in plan.gemms for v in
                ((0,) * 6 if gp is None else (gp.bm, gp.bn, gp.box[1], gp.box[2], gp.splits,
                                              gp.per))]
        assert plan.ints == tuple(ints)


@pytest.mark.parametrize("c1,c2,cout", [(96, 0, 128), (128, 32, 128), (128, 0, 96),
                                        (128, 0, 200)])
def test_bwd_gate_raises_off_multiples_of_64(c1, c2, cout):
    with pytest.raises(ValueError, match="multiples of 64"):
        frb.check_resblock_shape(BF, 8, 16, 16, c1, c2, cout, "none", True, 8, 8,
                                 backward=True)


@pytest.mark.parametrize("H,W,rs", [(12, 12, "none"), (6, 6, "none"), (16, 24, "none"),
                                    (12, 12, "down"), (6, 6, "up")])
def test_bwd_gate_raises_where_no_box_tiles_the_map(H, W, rs):
    with pytest.raises(ValueError, match="boxes do not tile"):
        frb.check_resblock_shape(BF, 8, H, W, 128, 0, 128, rs, rs != "none", 32, 32,
                                 backward=True)


@pytest.mark.parametrize("c1,c2,cout,g1,g2", [(1088, 0, 128, 32, 32), (256, 0, 256, 128, 32),
                                              (128, 0, 192, 32, 40)])
def test_bwd_gate_raises_past_the_gn_pass(c1, c2, cout, g1, g2):
    with pytest.raises(ValueError, match="GroupNorm pass"):
        frb.check_resblock_shape(BF, 8, 16, 16, c1, c2, cout, "none", True, g1, g2,
                                 backward=True)


@pytest.mark.parametrize("rs,H", [("up", 16), ("down", 16), ("up", 4), ("down", 32)])
def test_bwd_gate_takes_identity_skip_resampling(rs, H):
    """An up or down block with an identity skip has three GEMMs (no skip
    adjoint: g itself goes through the resample's transpose), on the
    output grid."""
    Ho = {"up": 2 * H, "down": H // 2}[rs]
    plan = frb.check_resblock_shape(BF, 8, H, H, 128, 0, 128, rs, False, 32, 32,
                                    backward=True)
    assert plan.gemms[3] is None and plan.ints[18:] == (0,) * 6
    assert all(gp.box[0] == Ho and gp.mtiles * gp.bm >= 8 * Ho * Ho for gp in plan.gemms[:3])


def test_bwd_gate_leaves_fp32_alone(census):  # noqa: F811
    """The fp32 backward gets the fp32 chain's plan (resblock_bwd_f32_plan,
    tests/test_torch_resblock_bwd_f32.py), never the bf16 GEMM's."""
    for (name, rs, H, c1, c2, cout), _ in census.items():
        plan = frb.check_resblock_shape(torch.float32, 8, H, H, c1, c2, cout, rs, True, 32, 32,
                                        backward=True)
        Ho = {"none": H, "down": H // 2, "up": 2 * H}[rs]
        assert isinstance(plan, frb.ResblockBwdF32Plan)
        assert plan == frb.resblock_bwd_f32_plan(8, Ho, Ho, c1 + c2, cout, True)


def test_resblock_bwd_has_no_route_off_the_cpu_but_the_kernel():
    """A tensor on neither the CPU nor a card is refused before any launch,
    for both backward forms; no other device reaches the plain version."""
    rng = np.random.default_rng(13)
    p = resblock_params_torch(resblock_params(rng, 64, 64))
    x = torch.empty(1, 4, 4, 64, device="meta", dtype=BF)
    launches = frb.fused_resblock_bwd.launches, frb.fused_resblock_cat_bwd.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        frb.fused_resblock_bwd(x, torch.zeros(1, 64), p, x, num_groups1=16, num_groups2=16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        frb.fused_resblock_cat_bwd(x[..., :32], x[..., 32:], torch.zeros(1, 64), p, x,
                                   num_groups1=16, num_groups2=16)
    assert (frb.fused_resblock_bwd.launches, frb.fused_resblock_cat_bwd.launches) == launches
