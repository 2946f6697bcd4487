"""The port's halo GN+SiLU+conv3x3 (+skip) against
diffpure_tpu/ops/halo_conv.py, its Pallas kernel in interpret mode, on the
same seeded inputs and weights, fp32 and bf16. The JAX kernel's row tile is
pinned to 4 rows so that it streams several tiles with their halos."""
import numpy as np
import pytest
import torch

from diffpure_tpu.ops import halo_conv as jhc
from diffpure_tpu_torch.ops import halo_conv as hc
from torch_parity import DTYPES, REL, assert_close, normal, to_jax, to_torch

N, H, W = 2, 16, 8


@pytest.fixture
def four_row_tiles(monkeypatch):
    monkeypatch.setattr(jhc, "_pick_tile_halo", lambda *a, **k: 4)


def _stage(seed, cin, cout, skip):
    rng = np.random.default_rng(seed)
    cr = cin if skip == "proj" else cout
    return dict(x=normal(rng, N, H, W, cin), A=normal(rng, N, cin, scale=0.3, shift=1.0),
                B=normal(rng, N, cin, scale=0.3), w=normal(rng, 3, 3, cin, cout, fan_in=9 * cin),
                b=normal(rng, cout, scale=0.1),
                skip=normal(rng, N, H, W, cr) if skip != "none" else None,
                w_proj=normal(rng, cr, cout, fan_in=cr) if skip == "proj" else None)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("skip", ["none", "identity", "proj"])
def test_halo_conv_matches_jax_kernel(four_row_tiles, dtype, skip):
    jdt, tdt = DTYPES[dtype]
    cin, cout = (48, 32) if skip == "proj" else (32, 32)
    a = _stage(0, cin, cout, skip)
    want = jhc.gn_silu_conv3x3_halo_pallas(
        to_jax(a["x"], jdt), to_jax(a["A"]), to_jax(a["B"]), to_jax(a["w"]), to_jax(a["b"]),
        skip=to_jax(a["skip"], jdt), w_proj=to_jax(a["w_proj"]), interpret=True)
    got = hc.gn_silu_conv3x3_halo(
        to_torch(a["x"], tdt), to_torch(a["A"]), to_torch(a["B"]), to_torch(a["w"]),
        to_torch(a["b"]), skip=to_torch(a["skip"], tdt), w_proj=to_torch(a["w_proj"]))
    assert got.dtype == tdt and got.shape == (N, H, W, cout)
    assert_close(got, want, REL[dtype], f"halo conv skip={skip} {dtype}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stage", ["first", "second", "pre_shift"])
def test_gn_silu_conv_block_matches_jax(four_row_tiles, dtype, stage):
    """ADM's first stage (no FiLM, no skip), its second (FiLM, projected
    skip) and the DDPM form (pre-GN shift, identity skip)."""
    jdt, tdt = DTYPES[dtype]
    cin, cout = 32, (64 if stage == "second" else 32)
    rng = np.random.default_rng(1)
    x = normal(rng, N, H, W, cin, shift=0.2)
    gs, gb = normal(rng, cin, scale=0.1, shift=1.0), normal(rng, cin, scale=0.1)
    w, b = normal(rng, 3, 3, cin, cout, fan_in=9 * cin), normal(rng, cout, scale=0.1)
    fs = ft = skip = wp = pre = None
    if stage == "second":
        fs, ft = normal(rng, N, cin, scale=0.1), normal(rng, N, cin, scale=0.1)
        skip, wp = normal(rng, N, H, W, cin), normal(rng, cin, cout, fan_in=cin)
    elif stage == "pre_shift":
        pre, skip = normal(rng, N, cin, scale=0.5), normal(rng, N, H, W, cout)
    args = (gs, gb, fs, ft, w, b)
    want = jhc.gn_silu_conv_block(to_jax(x, jdt), *map(to_jax, args), to_jax(skip, jdt),
                                  to_jax(wp), to_jax(pre), 32, 1e-5, True)
    got = hc.gn_silu_conv_block(to_torch(x, tdt), *map(to_torch, args),
                                to_torch(skip, tdt), to_torch(wp), to_torch(pre), 32, 1e-5)
    assert_close(got, want, REL[dtype], f"block {stage} {dtype}")
    want_ref = jhc.gn_conv_block_reference(to_jax(x, jdt), *map(to_jax, args), to_jax(skip, jdt),
                                           to_jax(wp), 32, 1e-5, pre_shift=to_jax(pre))
    got_ref = hc.gn_conv_block_reference(to_torch(x, tdt), *map(to_torch, args),
                                         to_torch(skip, tdt), to_torch(wp), 32, 1e-5,
                                         pre_shift=to_torch(pre))
    assert_close(got_ref, want_ref, REL[dtype], f"block reference {stage} {dtype}")


def packed_index(cin, tap, c, n, proj=False):
    """(step, n, position) where the bf16 kernel reads w[tap, c, n] (with
    ``proj``, w_proj[c, n]): conv step (c // 64) * 9 + tap, the
    projection's steps after the conv's, 16-byte group c // 8 of row n at
    (c // 8) ^ (n % 8) (wgmma's 128-byte swizzle)."""
    step = 9 * (cin // 64) + c // 64 if proj else (c // 64) * 9 + tap
    return step, n, ((c % 64 // 8) ^ (n % 8)) * 8 + c % 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_weight_layouts(dtype):
    """The kernel's weight layouts hold w[tap, c, n] and w_proj[c, n] where
    it reads them. bf16: step (c // 64) * 9 + tap (the projection's steps
    after the conv's), row n, the 16-byte group of c swizzled by n % 8 (the
    128-byte swizzle of wgmma's operand); fp32: row (tap, c) = [n]."""
    cin, cout, cr = 128, 256, 192
    w, wp = torch.randn(3, 3, cin, cout), torch.randn(cr, cout)
    pk = hc.pack_halo_weights(w, wp, dtype, "cpu")
    assert pk.w.is_contiguous() and pk.w.dtype == dtype
    w9 = w.to(dtype).reshape(9, cin, cout)
    wpd = wp.to(dtype)
    picks = [(0, 0, 0), (4, 5, 17), (8, 127, 255), (3, 70, 40), (5, 64, 9), (7, 99, 200)]
    if dtype == torch.bfloat16:
        assert pk.w.shape == (9 * cin // 64 + cr // 64, cout, 64)
        assert pk.w_proj.shape == (cr // 64, cout, 64)
        for tap, c, n in picks:
            assert pk.w[packed_index(cin, tap, c, n)] == w9[tap, c, n]
            cp = c % cr
            assert pk.w[packed_index(cin, 4, cp, n, proj=True)] == wpd[cp, n]
            s, _, pos = packed_index(cin, 4, cp, n, proj=True)
            assert pk.w_proj[s - 9 * cin // 64, n, pos] == wpd[cp, n]
        # every element once: the pack is a permutation of the weights
        flat = torch.cat([w9.reshape(-1), wpd.reshape(-1)]).float()
        assert torch.equal(pk.w.float().reshape(-1).sort().values, flat.sort().values)
    else:
        for tap, c, n in picks:
            assert pk.w[tap * cin + c, n] == w9[tap, c, n]
            assert pk.w_proj[c % cr, n] == wp[c % cr, n]
    assert hc.pack_halo_weights(w, None, dtype, "cpu").w_proj is None


def test_bf16_pack_rows_are_swizzled_per_group_of_eight():
    """Within a step, 16-byte group g of row n sits at g ^ (n % 8): rows n
    and n + 8 share a pattern, so an N tile starting at a multiple of 8
    lands in the swizzle its shared-memory offset implies."""
    wk = hc._swizzle128(torch.arange(2 * 16 * 64).reshape(2, 16, 64))
    for n in range(16):
        groups = wk[1, n].reshape(8, 8)[:, 0] % 64 // 8
        assert groups.tolist() == [g ^ (n % 8) for g in range(8)]


# The ADM census of the ImageNet-256 path (chip_smoke.py phase 2c, batch 4):
# (H, cin, cout, skip, cr).
ADM_CENSUS = [
    (256, 256, 256, "none", 0), (256, 256, 256, "identity", 256), (256, 256, 256, "proj", 512),
    (256, 512, 256, "none", 0),
    (128, 256, 256, "none", 0), (128, 256, 256, "identity", 256), (128, 256, 256, "proj", 512),
    (128, 256, 256, "proj", 768), (128, 512, 256, "none", 0), (128, 768, 256, "none", 0),
    (64, 256, 512, "none", 0), (64, 512, 512, "none", 0), (64, 512, 512, "identity", 512),
    (64, 512, 512, "proj", 256), (64, 512, 512, "proj", 768), (64, 512, 512, "proj", 1024),
    (64, 768, 512, "none", 0), (64, 1024, 512, "none", 0),
    (32, 512, 512, "none", 0), (32, 512, 512, "identity", 512), (32, 512, 512, "proj", 1024),
    (32, 512, 512, "proj", 1536), (32, 1024, 512, "none", 0), (32, 1536, 512, "none", 0),
]


@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("H,cin,cout,skip,cr", ADM_CENSUS)
def test_halo_plan_fills_the_card(batch, H, cin, cout, skip, cr):
    """Every census shape gets a tile the kernel has, and at least 132
    tiles (the persistent grid fills the 132 SMs) or a stated reason: one
    wave of at least 90% of the SMs, or a map too small for more tiles."""
    plan = hc.check_halo_shape(torch.bfloat16, (batch, H, H, cin), (3, 3, cin, cout),
                               cr, skip == "proj")
    assert (plan.rows, plan.bn) in hc.TILES
    assert H % plan.rows == 0 and cout % plan.bn == 0
    assert plan.tiles == batch * (H // plan.rows) * (H // 32) * (cout // plan.bn)
    if plan.tiles < 132:
        assert plan.reason and str(batch * H * H) in plan.reason
        # one wave of >= 90% of the SMs, or no tile of TILES gives more tiles
        assert plan.tiles >= 0.9 * 132 or all(
            batch * (H // r) * (H // 32) * (cout // bn) <= plan.tiles
            for r, bn in hc.TILES if H % r == 0 and cout % bn == 0)
    else:
        assert not plan.reason


@pytest.mark.parametrize("dtype,x_shape,w_shape,cr,proj,match", [
    (torch.bfloat16, (4, 64, 48, 256), (3, 3, 256, 256), 0, False, "W % 32"),
    (torch.bfloat16, (4, 64, 64, 96), (3, 3, 96, 256), 0, False, "cin, cr % 64"),
    (torch.bfloat16, (4, 64, 64, 256), (3, 3, 256, 256), 96, True, "cin, cr % 64"),
    (torch.bfloat16, (4, 64, 64, 256), (3, 3, 256, 192), 0, False, "cout % 128"),
    (torch.bfloat16, (4, 63, 64, 256), (3, 3, 256, 256), 0, False, "H % 2"),
    (torch.bfloat16, (4, 64, 64, 256), (3, 3, 128, 256), 0, False, "kernel"),
    (torch.bfloat16, (4, 64, 64, 256), (3, 3, 256, 256), 128, False, "identity skip"),
    (torch.bfloat16, (4, 64, 64, 256), (3, 3, 256, 256), 0, True, "needs a skip"),
    (torch.float32, (4, 62, 64, 256), (3, 3, 256, 256), 0, False, "H % 4"),
    (torch.float32, (4, 64, 64, 48), (3, 3, 48, 256), 0, False, "cin and"),
    (torch.float16, (4, 64, 64, 256), (3, 3, 256, 256), 0, False, "fp32 or bf16"),
])
def test_halo_shape_gate_raises(dtype, x_shape, w_shape, cr, proj, match):
    with pytest.raises(ValueError, match=match):
        hc.check_halo_shape(dtype, x_shape, w_shape, cr, proj)


def test_halo_shape_gate_takes_the_fp32_census():
    for H, cin, cout, skip, cr in ADM_CENSUS:
        assert hc.check_halo_shape(torch.float32, (1, H, H, cin), (3, 3, cin, cout), cr,
                                   skip == "proj") is None


def test_halo_conv_has_no_fallback_off_the_cpu():
    x = torch.empty(1, 4, 32, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        hc.gn_silu_conv3x3_halo(x, x[:, 0, 0], x[:, 0, 0], torch.empty(3, 3, 32, 64),
                                torch.empty(64))
