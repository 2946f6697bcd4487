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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_weight_layouts(dtype):
    """The kernel's weight layouts index (tap, c, n) of the HWIO kernel:
    bf16 row n = [tap][c], fp32 row (tap, c) = [n]; the projection likewise."""
    cin, cout, cr = 32, 64, 48
    w, wp = torch.randn(3, 3, cin, cout), torch.randn(cr, cout)
    pk = hc.pack_halo_weights(w, wp, dtype, "cpu")
    assert pk.w.is_contiguous() and pk.w.dtype == dtype
    w9 = w.to(dtype).reshape(9, cin, cout)
    for tap, c, n in ((0, 0, 0), (4, 5, 17), (8, 31, 63), (3, 12, 40)):
        if dtype == torch.bfloat16:
            assert pk.w[n, tap * cin + c] == w9[tap, c, n]
            assert pk.w_proj[n, c] == wp.to(dtype)[c, n]
        else:
            assert pk.w[tap * cin + c, n] == w9[tap, c, n]
            assert pk.w_proj[c, n] == wp[c, n]
    assert hc.pack_halo_weights(w, None, dtype, "cpu").w_proj is None


def test_halo_conv_has_no_fallback_off_the_cpu():
    x = torch.empty(1, 4, 32, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        hc.gn_silu_conv3x3_halo(x, x[:, 0, 0], x[:, 0, 0], torch.empty(3, 3, 32, 64),
                                torch.empty(64))
