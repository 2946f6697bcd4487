"""The port's tiled GroupNorm (stats pass + combine, FiLM + SiLU apply)
against diffpure_tpu/ops/tiled_groupnorm.py, whose Pallas kernels run in
interpret mode, on the same seeded inputs, fp32 and bf16."""
import numpy as np
import pytest
import torch

from diffpure_tpu.ops import tiled_groupnorm as jtgn
from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops import tiled_groupnorm as tgn
from torch_parity import DTYPES, REL, assert_close, normal, to_jax, to_torch

N, H, W, C, G = 2, 8, 8, 64, 32


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(x=normal(rng, N, H, W, C, shift=0.3), scale=normal(rng, C, scale=0.1, shift=1.0),
                bias=normal(rng, C, scale=0.1), fs=normal(rng, N, C, scale=0.1),
                ft=normal(rng, N, C, scale=0.1), pre=normal(rng, N, C, scale=0.5))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["plain", "film", "pre_shift"])
def test_group_stats_affine_matches_jax(dtype, variant):
    jdt, tdt = DTYPES[dtype]
    a = _inputs(0)
    film = variant == "film"
    pre = a["pre"] if variant == "pre_shift" else None
    want = jtgn.group_stats_affine(
        to_jax(a["x"], jdt), to_jax(a["scale"]), to_jax(a["bias"]), G, 1e-5,
        to_jax(a["fs"]) if film else None, to_jax(a["ft"]) if film else None,
        interpret=True, pre_shift=to_jax(pre))
    for fn in (tgn.group_stats_affine, tgn.group_stats_affine_reference):
        got = fn(to_torch(a["x"], tdt), to_torch(a["scale"]), to_torch(a["bias"]), G, 1e-5,
                 to_torch(a["fs"]) if film else None, to_torch(a["ft"]) if film else None,
                 pre_shift=to_torch(pre))
        for g, w, name in zip(got, want, "AB"):
            assert g.dtype == torch.float32 and g.shape == (N, C)
            # both sides sum the same (rounded) inputs in fp32
            assert_close(g, w, 1e-5, f"{fn.__name__} {name} {variant} {dtype}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_film_silu_matches_jax(dtype, film, silu):
    jdt, tdt = DTYPES[dtype]
    a = _inputs(1)
    fs, ft = (a["fs"], a["ft"]) if film else (None, None)
    want = jtgn.group_norm_film_silu_tiled(
        to_jax(a["x"], jdt), to_jax(a["scale"]), to_jax(a["bias"]), G, 1e-5, to_jax(fs),
        to_jax(ft), apply_silu=silu, interpret=True)
    got = tgn.group_norm_film_silu(
        to_torch(a["x"], tdt), to_torch(a["scale"]), to_torch(a["bias"]), G, 1e-5,
        to_torch(fs), to_torch(ft), silu)
    assert got.dtype == tdt
    assert_close(got, want, REL[dtype], f"tiled GN film={film} silu={silu} {dtype}")
    want_ref = jtgn.group_norm_film_silu_reference(
        to_jax(a["x"], jdt), to_jax(a["scale"]), to_jax(a["bias"]), G, 1e-5, to_jax(fs),
        to_jax(ft), apply_silu=silu)
    got_ref = tgn.group_norm_film_silu_reference(
        to_torch(a["x"], tdt), to_torch(a["scale"]), to_torch(a["bias"]), G, 1e-5,
        to_torch(fs), to_torch(ft), silu)
    assert_close(got_ref, want_ref, REL[dtype], f"reference film={film} silu={silu} {dtype}")


def test_group_stats_partials_and_apply_pieces():
    """The stats kernel's plain version sums per example into one tile; the
    wrapper's tiling keeps ~1024 blocks and covers every row."""
    x = torch.randn(2, 6, 4, 8)
    s, q = tgn.group_stats(x)
    assert s.shape == q.shape == (2, 1, 8)
    torch.testing.assert_close(s[:, 0], x.sum(dim=(1, 2)))
    for n, h, c in ((4, 256, 256), (4, 32, 1536), (1, 32, 512), (1, 7, 8)):
        rows = tgn._rows_per_tile(n, h, c)
        tiles = -(-h // rows)
        assert 1 <= rows <= h and (tiles - 1) * rows < h
    A, B = torch.randn(2, 8), torch.randn(2, 8)
    out = tgn.gn_film_silu_apply(x, A, B, apply_silu=False)
    torch.testing.assert_close(out, x * A[:, None, None] + B[:, None, None])


def test_wrappers_take_cpu_or_cuda_only_and_refuse_card_gradients():
    x = torch.empty(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgn.group_stats(x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgn.gn_film_silu_apply(x, x[:, 0, 0], x[:, 0, 0])
    # no wrapper refuses a gradient any more (#11, the last forward-only
    # kernel, has its closed-form backward): the apply pass differentiates
    # in x, A and B through its Function
    assert not hasattr(_cuda, "refuse_card_grad")
    xs = torch.randn(1, 2, 2, 8, requires_grad=True)
    A = torch.randn(1, 8, requires_grad=True)
    B = torch.randn(1, 8, requires_grad=True)
    tgn.gn_film_silu_apply(xs, A, B).sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in (xs, A, B))
