"""GroupNorm + SiLU, kernel #10's plain version and CPU wrapper, against
diffpure_tpu's group_norm_silu_pallas (interpret mode) and group_norm_silu.

fp32: 1e-5 of max |ref| (the variance is two-pass here, one-pass in the
Pallas kernel). bf16: 1e-2 (tests/torch_parity.py REL).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.models.layers import GNSiLU as JaxGNSiLU
from diffpure_tpu.ops import groupnorm as jgn
from diffpure_tpu_torch.models.layers import GNSiLU
from diffpure_tpu_torch.ops import groupnorm, launch_counts
from torch_parity import DTYPES, REL, assert_close, ddpm_census, normal, to_jax, to_torch

FP32_OP = 1e-5
TOL = {"float32": FP32_OP, "bfloat16": REL["bfloat16"]}

# (N, H, W, C, groups): 4 channels per group, the 12 of 384/32 (the widest
# slice of the score DDPM), 3 (no vector loads), 8 on a non-square map
SHAPES = [(2, 8, 8, 32, 8), (1, 4, 4, 384, 32), (2, 4, 4, 24, 8), (2, 6, 5, 16, 2)]


def _inputs(shape, seed=0):
    N, H, W, C, G = shape
    rng = np.random.default_rng(seed + C)
    x = normal(rng, N, H, W, C, scale=2.0, shift=0.5)
    return x, normal(rng, C, scale=0.1, shift=1.0), normal(rng, C, scale=0.1), G


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_matches_pallas(shape, eps, dtype):
    jdt, tdt = DTYPES[dtype]
    x, s, b, G = _inputs(shape)
    want = jgn.group_norm_silu_pallas(to_jax(x, jdt), to_jax(s), to_jax(b), G, eps,
                                      interpret=True)
    xt, st, bt = to_torch(x, tdt), to_torch(s), to_torch(b)
    ref = groupnorm.group_norm_silu_fused_reference(xt, st, bt, G, eps)
    assert ref.dtype == tdt
    assert_close(ref, want, TOL[dtype], "group_norm_silu_fused_reference")
    # on a CPU tensor the wrapper is the plain version, and launches nothing
    before = launch_counts()["group_norm_silu_fused"]
    got = groupnorm.group_norm_silu_fused(xt, st, bt, G, eps)
    assert torch.equal(got, ref)
    assert launch_counts()["group_norm_silu_fused"] == before


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_matches_the_plain_chain(dtype):
    """The Pallas function and the plain chain are one function, up to the
    bf16 rounding before the SiLU."""
    jdt, tdt = DTYPES[dtype]
    x, s, b, G = _inputs(SHAPES[0], seed=5)
    want = jgn.group_norm_silu(to_jax(x, jdt), to_jax(s), to_jax(b), G)
    got = groupnorm.group_norm_silu_fused(to_torch(x, tdt), to_torch(s), to_torch(b), G)
    assert_close(got, want, REL[dtype], "fused against the plain chain")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gnsilu_module_matches_jax(dtype):
    """GNSiLU on a CPU tensor takes JAX's default (plain) path."""
    jdt, tdt = DTYPES[dtype]
    x, s, b, G = _inputs(SHAPES[0], seed=9)
    want = JaxGNSiLU(G).apply({"params": {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}},
                              to_jax(x, jdt))
    mod = GNSiLU(G, x.shape[-1], eps=1e-6)
    mod.load_state_dict({"weight": to_torch(s), "bias": to_torch(b)})
    with torch.inference_mode():
        got = mod(to_torch(x, tdt))
    assert got.dtype == tdt
    assert_close(got, want, REL[dtype] if dtype == "bfloat16" else FP32_OP, "GNSiLU")


def test_wrapper_refuses_other_devices():
    x = torch.zeros(1, 2, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        groupnorm.group_norm_silu_fused(x, torch.ones(8), torch.zeros(8), 2)


# The kernel's launch plan (ops/groupnorm.py gn_silu_plan, csrc/gn_silu.cuh),
# checked as the kernel indexes: block b holds slices b * spb + t // tps,
# a slice (n, g) = divmod(s, G); thread t of a slice its vectors t % tps +
# k * tps, vector i at pixel i // vpp (by a float32 reciprocal), channels
# (i % vpp) * vw.. of the group.
TORCH_DTYPES = [torch.float32, torch.bfloat16]


def _check_plan(p, N, HW, C, G, dtype):
    cg, esize = C // G, torch.tensor([], dtype=dtype).element_size()
    widths = (8, 4, 1) if dtype == torch.bfloat16 else (4, 1)
    assert p.vw in widths and cg % p.vw == 0
    assert p.vw == next(w for w in widths if cg % w == 0)  # 16 bytes where the group allows
    assert p.threads <= 1024 and p.threads % 32 == 0
    if p.route == "l2":
        assert p.ints[0] == 1 and p.threads == p.tps == 1024 and p.blocks == N * G
        return
    nvec, vpp = HW * cg // p.vw, cg // p.vw
    assert p.ints == (0, p.vw, p.nv, p.tps, p.threads)
    assert 1 <= p.nv <= groupnorm.GNS_NV_MAX[p.vw]
    assert p.tps & (p.tps - 1) == 0 and p.tps <= groupnorm.GNS_MAX_THREADS
    assert p.threads % p.tps == 0 and (p.tps <= 32 or p.threads == p.tps)
    assert p.tps * (p.nv - 1) < nvec <= p.tps * p.nv <= groupnorm.GNS_MAX_VECS
    spb = p.threads // p.tps
    assert 8 * spb * cg <= groupnorm.GNS_MAX_SMEM  # the staged gamma and beta
    # every (example, group) once
    s = np.arange(p.blocks)[:, None] * spb + np.arange(spb)[None, :]
    s = s[s < N * G]
    assert s.size == N * G and np.array_equal(np.sort(s), np.arange(N * G))
    # every vector of a slice once, at the pixel the float reciprocal finds
    i = (np.arange(p.tps)[:, None] + p.tps * np.arange(p.nv)[None, :]).ravel()
    i = np.sort(i[i < nvec])
    assert np.array_equal(i, np.arange(nvec))
    rvpp = np.float32(1) / np.float32(vpp)
    pix = ((i.astype(np.float32) + np.float32(0.5)) * rvpp).astype(np.int64)
    assert np.array_equal(pix, i // vpp)


@pytest.mark.parametrize("dtype", TORCH_DTYPES, ids=str)
@pytest.mark.parametrize("batch", [8, 16, 128])
def test_gn_silu_plan_covers_the_ddpm_census(batch, dtype):
    """At every GNSiLU shape of the full-width DDPM the slices live in
    registers (at most GNS_NV_MAX vectors a thread, at most 1024 threads a
    slice), each (example, group) and each element once."""
    gn, _ = ddpm_census()
    for (H, C), _ in sorted(gn.items()):
        p = groupnorm.gn_silu_plan(batch, H * H, C, 32, dtype)
        assert p.route == "registers", (H, C)
        _check_plan(p, batch, H * H, C, 32, dtype)


@pytest.mark.parametrize("dtype", TORCH_DTYPES, ids=str)
def test_gn_silu_plan_takes_the_l2_route_off_the_census(dtype):
    """chip_smoke.py's shape off the census, 64 x 64 x 512 at batch 8: 4096
    x 16 values a slice, above the register budget."""
    p = groupnorm.gn_silu_plan(8, 64 * 64, 512, 32, dtype)
    assert p.route == "l2"
    _check_plan(p, 8, 64 * 64, 512, 32, dtype)


# (N, H, W, C, G): single elements (C / G odd), vectors of 4 in bf16, tiny
# maps, many slices, a slice just within and one past the register budget,
# and a group whose staged gamma and beta outgrow a block's shared memory
ODD_SHAPES = [(1, 1, 1, 1, 1), (2, 3, 5, 7, 7), (3, 9, 11, 96, 32), (2, 4, 4, 12, 3),
              (200, 2, 2, 64, 32), (1, 32, 32, 256, 2), (1, 128, 128, 256, 2),
              (1, 1, 1, 8192, 1), (2, 6, 5, 16, 2)]


@pytest.mark.parametrize("dtype", TORCH_DTYPES, ids=str)
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gn_silu_plan_takes_every_shape(shape, dtype):
    """Every shape whose channels split into the groups gets a plan (the
    kernel before this one took them all), and every plan holds."""
    N, H, W, C, G = shape
    _check_plan(groupnorm.gn_silu_plan(N, H * W, C, G, dtype), N, H * W, C, G, dtype)


def test_gn_silu_plan_raises_off_the_groups():
    with pytest.raises(ValueError, match="do not split"):
        groupnorm.gn_silu_plan(1, 4, 10, 4, torch.float32)
