"""Port ops against diffpure_tpu.ops: GroupNorm (+SiLU), naive resampling,
spatial attention. Tolerances: tests/torch_parity.py REL."""
import numpy as np
import pytest

from diffpure_tpu.ops import attention as jattn
from diffpure_tpu.ops import groupnorm as jgn
from diffpure_tpu.ops.upfirdn2d import naive_downsample_2d, naive_upsample_2d
from diffpure_tpu_torch.ops import attention, groupnorm, upfirdn2d
from torch_parity import DTYPES, REL, assert_close, normal, to_jax, to_torch


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("C", [32, 96, 160])
def test_group_norm(C, silu, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(C)
    x = normal(rng, 2, 8, 8, C, scale=2.0, shift=0.5)
    s, b = normal(rng, C, scale=0.1, shift=1.0), normal(rng, C, scale=0.1)
    G = groupnorm.ncsn_num_groups(C)
    assert G == jgn.ncsn_num_groups(C)
    jf = jgn.group_norm_silu if silu else jgn.group_norm
    tf = groupnorm.group_norm_silu if silu else groupnorm.group_norm
    want = jf(to_jax(x, jdt), to_jax(s), to_jax(b), G, 1e-6)
    got = tf(to_torch(x, tdt), to_torch(s), to_torch(b), G, 1e-6)
    assert got.dtype == tdt
    assert_close(got, want, REL[dtype], "group_norm")


@pytest.mark.parametrize("up", [False, True])
def test_naive_resample(up):
    x = normal(np.random.default_rng(1), 2, 8, 6, 5)
    jf = naive_upsample_2d if up else naive_downsample_2d
    tf = upfirdn2d.naive_upsample_2d if up else upfirdn2d.naive_downsample_2d
    assert_close(tf(to_torch(x)), jf(to_jax(x)), 1e-6, "resample")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hw", [4, 8])
def test_spatial_attention(hw, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(hw)
    q, k, v = (normal(rng, 2, hw, hw, 32) for _ in range(3))
    want = jattn.spatial_attention(*(to_jax(a, jdt) for a in (q, k, v)))
    got = attention.spatial_attention(*(to_torch(a, tdt) for a in (q, k, v)))
    assert_close(got, want, REL[dtype], "spatial_attention")
