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
from torch_parity import DTYPES, REL, assert_close, normal, to_jax, to_torch

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
