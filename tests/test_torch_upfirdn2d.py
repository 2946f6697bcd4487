"""The port's FIR resampling (diffpure_tpu_torch/ops/upfirdn2d.py) against
diffpure_tpu/ops/upfirdn2d.py on the same seeded inputs: upfirdn2d itself
(up, down, pads, odd and even kernels, an asymmetric kernel that exposes
the convolution's flip), upsample_2d / downsample_2d with gain, and the
fused upsample_conv_2d / conv_downsample_2d with 3x3 and 1x1 weights,
factor 2 (and 3 for the plain resamplers). fp32 at 1e-5 of the largest
reference value; bf16 at 1e-2 (the same bf16 inputs and kernel; each side
accumulates in its own order)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu_torch.ops import upfirdn2d as tfir
from torch_parity import DTYPES, REL, assert_close, normal

# diffpure_tpu.ops re-exports the function under the module's name
jfir = importlib.import_module("diffpure_tpu.ops.upfirdn2d")
FP32 = 1e-5
KERNELS = {"even": [1, 3, 3, 1], "odd": [1, 2, 1], "box": [1, 1], "long": [1, 3, 5, 3, 1]}


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (2, 2, (2, 2)), (1, 1, (0, 0)), (3, 1, (2, 2)),
                                         (2, 1, (-1, 1))])
@pytest.mark.parametrize("k", ["even", "odd"])
def test_upfirdn2d_matches_jax(up, down, pad, k):
    x = normal(_rng(0), 2, 8, 7, 3)
    kk = jfir.setup_fir_kernel(KERNELS[k])
    np.testing.assert_array_equal(tfir.setup_fir_kernel(KERNELS[k]), kk)
    want = jax.jit(lambda x: jfir.upfirdn2d(x, jnp.asarray(kk), up=up, down=down, pad=pad))(
        jnp.asarray(x))
    got = tfir.upfirdn2d(torch.from_numpy(x), kk, up=up, down=down, pad=pad)
    assert_close(got, want, FP32, f"upfirdn2d up={up} down={down} pad={pad} {k}")


def test_asymmetric_kernel_is_flipped():
    x = normal(_rng(1), 1, 6, 6, 2)
    kk = np.outer([1.0, 2.0, 4.0], [1.0, 0.5, 3.0]).astype(np.float32)
    want = jfir.upfirdn2d(jnp.asarray(x), jnp.asarray(kk), pad=(1, 1))
    got = tfir.upfirdn2d(torch.from_numpy(x), kk, pad=(1, 1))
    assert_close(got, want, FP32, "asymmetric kernel")


@pytest.mark.parametrize("fn", ["upsample_2d", "downsample_2d"])
@pytest.mark.parametrize("k", list(KERNELS) + [None])
@pytest.mark.parametrize("factor,gain", [(2, 1.0), (2, 1.7), (3, 1.0)])
def test_resamplers_match_jax(fn, k, factor, gain):
    x = normal(_rng(2), 2, 12, 12, 4)
    kern = KERNELS.get(k)
    want = jax.jit(lambda x: getattr(jfir, fn)(x, kern, factor=factor, gain=gain))(
        jnp.asarray(x))
    got = getattr(tfir, fn)(torch.from_numpy(x), kern, factor=factor, gain=gain)
    assert_close(got, want, FP32, f"{fn} k={k} factor={factor} gain={gain}")


@pytest.mark.parametrize("fn", ["upsample_conv_2d", "conv_downsample_2d"])
@pytest.mark.parametrize("k", ["even", "odd", "long"])
@pytest.mark.parametrize("ksize", [3, 1])
@pytest.mark.parametrize("gain", [1.0, 0.5])
def test_fused_conv_resamplers_match_jax(fn, k, ksize, gain):
    rng = _rng(3)
    x = normal(rng, 2, 8, 8, 5)
    w_hwio = normal(rng, ksize, ksize, 5, 6, fan_in=ksize * ksize * 5)
    want = jax.jit(lambda x, w: getattr(jfir, fn)(x, w, k=KERNELS[k], gain=gain))(
        jnp.asarray(x), jnp.asarray(w_hwio))
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    got = getattr(tfir, fn)(torch.from_numpy(x), w, k=KERNELS[k], gain=gain)
    assert got.shape == (2, 16, 16, 6) if fn.startswith("up") else got.shape == (2, 4, 4, 6)
    assert_close(got, want, FP32, f"{fn} k={k} {ksize}x{ksize} gain={gain}")


@pytest.mark.parametrize("fn", ["upsample_2d", "downsample_2d", "upsample_conv_2d",
                                "conv_downsample_2d"])
def test_bf16_matches_jax(fn):
    jdt, tdt = DTYPES["bfloat16"]
    rng = _rng(4)
    x = normal(rng, 2, 8, 8, 8)
    args = ()
    if "conv" in fn:
        w_hwio = normal(rng, 3, 3, 8, 8, fan_in=72)
        args = (w_hwio,)
    want = getattr(jfir, fn)(jnp.asarray(x, jdt), *(jnp.asarray(a) for a in args),
                             k=[1, 3, 3, 1])
    targs = tuple(torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
                  for a in args)
    got = getattr(tfir, fn)(torch.from_numpy(x).to(tdt), *targs, k=[1, 3, 3, 1])
    assert got.dtype == tdt and want.dtype == jdt
    assert_close(got, want, REL["bfloat16"], f"{fn} bf16")


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        tfir.setup_fir_kernel(np.ones((2, 3)))
    with pytest.raises(ValueError):
        tfir.upsample_2d(torch.zeros(1, 4, 4, 1), factor=0)
    with pytest.raises(ValueError):
        tfir.upsample_conv_2d(torch.zeros(1, 4, 4, 2), torch.zeros(3, 4, 3, 3))
