"""Fused bias + leaky ReLU + gain, kernel #11's plain version and CPU
wrapper, against diffpure_tpu's fused_leaky_relu and
fused_leaky_relu_pallas (interpret mode; it always takes a bias, so the
no-bias case gives it zeros). fp32: 1e-5 of max |ref|; bf16: 1e-2."""
import numpy as np
import pytest
import torch

from diffpure_tpu.ops import fused_act as jfa
from diffpure_tpu_torch.ops import fused_act, fused_leaky_relu, launch_counts
from torch_parity import DTYPES, REL, assert_close, normal, to_jax, to_torch

TOL = {"float32": 1e-5, "bfloat16": REL["bfloat16"]}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("slope,gain", [(0.2, 2.0 ** 0.5), (0.1, 1.0), (0.0, 3.0)])
@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (3, 5, 7)], ids=["nhwc", "odd"])
def test_matches_jax(shape, slope, gain, with_bias, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(len(shape))
    x = normal(rng, *shape)
    b = normal(rng, shape[-1]) if with_bias else None
    want = jfa.fused_leaky_relu(to_jax(x, jdt), to_jax(b, jdt), slope, gain)
    want_pallas = jfa.fused_leaky_relu_pallas(
        to_jax(x, jdt), to_jax(b if with_bias else np.zeros(shape[-1], np.float32), jdt),
        slope, gain, interpret=True)
    before = launch_counts()["fused_leaky_relu"]
    got = fused_leaky_relu(to_torch(x, tdt), to_torch(b), slope, gain)
    assert got.dtype == tdt and launch_counts()["fused_leaky_relu"] == before
    assert torch.equal(got, fused_act.fused_leaky_relu_reference(
        to_torch(x, tdt), to_torch(b), slope, gain))
    assert_close(got, want, TOL[dtype], "fused_leaky_relu")
    assert_close(got, want_pallas, TOL[dtype], "fused_leaky_relu_pallas")


def test_defaults_and_devices():
    x = torch.tensor([[-1.0, 2.0]])
    np.testing.assert_allclose(fused_leaky_relu(x).numpy(),
                               [[-0.2 * 2 ** 0.5, 2.0 * 2 ** 0.5]], rtol=1e-6)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_leaky_relu(torch.zeros(2, 4, device="meta"))
