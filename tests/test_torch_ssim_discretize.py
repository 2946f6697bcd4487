"""SSIM (utils/ssim.py) and 8-bit discretization (attacks/discretization.py)
in the port against diffpure_tpu's on the same inputs: SSIM at 1e-6, both
reductions; rounding exactly (half to even in both); randomized rounding
by its law; the discretized attack check on a seedless classifier."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.attacks.discretization import discretize_image as jdiscretize
from diffpure_tpu.attacks.discretization import discretized_adversarial_check as jcheck
from diffpure_tpu.utils.ssim import ssim as jssim
from diffpure_tpu_torch.attacks.discretization import discretize_image, \
    discretized_adversarial_check
from diffpure_tpu_torch.utils.ssim import gaussian_window, ssim
from test_torch_perturbations import mlp
from torch_parity import assert_close


def _pair(seed=0, shape=(2, 16, 16, 3), noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    y = np.clip(x + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("window", [11, 7])
def test_ssim_matches_jax(size_average, window):
    x, y = _pair()
    got = ssim(torch.from_numpy(x), torch.from_numpy(y), window_size=window,
               size_average=size_average)
    want = jssim(jnp.asarray(x), jnp.asarray(y), window_size=window, size_average=size_average)
    assert_close(got.reshape(-1), np.asarray(want).reshape(-1), 1e-6, "ssim")


def test_ssim_identical_and_noisy():
    x, y = _pair(1, noise=0.3)
    tx = torch.from_numpy(x)
    assert float(ssim(tx, tx)) > 0.999
    assert float(ssim(tx, torch.from_numpy(y))) < 0.8
    w = gaussian_window(11, 1.5)
    assert abs(float(w.sum()) - 1) < 1e-6 and np.allclose(w, w[::-1, ::-1])


def test_round_matches_jax_exactly():
    """Every level and every half-way point (half to even in both)."""
    x = np.concatenate([np.arange(256), np.arange(256) + 0.5]).astype(np.float32) / 255
    x = np.concatenate([x, np.random.default_rng(2).uniform(size=512).astype(np.float32)])
    x = x.reshape(1, 32, 32, 1)
    got = discretize_image(torch.from_numpy(x), "round")
    want = np.asarray(jdiscretize(jnp.asarray(x), "round"))
    assert np.array_equal(got.numpy(), want)
    assert float((got - torch.from_numpy(x)).abs().max()) <= 0.5 / 255 + 1e-6


def test_random_rounding_by_its_law():
    x = torch.full((1, 100, 100, 1), 0.5 + 0.3 / 255)
    q = discretize_image(x, "random", seed=3)
    levels = q * 255
    assert torch.equal(levels, torch.round(levels))
    assert set(torch.unique(torch.round(levels)).tolist()) == {127.0, 128.0}
    assert abs(float(q.mean()) - float(x.mean())) < 2e-4
    assert torch.equal(q, discretize_image(x, "random", seed=3))
    with pytest.raises(ValueError):
        discretize_image(x, "random")


def test_adversarial_check_matches_jax():
    jm, tm = mlp(1)
    x = np.random.default_rng(4).uniform(size=(6, 4, 4, 3)).astype(np.float32)
    y = np.asarray(jnp.argmax(jm(jnp.asarray(x), None), -1))
    y_wrong = (y + 1) % 3
    for labels in (y, y_wrong):
        got = discretized_adversarial_check(tm, torch.from_numpy(x), torch.from_numpy(labels), 0)
        want = jcheck(jm, jnp.asarray(x), jnp.asarray(labels), jax.random.PRNGKey(0))
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert not discretized_adversarial_check(tm, torch.from_numpy(x), torch.from_numpy(y),
                                             0).all()
