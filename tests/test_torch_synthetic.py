"""The demo's data against diffpure_tpu's, on the CPU.

- the grating and Gaussian-mixture batches built from JAX's draws
  (``grating_batch`` / ``gmm_batch``), ``class_means`` and the closed-form
  ``gmm_vp_eps_model`` (1e-5 x max);
- the training image loader (``data/image_datasets``) batch for batch.
The demo's classifiers: tests/test_torch_small_cnn.py.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.data import image_datasets as jimg
from diffpure_tpu.data import synthetic as jsyn
from diffpure_tpu_torch.data import image_datasets as img
from diffpure_tpu_torch.data import synthetic as syn
from torch_parity import assert_close, two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

# float32 sin / cos / exp on both sides, one rounding apart
REL = 1e-5
SPEC = dict(size=8, n_classes=4, amp_range=(0.2, 0.4), noise_std=0.04)


def t_(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def test_grating_batch_from_jax_draws():
    spec, jspec = syn.SyntheticSpec(**SPEC), jsyn.SyntheticSpec(**SPEC)
    key, n, C, S = jax.random.PRNGKey(3), 16, 3, 8
    want_x, want_y = jax.jit(lambda k: jsyn.sample_batch(k, n, jspec))(key)

    @jax.jit
    def draws(key):
        k_y, k_phase, k_amp, k_dc, k_noise = jax.random.split(key, 5)
        return (jax.random.randint(k_y, (n,), 0, 4),
                jax.random.uniform(k_phase, (n,), maxval=2 * jnp.pi),
                jax.random.uniform(k_amp, (n, 1, 1, C), minval=0.2, maxval=0.4),
                jax.random.uniform(k_dc, (n, 1, 1, C), minval=-0.1, maxval=0.1),
                jax.random.normal(k_noise, (n, S, S, C)))

    y, phase, amp, dc, noise = draws(key)
    x, got_y = syn.grating_batch(spec, t_(y, torch.int64), t_(phase), t_(amp), t_(dc), t_(noise))
    assert_close(x, want_x, REL, "x")
    assert torch.equal(got_y, t_(want_y, torch.int64))
    # the port's own draws: labelled, in range, the same for the same stream
    a, ya = syn.sample_batch(torch.Generator().manual_seed(0), 64, spec)
    b, _ = syn.sample_batch(torch.Generator().manual_seed(0), 64, spec)
    assert torch.equal(a, b) and a.shape == (64, 8, 8, 3) and float(a.abs().max()) <= 1
    assert set(ya.tolist()) == {0, 1, 2, 3}
    it = syn.dataset_iterator(5, 4, spec)
    assert not torch.equal(next(it)[0], next(it)[0])


def test_gmm_batch_means_and_eps_model():
    spec, jspec = syn.SyntheticSpec(size=8), jsyn.SyntheticSpec(size=8)
    assert_close(syn.class_means(spec, 0.25, device="cpu"), jsyn.class_means(jspec, 0.25), REL,
                 "means")
    key = jax.random.PRNGKey(4)
    want_x, _ = jax.jit(lambda k: jsyn.sample_gmm_batch(k, 12, jspec, 0.25, 0.08))(key)

    @jax.jit
    def draws(key):
        k_y, k_n = jax.random.split(key)
        return jax.random.randint(k_y, (12,), 0, 4), jax.random.normal(k_n, (12, 8, 8, 3))

    y, z = draws(key)
    x, _ = syn.gmm_batch(spec, t_(y, torch.int64), t_(z), 0.25, 0.08)
    assert_close(x, want_x, REL, "gmm x")
    got, ref = syn.gmm_vp_eps_model(spec, 0.25, 0.08), jsyn.gmm_vp_eps_model(jspec, 0.25, 0.08)
    rng = np.random.default_rng(1)
    xt = rng.standard_normal((5, 8, 8, 3)).astype(np.float32) * 0.5
    tc = np.array([1.0, 50.0, 300.0, 700.0, 998.0], np.float32)
    # eager: jitted, XLA rounds 1 - a^2 near t = 0 another way (3e-4 of std)
    assert_close(got(t_(xt), t_(tc)), ref(None, jnp.asarray(xt), jnp.asarray(tc)), REL, "eps")
    xs, ys = syn.sample_gmm_batch(torch.Generator().manual_seed(2), 8, spec, 0.25, 0.08)
    assert xs.shape == (8, 8, 8, 3) and ys.dtype == torch.int64


@pytest.fixture
def image_dir(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    for cls in ("cat", "dog"):
        for i in range(5):
            arr = (rng.rand(40, 48, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(tmp_path / f"{cls}_{i:03d}.png")
    return str(tmp_path)


@pytest.mark.parametrize("kw", [dict(deterministic=True, random_flip=False),
                                dict(random_crop=True, class_cond=True),
                                dict(shard=1, num_shards=2, class_cond=True)])
def test_training_loader_matches_jax(image_dir, kw):
    assert img.list_image_files_recursively(image_dir) == \
        jimg.list_image_files_recursively(image_dir)
    ours = img.load_data(data_dir=image_dir, batch_size=2, image_size=16, seed=4, **kw)
    theirs = jimg.load_data(data_dir=image_dir, batch_size=2, image_size=16, seed=4, **kw)
    for _ in range(3):
        (a, ka), (b, kb) = next(ours), next(theirs)
        np.testing.assert_array_equal(a, b)
        assert ka.keys() == kb.keys()
        for k in ka:
            np.testing.assert_array_equal(ka[k], kb[k])
    from PIL import Image
    im = Image.fromarray((np.random.RandomState(1).rand(50, 70, 3) * 255).astype(np.uint8))
    np.testing.assert_array_equal(img.center_crop_arr(im, 24), jimg.center_crop_arr(im, 24))
    np.testing.assert_array_equal(img.random_crop_arr(im, 24, rng=random.Random(2)),
                                  jimg.random_crop_arr(im, 24, rng=random.Random(2)))


def test_class_means_default_to_the_card(monkeypatch):
    """JAX builds the means on its default device: the port's default is
    the card, which raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        syn.class_means(syn.SyntheticSpec(size=8))
