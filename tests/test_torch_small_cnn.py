"""The demo's classifiers against diffpure_tpu's, on the CPU: ``SmallCNN`` /
``SmallMLP`` against flax on converted weights, with flax's SAME padding
of the stride-2 convs (0, 1) (1e-5), their flax-style init, and a few
``train_classifier`` steps fed JAX's batches from JAX's init."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffpure_tpu.classifiers import small_cnn as jcnn
from diffpure_tpu.data import synthetic as jsyn
from diffpure_tpu_torch.classifiers.convert import small_cnn_state_dict_from_flax, \
    small_mlp_state_dict_from_flax
from diffpure_tpu_torch.classifiers.small_cnn import SmallCNN, SmallMLP, train_classifier
from diffpure_tpu_torch.data import synthetic as syn
from diffpure_tpu_torch.ops.conv import conv2d_nhwc
from torch_parity import assert_close, two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

# float32 on both sides, one rounding apart
REL = 1e-5
SPEC = dict(size=8, n_classes=4, amp_range=(0.2, 0.4), noise_std=0.04)


def t_(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _jax_init(model, size):
    return jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))


@pytest.mark.parametrize("size", [8, 9])
def test_small_classifiers_match_flax(size):
    rng = np.random.default_rng(size)
    x = rng.uniform(size=(3, size, size, 3)).astype(np.float32)
    for jm, pm, conv in ((jcnn.SmallCNN(n_classes=4, width=8), SmallCNN(4, 8, size),
                          small_cnn_state_dict_from_flax),
                         (jcnn.SmallMLP(n_classes=4, width=64), SmallMLP(4, 64, size),
                          small_mlp_state_dict_from_flax)):
        jp = _jax_init(jm, size)
        # non-zero biases, so that a wrong bias mapping shows
        jp = jax.tree_util.tree_map(lambda a: a + 0.05 if a.ndim == 1 else a, jp)
        pm.load_state_dict(conv(jp))
        assert_close(pm(t_(x)), jax.jit(jm.apply)(jp, jnp.asarray(x)), REL, type(pm).__name__)
    # the padding matters: symmetric (1, 1) padding at stride 2 is another model
    cnn = SmallCNN(4, 8, 16).init_(torch.Generator().manual_seed(0))
    xs = (t_(rng.uniform(size=(2, 16, 16, 3))) - 0.5) * 2
    ours = conv2d_nhwc(F.pad(xs, (0, 0, 0, 1, 0, 1)), cnn.Conv_1.weight[:, :3], None, 2, 0)
    sym = conv2d_nhwc(xs, cnn.Conv_1.weight[:, :3], None, 2, 1)
    assert not torch.allclose(ours, sym)


def test_classifier_init_draws_as_flax():
    jp = _jax_init(jcnn.SmallCNN(n_classes=4, width=32), 16)
    want = small_cnn_state_dict_from_flax(jp)
    got = SmallCNN(4, 32, 16).init_(torch.Generator().manual_seed(0)).state_dict()
    for name, w in want.items():
        g = got[name]
        if name.endswith("bias"):
            assert torch.equal(g, w), name
            continue
        fan_in = math.prod(w.shape[1:])
        bound = 2 * math.sqrt(1 / fan_in) / 0.87962566103423978
        assert float(g.abs().max()) <= bound * (1 + 1e-6), name
        assert float(w.abs().max()) <= bound * (1 + 1e-6), name
        if w.numel() >= 256:
            assert abs(float(g.std()) / float(w.std()) - 1) < 0.15, name


def test_train_classifier_steps_match_jax():
    """Four Adam steps from JAX's init on JAX's batches: the loss and the
    weights as JAX's (its first steps move each weight by about lr * sign(g),
    so the bound is a fraction of lr). The MLP: JAX compiles the CNN's
    training scan for ~20 s on the CPU, the MLP's in a few."""
    jspec = jsyn.SyntheticSpec(**SPEC)
    key = jax.random.PRNGKey(1)
    sample_fn = jax.jit(lambda k, n: jsyn.sample_batch(k, n, jspec), static_argnums=1)
    _, jparams, jloss = jcnn.train_classifier(key, sample_fn, width=8, steps=4, batch_size=16,
                                              lr=1e-3, scan_chunk=4, arch="mlp")
    x0, _ = sample_fn(key, 2)
    init = jax.jit(jcnn.SmallMLP(n_classes=4, width=64).init)(key, (x0 + 1.0) * 0.5)
    model = SmallMLP(4, 64, 8)
    model.load_state_dict(small_mlp_state_dict_from_flax(init))
    batches = [sample_fn(jax.random.fold_in(key, i), 16) for i in range(4)]
    feed = iter((t_(x), t_(y, torch.int64)) for x, y in batches)
    model, loss = train_classifier(0, lambda g, n: next(feed), width=8, steps=4,
                                   batch_size=16, lr=1e-3, scan_chunk=4, arch="mlp",
                                   model=model, device="cpu")
    assert loss == pytest.approx(jloss, rel=1e-5)
    want = small_mlp_state_dict_from_flax(jparams)
    for name, p in model.state_dict().items():
        assert float((p - want[name]).abs().max()) <= 1e-6, name
    # the finite-sample regime, drawn by the port: deterministic in its seed
    spec = syn.SyntheticSpec(**SPEC)
    runs = [train_classifier(3, lambda g, n: syn.sample_batch(g, n, spec), width=8, steps=2,
                             batch_size=8, scan_chunk=2, n_train=32, arch=arch, device="cpu")
            for arch in ("cnn", "cnn", "mlp")]
    assert runs[0][1] == runs[1][1] and math.isfinite(runs[2][1])
    assert isinstance(runs[2][0], SmallMLP)


def test_train_classifier_defaults_to_the_card(monkeypatch):
    """With no device it trains on the card, and raises where there is
    none: never a quiet fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = syn.SyntheticSpec(**SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_classifier(0, lambda g, n: syn.sample_batch(g, n, spec), width=8, steps=1,
                         batch_size=4, scan_chunk=1)
