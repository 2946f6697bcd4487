"""NCSN++'s training mode and its flax-style init, against diffpure_tpu's
on the CPU: ``forward(train=True)`` (the residual blocks on their plain
version, dropout drawn from the caller's generator) and ``init_`` (the
distributions of JAX's ``ddpm_init`` leaf by leaf)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.models.convert import translate_ncsnpp
from diffpure_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffpure_tpu_torch.models import NCSNpp
from diffpure_tpu_torch.models.convert import ncsnpp_state_dict_from_flax
from diffpure_tpu_torch.models.layers import dropout
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from torch_parity import assert_close, two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

SMALL = dict(image_size=8, nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,),
             dropout=0.0)


def t_(a):
    return torch.from_numpy(np.array(a)).float()


@pytest.fixture(scope="module")
def small_ncsnpp():
    model = NCSNpp(**SMALL)
    sd = seeded_normal_state_dict(model, 0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model, translate_ncsnpp(sd)


def _by_name(tree):
    return {k: v for k, v in ncsnpp_state_dict_from_flax(tree).items() if k != "sigmas"}


def test_ncsnpp_train_mode_matches_jax(small_ncsnpp):
    """train=True at dropout 0 is JAX's train=True (both on the plain
    blocks); the dropout itself is flax's rule."""
    model, jparams = small_ncsnpp
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    want = jax.jit(lambda p, xx, tt: JaxNCSNpp(**SMALL).apply(p, xx, tt, train=True))(
        jparams, jnp.asarray(x), jnp.asarray(t))
    got = model(t_(x), t_(t), train=True, generator=torch.Generator().manual_seed(0))
    assert_close(got, want, 1e-4, "train mode")
    assert_close(model(t_(x), t_(t)), want, 1e-4, "eval mode")

    h = torch.randn(4, 64, 64)
    g = torch.Generator().manual_seed(3)
    out = dropout(h, 0.25, g)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.allclose(out[kept], h[kept] / 0.75)
    assert torch.equal(dropout(h, 0.25, torch.Generator().manual_seed(3)), out)
    assert dropout(h, 0.0, g) is h
    drop = NCSNpp(**dict(SMALL, dropout=0.5))
    drop.load_state_dict(model.state_dict())
    a = drop(t_(x), t_(t), train=True, generator=torch.Generator().manual_seed(0))
    b = drop(t_(x), t_(t), train=True, generator=torch.Generator().manual_seed(1))
    assert not torch.allclose(a, b)


def test_ncsnpp_train_at_dropout_0_keeps_the_kernel_route(small_ncsnpp, monkeypatch):
    """At dropout 0, train=True is eval mode's function on eval mode's route
    (the wrappers that launch the kernels on a CUDA tensor): the block's
    plain training branch is never taken, and the output and every weight
    gradient equal eval mode's bit for bit. Above rate 0 the branch is
    taken."""
    from diffpure_tpu_torch.models import layers

    model, _ = small_ncsnpp
    rng = np.random.default_rng(13)
    x = t_(rng.standard_normal((2, 8, 8, 3)))
    t = t_([3.0, 700.0])
    taken = []
    plain = layers.ResnetBlockBigGANpp._forward_plain
    monkeypatch.setattr(layers.ResnetBlockBigGANpp, "_forward_plain",
                        lambda *a, **k: taken.append(1) or plain(*a, **k))
    outs, grads = [], []
    for train in (True, False):
        out = model(x, t, train=train, generator=torch.Generator().manual_seed(0))
        outs.append(out)
        grads.append(torch.autograd.grad(out.square().sum(), list(model.parameters())))
    assert not taken
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    drop = NCSNpp(**dict(SMALL, dropout=0.5))
    drop.load_state_dict(model.state_dict())
    drop(x, t, train=True, generator=torch.Generator().manual_seed(0))
    assert len(taken) == sum(isinstance(m, layers.ResnetBlockBigGANpp)
                             for m in drop.modules())


@pytest.mark.parametrize("resblock_type", ["biggan", "ddpm"])
def test_ncsnpp_init_draws_as_flax(resblock_type):
    """Leaf by leaf against flax's init of the same model: the constants
    exactly, init_scale leaves ~1e-10, and each drawn leaf within the
    uniform bound JAX draws from, its std within 15% of JAX's."""
    cfg = dict(SMALL, resblock_type=resblock_type)
    jp = jax.jit(JaxNCSNpp(**cfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                                        jnp.zeros((1,)))
    want = _by_name(jax.tree_util.tree_map(np.asarray, jp))
    got = dict(NCSNpp(**cfg).init_(torch.Generator().manual_seed(0)).named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].detach()
        w = w.float()
        if float(w.abs().max()) == 0 or bool((w == 1).all()):
            assert torch.equal(g, w), name
        elif float(w.abs().max()) < 1e-8:
            assert float(g.abs().max()) < 1e-8, name
        else:
            fan_in = w.shape[0] if name.endswith(".W") else math.prod(w.shape[1:])
            fan_out = w.shape[1] if name.endswith(".W") else w.shape[0] * math.prod(w.shape[2:])
            scale = 0.1 if name.endswith(".W") else 1.0
            limit = math.sqrt(3 * scale / ((fan_in + fan_out) / 2))
            assert float(w.abs().max()) <= limit * (1 + 1e-6), name
            assert float(g.abs().max()) <= limit * (1 + 1e-6), name
            if w.numel() >= 256:
                assert abs(float(g.std()) / float(w.std()) - 1) < 0.15, name
