"""Solver, purifier and defended model of the port against diffpure_tpu,
with the noise JAX draws injected into the port (torch generators cannot
reproduce threefry streams)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.classifiers.convert import translate_wideresnet
from diffpure_tpu.classifiers.wideresnet import WideResNet as JaxWRN
from diffpure_tpu.eval.defended import DefendedModel as JaxDefended
from diffpure_tpu.models.convert import translate_ncsnpp
from diffpure_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffpure_tpu.purify import PurifyConfig as JaxPurifyConfig
from diffpure_tpu.purify.runners import purify_sde as jax_purify_sde
from diffpure_tpu.solvers.em import brownian_increment as jax_brownian
from diffpure_tpu.solvers.em import sdeint_em as jax_sdeint_em
from diffpure_tpu_torch.classifiers import WideResNet
from diffpure_tpu_torch.eval import DefendedModel, get_accuracy
from diffpure_tpu_torch.models import NCSNpp
from diffpure_tpu_torch.purify import PurifyConfig, SeededNoise, purify, \
    purify_sde
from diffpure_tpu_torch.solvers import sdeint_em
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from torch_parity import assert_close, normal, np32

SMALL = dict(nf=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             image_size=16)
T_STAR = 10


class JaxNoise:
    """The draws of diffpure_tpu's purify_sde for ``key``, for the port:
    stream fold_in(key, 3*it + j), Brownian step i at fold_in(k_bm, i)."""

    def __init__(self, key):
        self.key = key

    def _k(self, it, j):
        return jax.random.fold_in(self.key, 3 * it + j)

    def forward_eps(self, it, shape, like):
        e = jax.random.normal(self._k(it, 1), shape, jnp.float32)
        return torch.from_numpy(np.array(e))

    def brownian(self, it, i, like, dt):
        dw = jax_brownian(self._k(it, 2), i, tuple(like.shape), dt, jnp.float32)
        return torch.from_numpy(np.array(dw))


def test_sdeint_em_matches_jax():
    key = jax.random.PRNGKey(3)
    x0 = normal(np.random.default_rng(0), 4, 8, 8, 3)
    t0, t1, n = 0.9, 1.0 - 1e-5, 10
    dt = (t1 - t0) / n
    want = jax_sdeint_em(lambda x, t: -x * (1.0 + t[:, None, None, None]),
                         lambda t: 0.5 + t, jnp.asarray(x0), t0, t1, n, key)
    got = sdeint_em(
        lambda x, t: -x * (1.0 + t[:, None, None, None]), lambda t: 0.5 + t,
        torch.from_numpy(x0), t0, t1, n,
        lambda i: torch.from_numpy(np.array(jax_brownian(
            key, i, x0.shape, dt, jnp.float32))))
    assert_close(got, want, 1e-6, "sdeint_em")


@pytest.fixture(scope="module")
def pipeline():
    """Small NCSN++ and WRN-10-2 with the same seeded weights in both
    packages, and the JAX defended model's purified images and logits."""
    score = NCSNpp(**SMALL).eval()
    sd = seeded_normal_state_dict(score, 0)
    score.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jscore, jparams = JaxNCSNpp(**SMALL), translate_ncsnpp(sd)

    clf = WideResNet(depth=10, widen_factor=2).eval()
    csd = seeded_normal_state_dict(clf, 1)
    clf.load_state_dict({k: torch.from_numpy(v) for k, v in csd.items()})
    jclf = JaxWRN(depth=10, widen_factor=2, normalize_input=False)
    jcparams = translate_wideresnet(csd)

    x01 = np.random.default_rng(2).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jcfg = JaxPurifyConfig(t=T_STAR, grad_mode="none")
    jdm = JaxDefended(lambda p, x, t: jscore.apply(p, x, t), jparams,
                      lambda p, x: jclf.apply(p, x), jcparams, jcfg, log_every=0)
    x_pure = jax_purify_sde(lambda p, x, t: jscore.apply(p, x, t), jparams,
                            (jnp.asarray(x01) - 0.5) * 2.0, key, jcfg)
    logits = jdm(jnp.asarray(x01), key)
    return dict(score=score, clf=clf, x01=x01, key=key, x_pure=x_pure,
                logits=logits)


def test_purify_sde_matches_jax(pipeline):
    cfg = PurifyConfig(t=T_STAR, grad_mode="none")
    x = torch.from_numpy(pipeline["x01"]) * 2.0 - 1.0
    with torch.inference_mode():
        got = purify_sde(pipeline["score"], x, JaxNoise(pipeline["key"]), cfg)
    assert_close(got, pipeline["x_pure"], 1e-4, "purify_sde")


def test_defended_model_matches_jax(pipeline):
    dm = DefendedModel(pipeline["score"], pipeline["clf"],
                       PurifyConfig(t=T_STAR), log_every=0)
    with torch.inference_mode():
        logits = dm(torch.from_numpy(pipeline["x01"]), JaxNoise(pipeline["key"]))
    want = np32(pipeline["logits"])
    assert logits.shape == (2, 10)
    np.testing.assert_array_equal(np32(logits).argmax(-1), want.argmax(-1))
    assert_close(logits, want, 1e-4, "defended logits")
    assert dm._counter == 1


def test_seeded_noise_replays_and_get_accuracy():
    """Same seed, same purification; a new seed per minibatch."""
    cfg = PurifyConfig(t=3)
    model = lambda x, t: 0.1 * x  # noqa: E731  linear epsilon model
    x = torch.rand(4, 8, 8, 3) * 2 - 1
    with torch.inference_mode():
        a, b = purify(model, x, 5, cfg), purify(model, x, SeededNoise(5), cfg)
        c = purify(model, x, 6, cfg)
    assert torch.equal(a, b) and not torch.equal(a, c)
    offsets = {SeededNoise(s).t_offset(0, 15) for s in range(50)}
    assert offsets <= set(range(-15, 15)) and len(offsets) > 10
    assert SeededNoise(3).t_offset(1, 15) == SeededNoise(3).t_offset(1, 15)

    seeds = []

    def model_fn(xb, seed):
        seeds.append(seed)
        return torch.nn.functional.one_hot(xb[:, 0, 0, 0].long(), 10).float()

    xs = torch.zeros(5, 2, 2, 1)
    xs[:, 0, 0, 0] = torch.tensor([1., 2., 3., 4., 5.])
    acc = get_accuracy(model_fn, xs, torch.tensor([1, 2, 0, 4, 0]), seed=9, bs=2)
    assert acc == pytest.approx(3 / 5)
    assert len(seeds) == 3 and len(set(seeds)) == 3


def test_unported_paths_raise():
    """Every runner of the reference runs: 'ode', 'ldsde' and grad_mode
    'reversible' since item 11 (tests/test_torch_ode.py), the discrete
    'ddpm' and 'celebahq-ddpm' loops since items 15 and 17
    (tests/test_torch_discrete.py, test_torch_celebahq.py); an unknown
    diffusion type or grad mode raises."""
    x = torch.zeros(1, 8, 8, 3)
    for cfg, model in ((PurifyConfig(diffusion_type="ddpm", t=2),
                        lambda xx, t: torch.cat([xx, xx], dim=-1)),
                       (PurifyConfig(diffusion_type="celebahq-ddpm", t=2), lambda xx, t: xx)):
        assert purify(model, x, 0, cfg).shape == x.shape
    with pytest.raises(NotImplementedError, match="unknown diffusion type"):
        purify(lambda xx, t: xx, x, 0, PurifyConfig(diffusion_type="vp-ddim"))
    for cfg in (PurifyConfig(diffusion_type="ode", t=2), PurifyConfig(t=2, grad_mode="reversible"),
                PurifyConfig(diffusion_type="ldsde", t=20)):
        assert purify(lambda xx, t: xx, x, 0, cfg).shape == x.shape
    with pytest.raises(ValueError, match="grad_mode"):
        purify(lambda xx, t: xx, x, 0, PurifyConfig(grad_mode="exact"))
