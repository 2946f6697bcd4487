"""DPM-Solver++(2M) and the DPM purifier of the port against diffpure_tpu's,
with the noise JAX draws injected (its stream layout: t* from
fold_in(key, 2*it), the forward noise from fold_in(key, 2*it + 1)).

- ``dpm_solver_pp_2m`` on a nonlinear epsilon model at 1, 2, 5 and 20
  steps (one step: the DDIM step alone), and the float32 time grid;
- ``purify_dpm`` through a small NCSN++ (fp32, 1e-4), and with rand_t and
  two purification rounds on a small epsilon model (the stream layout);
- ``grad_mode='none'`` detaches; the checkpointed input gradient against
  ``jax.grad``; the NFE ledger reads ``dpm_solver_pp`` = n_steps a call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.diffusion.sde import VPSDE as JaxVPSDE
from diffpure_tpu.models.convert import translate_ncsnpp
from diffpure_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffpure_tpu.purify import PurifyConfig as JaxPurifyConfig
from diffpure_tpu.purify.runners import purify_dpm as jax_purify_dpm
from diffpure_tpu.solvers.dpm import dpm_solver_pp_2m as jax_dpm
from diffpure_tpu_torch.diffusion.sde import VPSDE
from diffpure_tpu_torch.models import NCSNpp
from diffpure_tpu_torch.purify import PurifyConfig, SeededNoise, purify, purify_dpm
from diffpure_tpu_torch.solvers import dpm_solver_pp_2m
from diffpure_tpu_torch.solvers.dpm import linspace_f32
from diffpure_tpu_torch.utils.profiling import count_nfe
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from torch_parity import assert_close, normal

SMALL = dict(nf=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             image_size=16)


class JaxDPMNoise:
    """The draws of diffpure_tpu's purify_dpm for ``key``."""

    def __init__(self, key):
        self.key = key

    def t_offset(self, it, t_delta):
        k = jax.random.fold_in(self.key, 2 * it)
        return int(jax.random.randint(k, (), -t_delta, t_delta))

    def forward_eps(self, it, shape, like):
        e = jax.random.normal(jax.random.fold_in(self.key, 2 * it + 1), shape, jnp.float32)
        return torch.from_numpy(np.array(e))


def _eps_models(seed=0, d=48):
    """A nonlinear, time-dependent epsilon model in both packages."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((d, d)).astype(np.float32) / np.float32(np.sqrt(d))
    jW, tW = jnp.asarray(W), torch.from_numpy(W)

    def jeps(x, t):
        h = jnp.tanh(x.reshape(x.shape[0], -1) @ jW) * (1.0 + t[:, None])
        return h.reshape(x.shape)

    def teps(x, t):
        h = torch.tanh(x.reshape(x.shape[0], -1) @ tW) * (1.0 + t[:, None])
        return h.reshape(x.shape)

    return jeps, teps


def test_linspace_f32_matches_jax():
    """The float32 grid, to an ulp (XLA's fused arithmetic), ends on stop."""
    for start, stop, num in ((0.1, 1e-5, 21), (0.005, 1e-5, 4), (0.4, 1e-5, 101),
                             (0.1, 1e-5, 7)):
        got = linspace_f32(start, stop, num)
        want = np.asarray(jnp.linspace(start, stop, num))
        assert got.dtype == np.float32 and got[-1] == np.float32(stop)
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("n_steps", [1, 2, 5, 20])
def test_dpm_solver_matches_jax(n_steps):
    jeps, teps = _eps_models()
    x = normal(np.random.default_rng(1), 3, 4, 4, 3)
    want = jax_dpm(jeps, jnp.asarray(x), 0.1, 1e-5, n_steps, JaxVPSDE())
    got = dpm_solver_pp_2m(teps, torch.from_numpy(x), 0.1, 1e-5, n_steps, VPSDE())
    assert_close(got, want, 1e-4, f"dpm_solver_pp_2m, {n_steps} steps")


@pytest.fixture(scope="module")
def ncsnpp():
    score = NCSNpp(**SMALL).eval()
    sd = seeded_normal_state_dict(score, 0)
    score.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jscore = JaxNCSNpp(**SMALL)
    return score, (lambda p, x, t: jscore.apply(p, x, t)), translate_ncsnpp(sd)


def test_purify_dpm_matches_jax(ncsnpp):
    score, jfn, jparams = ncsnpp
    x = np.random.default_rng(2).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(diffusion_type="dpm", t=20, n_steps=4, grad_mode="none")
    want = jax_purify_dpm(jfn, jparams, jnp.asarray(x), key, JaxPurifyConfig(**kw))
    with torch.inference_mode(), count_nfe() as c:
        got = purify(score, torch.from_numpy(x), JaxDPMNoise(key), PurifyConfig(**kw))
    assert_close(got, want, 1e-4, "purify_dpm")
    assert dict(c.counts) == {"dpm_solver_pp": 4}


def test_purify_dpm_stream_layout_matches_jax():
    """rand_t and two rounds: t* and the noise of round it come from
    streams 2*it and 2*it + 1, and each round purifies the last."""
    jeps, teps = _eps_models(3)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 4, 4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    kw = dict(diffusion_type="dpm", t=30, rand_t=True, t_delta=10, sample_step=2,
              n_steps=6, grad_mode="none")
    want = jax_purify_dpm(lambda p, xx, t: jeps(xx, t / 999.0), None, jnp.asarray(x), key,
                          JaxPurifyConfig(**kw))
    got = purify_dpm(lambda xx, t: teps(xx, t / 999.0), torch.from_numpy(x),
                     JaxDPMNoise(key), PurifyConfig(**kw))
    assert got.shape == (4, 4, 4, 3)
    assert_close(got, want, 1e-5, "purify_dpm, rand_t, 2 rounds")
    # an integer seed takes the two-stream layout
    s = SeededNoise(3, streams=2)
    a = purify_dpm(lambda xx, t: teps(xx, t / 999.0), torch.from_numpy(x), 3,
                   PurifyConfig(**kw))
    b = purify_dpm(lambda xx, t: teps(xx, t / 999.0), torch.from_numpy(x), s,
                   PurifyConfig(**kw))
    assert torch.equal(a, b)


def test_purify_dpm_gradient_matches_jax():
    """The input gradient through the checkpointed steps (a nonlinear
    epsilon model: the solver's adjoint, not the model's, is under test)."""
    jeps, teps = _eps_models(7)
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, 4, 4, 3)).astype(np.float32)
    w = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    kw = dict(diffusion_type="dpm", t=100, n_steps=5)
    want = jax.grad(lambda xx: jnp.sum(jnp.asarray(w) * jax_purify_dpm(
        lambda p, xi, t: jeps(xi, t / 999.0), None, xx, key,
        JaxPurifyConfig(**kw))))(jnp.asarray(x))

    model = lambda xi, t: teps(xi, t / 999.0)  # noqa: E731
    xt = torch.from_numpy(x).requires_grad_(True)
    with count_nfe() as c:
        out = purify(model, xt, JaxDPMNoise(key), PurifyConfig(**kw, grad_mode="checkpoint"))
        (got,) = torch.autograd.grad((torch.from_numpy(w) * out).sum(), xt)
    assert_close(got, want, 1e-4, "purify_dpm input gradient")
    assert dict(c.counts) == {"dpm_solver_pp": 5}  # the recomputation adds none

    none = purify(model, xt, JaxDPMNoise(key), PurifyConfig(**kw, grad_mode="none"))
    assert out.requires_grad and not none.requires_grad
    assert_close(none, out.detach(), 1e-6, "grad_mode none, same result")
