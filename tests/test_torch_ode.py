"""The port's other purifiers and gradient modes against diffpure_tpu's
(ROADMAP item 11), with the noise JAX draws injected into the port.

- ``odeint_euler`` / ``odeint_heun`` on a nonlinear drift (values and the
  NFE ledger), ``odeint_euler_adjoint``'s gradients (input and a
  parameter) against ``jax.vjp`` of JAX's custom_vjp, and
  ``sdeint_reversible_heun``'s forward and gradients against JAX's, with
  JAX's Brownian increments;
- ``purify_ode`` ('checkpoint', 'adjoint', 'reversible'), ``purify_ldsde``
  ('checkpoint', 'adjoint') and ``purify_sde(grad_mode='reversible')``
  through the small NCSN++ of tests/test_torch_grad.py, fp32, two steps:
  values at 1e-4, input gradients at 5e-4 of their largest entry;
- on a small nonlinear model: ``purify_ode`` with Heun's method and
  ``purify_ldsde`` under 'reversible' (JAX runs the checkpointed Euler
  path there), values and gradients; the noise layouts: the ODE runner's
  two streams a round (2*it + j), the LDSDE runner's Brownian stream
  fold_in(key, it);
- the VP marginal std, sqrt(-expm1(2 lmc)), against float64 and against
  JAX's float32 sqrt(1 - exp(2 lmc)) where that one does not cancel.
  Reversible Heun and Heun evaluate the score at the grid's end, t = 1e-5,
  where JAX's std is 0.6% off (ROADMAP Queue 3): on those paths JAX's
  runner is held to the port with the well-conditioned std in place of
  its own.

JAX's ``purify_ldsde(grad_mode='adjoint')`` cannot be differentiated with
respect to its input (its drift closes over the input inside the adjoint's
custom_vjp: UnexpectedTracerError, ROADMAP Queue 3); the port's adjoint
treats x_init as a constant, as the reference's torchsde adjoint does, and is
held against JAX's ``sdeint_em_adjoint`` with x_init fixed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.diffusion.sde import VPSDE as JaxVPSDE
from diffpure_tpu.diffusion.sde import batch_mul as jax_batch_mul
from diffpure_tpu.models.convert import translate_ncsnpp
from diffpure_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffpure_tpu.purify import PurifyConfig as JaxPurifyConfig
from diffpure_tpu.purify import runners as jrun
from diffpure_tpu.solvers import ode as jode
from diffpure_tpu.solvers.adjoint import odeint_euler_adjoint as jax_ode_adjoint
from diffpure_tpu.solvers.adjoint import sdeint_em_adjoint as jax_em_adjoint
from diffpure_tpu.solvers.em import brownian_increment as jax_brownian
from diffpure_tpu.solvers.reversible import sdeint_reversible_heun as jax_rev_heun
from diffpure_tpu_torch.diffusion.sde import VPSDE
from diffpure_tpu_torch.models import NCSNpp
from diffpure_tpu_torch.purify import PurifyConfig, SeededNoise, purify, purify_ldsde, \
    purify_ode
from diffpure_tpu_torch.solvers import odeint_euler, odeint_euler_adjoint, odeint_heun, \
    sdeint_reversible_heun
from diffpure_tpu_torch.solvers.em import brownian_increment
from diffpure_tpu_torch.solvers.reversible import last_reconstruction_error
from diffpure_tpu_torch.utils.prng import fold_in
from diffpure_tpu_torch.utils.profiling import count_nfe
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from test_torch_dpm import JaxDPMNoise
from test_torch_purify import JaxNoise
from torch_parity import assert_close, normal
from torch_parity import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

SMALL = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             image_size=16)
VALUE_REL, GRAD_REL = 1e-4, 5e-4


def _drifts(seed=0, d=12):
    """A nonlinear, time-dependent drift with a weight matrix W, in both
    packages: f(x, t) = tanh(x W) (1 + t) - x / 2."""
    W = np.random.default_rng(seed).standard_normal((d, d)).astype(np.float32) / np.float32(3)

    def jf(p, x, t):
        h = jnp.tanh(x.reshape(x.shape[0], -1) @ p) * (1.0 + t[:, None])
        return h.reshape(x.shape) - 0.5 * x

    def tf(w):
        def f(x, t):
            h = torch.tanh(x.reshape(x.shape[0], -1) @ w) * (1.0 + t[:, None])
            return h.reshape(x.shape) - 0.5 * x
        return f

    return W, jf, tf


@pytest.mark.parametrize("solver", ["euler", "heun"])
def test_ode_solvers_match_jax(solver):
    W, jf, tf = _drifts()
    x = normal(np.random.default_rng(1), 3, 2, 2, 3)
    jsolve = {"euler": jode.odeint_euler, "heun": jode.odeint_heun}[solver]
    want = jsolve(lambda xx, t: jf(jnp.asarray(W), xx, t), jnp.asarray(x), 0.1, 1e-5, 7)
    tsolve = {"euler": odeint_euler, "heun": odeint_heun}[solver]
    with count_nfe() as c:
        got = tsolve(tf(torch.from_numpy(W)), torch.from_numpy(x), 0.1, 1e-5, 7)
    assert_close(got, want, 1e-5, solver)
    assert dict(c.counts) == {f"ode_{solver}": 7 if solver == "euler" else 14}


def test_odeint_euler_adjoint_matches_jax_vjp():
    """Input and parameter cotangents of the Euler adjoint (rebuild
    x_i = x_{i+1} - f dt, one VJP at x_i) against jax.vjp of JAX's."""
    W, jf, tf = _drifts(2)
    rng = np.random.default_rng(3)
    x, ct = normal(rng, 2, 2, 2, 3), normal(rng, 2, 2, 2, 3)
    want_y, vjp = jax.vjp(lambda p, xx: jax_ode_adjoint(jf, p, xx, 0.3, 1e-5, 6),
                          jnp.asarray(W), jnp.asarray(x))
    want_gw, want_gx = vjp(jnp.asarray(ct))
    w = torch.from_numpy(W).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    with count_nfe() as c:
        y = odeint_euler_adjoint(tf(w), xt, 0.3, 1e-5, 6, params=(w,))
    gx, gw = torch.autograd.grad(y, (xt, w), torch.from_numpy(ct))
    assert dict(c.counts) == {"ode_euler_adjoint": 6}
    assert_close(y, want_y, 1e-5, "forward")
    assert_close(gx, want_gx, 1e-5, "d/dx0")
    assert_close(gw, want_gw, 1e-5, "d/dW")


@pytest.mark.parametrize("sigma", [0.0, 0.7])
def test_reversible_heun_matches_jax(sigma):
    """Forward and gradients (input and parameter) with JAX's Brownian
    increments; zero diffusion is the ODE case. The rebuilt start lands
    on x0 to float32 rounding."""
    W, jf, tf = _drifts(4)
    rng = np.random.default_rng(5)
    x, ct = normal(rng, 2, 2, 2, 3), normal(rng, 2, 2, 2, 3)
    key = jax.random.PRNGKey(7)
    t0, t1, n = 0.2, 1.0 - 1e-5, 5
    jdiff = lambda tb: sigma * (1.0 + tb)  # noqa: E731
    want_y, vjp = jax.vjp(lambda p, xx: jax_rev_heun(jf, jdiff, p, xx, t0, t1, n, key),
                          jnp.asarray(W), jnp.asarray(x))
    want_gw, want_gx = vjp(jnp.asarray(ct))
    dt32 = np.float32((np.float32(t1) - np.float32(t0)) / np.float32(n))
    dws = [torch.from_numpy(np.array(jax_brownian(key, i, x.shape, dt32))) for i in range(n)]
    w = torch.from_numpy(W).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    tdiff = lambda tb: sigma * (1.0 + tb)  # noqa: E731
    with count_nfe() as c:
        y = sdeint_reversible_heun(tf(w), tdiff, xt, t0, t1, n, dws.__getitem__, params=(w,))
    gx, gw = torch.autograd.grad(y, (xt, w), torch.from_numpy(ct))
    assert dict(c.counts) == {"sde_reversible_heun": n + 1}
    assert_close(y, want_y, 1e-5, "forward")
    assert_close(gx, want_gx, 1e-4, "d/dx0")
    assert_close(gw, want_gw, 1e-4, "d/dW")
    assert last_reconstruction_error() < 1e-5  # the backward rebuilt x0


@pytest.fixture(scope="module")
def score():
    model = NCSNpp(**SMALL).eval()
    sd = seeded_normal_state_dict(model, 0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.requires_grad_(False)
    jmodel = JaxNCSNpp(**SMALL)
    x = np.random.default_rng(8).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    w = normal(np.random.default_rng(9), 2, 16, 16, 3)
    return model, (lambda p, xx, t: jmodel.apply(p, xx, t)), translate_ncsnpp(sd), x, w


class JaxLDSDENoise:
    """The draws of diffpure_tpu's purify_ldsde for ``key``: round it's
    Brownian step i at fold_in(fold_in(key, it), i)."""

    def __init__(self, key):
        self.key = key

    def brownian(self, it, i, like, dt):
        dw = jax_brownian(jax.random.fold_in(self.key, it), i, tuple(like.shape), dt,
                          jnp.float32)
        return torch.from_numpy(np.array(dw))


# (runner, config, JAX runner, noise for the port); t* = 2: two ODE / SDE
# steps, two LDSDE steps at t = 20
CASES = {
    "ode/checkpoint": ("ode", dict(t=2), jrun.purify_ode, JaxDPMNoise),
    "ode/adjoint": ("ode", dict(t=2, grad_mode="adjoint"), jrun.purify_ode, JaxDPMNoise),
    "ode/reversible": ("ode", dict(t=2, grad_mode="reversible"), jrun.purify_ode,
                       JaxDPMNoise),
    "ldsde/checkpoint": ("ldsde", dict(t=20), jrun.purify_ldsde, JaxLDSDENoise),
    "sde/reversible": ("sde", dict(t=2, grad_mode="reversible"), jrun.purify_sde, JaxNoise),
}


# the paths whose solver evaluates the score at the grid's end, t = 1e-5
AT_THE_END = {"ode/reversible", "sde/reversible", "ode/heun"}


def _jax_std_well_conditioned(monkeypatch):
    """JAX's VPSDE with the port's std, sqrt(-expm1(2 lmc))."""
    def marginal_prob(self, x, t):
        lmc = self.log_mean_coeff(t)
        return (jax_batch_mul(jnp.exp(lmc), x),
                jnp.sqrt(jnp.maximum(-jnp.expm1(2.0 * lmc), 0.0)))

    monkeypatch.setattr(JaxVPSDE, "marginal_prob", marginal_prob)


def test_vp_std_is_well_conditioned():
    """The port's std within 2e-7 of float64's over t in [1e-5, 1]
    (JAX's float32 form is 0.6% off at t = 1e-5), within 5e-7 of JAX's
    where JAX's does not cancel (t >= 0.1), and the mean JAX's."""
    t = np.concatenate([np.geomspace(1e-5, 1, 2000), np.linspace(1e-5, 1, 2000)])
    t = t.astype(np.float32)
    mean, std = (v.numpy() for v in VPSDE().marginal_prob(torch.ones(len(t)),
                                                          torch.from_numpy(t)))
    jmean, jstd = (np.asarray(v) for v in JaxVPSDE().marginal_prob(jnp.ones(len(t)),
                                                                   jnp.asarray(t)))
    t64 = t.astype(np.float64)
    exact = np.sqrt(-np.expm1(2 * (-0.25 * t64 ** 2 * 19.9 - 0.5 * t64 * 0.1)))
    assert float(np.max(np.abs(std - exact) / exact)) < 2e-7
    assert abs(float(jstd[0]) / exact[0] - 1) > 5e-3  # the cancellation this avoids
    far = t >= 0.1
    assert float(np.max(np.abs(std - jstd)[far] / exact[far])) < 5e-7
    np.testing.assert_allclose(mean, jmean, rtol=1e-6)


def _value_and_grad_match(jfn, jparams, tmodel, x, w, case, kind, kw, jrunner, Noise, key):
    """purify(x) and d/dx sum(w * purify(x)), same noise (JAX's side
    jitted: its compile is most of the test's time either way)."""
    cfg = dict(diffusion_type=kind, **kw)

    @jax.jit
    def value_and_grad(xx, ww):
        y, jvjp = jax.vjp(lambda z: jrunner(jfn, jparams, z, key, JaxPurifyConfig(**cfg)), xx)
        return y, jvjp(ww)[0]

    want, want_g = value_and_grad(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = purify(tmodel, xt, Noise(key), PurifyConfig(**cfg))
    (got_g,) = torch.autograd.grad((torch.from_numpy(w) * got).sum(), xt)
    assert_close(got, want, VALUE_REL, f"{case} purified")
    assert_close(got_g, want_g, GRAD_REL, f"{case} input gradient")


@pytest.mark.parametrize("case", list(CASES))
def test_purifier_and_its_gradient_match_jax(score, case, monkeypatch):
    model, jfn, jparams, x, w = score
    if case in AT_THE_END:
        _jax_std_well_conditioned(monkeypatch)
    _value_and_grad_match(jfn, jparams, model, x, w, case, *CASES[case],
                          jax.random.PRNGKey(11))


SMALL_CASES = {
    "ode/heun": ("ode", dict(t=4, ode_method="heun"), jrun.purify_ode, JaxDPMNoise),
    "ldsde/reversible": ("ldsde", dict(t=30, grad_mode="reversible"), jrun.purify_ldsde,
                         JaxLDSDENoise),
}


@pytest.mark.parametrize("case", list(SMALL_CASES))
def test_small_model_paths_match_jax(case, monkeypatch):
    if case in AT_THE_END:
        _jax_std_well_conditioned(monkeypatch)
    W, jf, tf = _drifts(12, d=12)
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, (2, 2, 2, 3)).astype(np.float32)
    w = normal(rng, 2, 2, 2, 3)
    jmodel = lambda p, xx, t: jf(jnp.asarray(W), xx, t / 999.0)  # noqa: E731
    tmodel = lambda xx, t: tf(torch.from_numpy(W))(xx, t / 999.0)  # noqa: E731
    _value_and_grad_match(jmodel, None, tmodel, x, w, case, *SMALL_CASES[case],
                          jax.random.PRNGKey(19))


def test_ldsde_adjoint_matches_jax_with_x_init_fixed(score):
    """The LDSDE adjoint's input gradient: JAX's sdeint_em_adjoint over the
    runner's drift with x_init a constant (the reference's torchsde
    adjoint), and the same forward as the checkpointed runner."""
    model, jfn, jparams, x, w = score
    key = jax.random.PRNGKey(13)
    cfg = PurifyConfig(diffusion_type="ldsde", t=20, grad_mode="adjoint")
    jcfg = JaxPurifyConfig(diffusion_type="ldsde", t=20)
    score_fn, _ = jrun._make_score_fn(jfn, jparams, jcfg)
    x_init = jnp.asarray(x)

    def drift(p, xx, t_unused):
        t = jnp.full((xx.shape[0],), cfg.ldsde_t, xx.dtype)
        return -0.5 * cfg.lambda_ld * (-score_fn(xx, t) + (xx - x_init) / cfg.sigma2)

    def diffusion(t):
        return jnp.full_like(t, np.sqrt(cfg.lambda_ld) * cfg.eta)

    t0, t1 = 1.0 - 20 / 1000.0, 1.0 - 1e-5
    n = max(int(round((t1 - t0) / cfg.ldsde_dt)), 1)
    assert n == 2

    @jax.jit
    def value_and_grad(xx, ww):
        y, vjp = jax.vjp(lambda z: jax_em_adjoint(drift, diffusion, None, z, t0, t1, n,
                                                  jax.random.fold_in(key, 0)), xx)
        return y, vjp(ww)[0]

    want, want_g = value_and_grad(x_init, jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    with count_nfe() as c:
        got = purify_ldsde(model, xt, JaxLDSDENoise(key), cfg)
    (got_g,) = torch.autograd.grad((torch.from_numpy(w) * got).sum(), xt)
    assert dict(c.counts) == {"sde_euler_adjoint": 2}
    assert_close(got, want, VALUE_REL, "ldsde adjoint purified")
    assert_close(got_g, want_g, GRAD_REL, "ldsde adjoint input gradient")


def test_noise_layouts_and_rounds():
    """Two rounds with rand_t: the ODE runner's t* and forward noise from
    streams 2*it and 2*it + 1; the LDSDE runner's increments from stream
    it; an integer seed takes each layout (SeededNoise(streams=1 / 2))."""
    W, jf, tf = _drifts(6, d=12)
    x = np.random.default_rng(10).uniform(-1, 1, (2, 2, 2, 3)).astype(np.float32)
    key = jax.random.PRNGKey(17)
    jmodel = lambda p, xx, t: jf(jnp.asarray(W), xx, t / 999.0)  # noqa: E731
    tmodel = lambda xx, t: tf(torch.from_numpy(W))(xx, t / 999.0)  # noqa: E731
    for kind, noise, kw in (("ode", JaxDPMNoise, dict(t=30, rand_t=True, t_delta=10)),
                            ("ldsde", JaxLDSDENoise, dict(t=40))):
        cfg = dict(diffusion_type=kind, sample_step=2, grad_mode="none", **kw)
        want = jrun.purify(jmodel, None, jnp.asarray(x), key, JaxPurifyConfig(**cfg))
        got = purify(tmodel, torch.from_numpy(x), noise(key), PurifyConfig(**cfg))
        assert got.shape == (4, 2, 2, 3)
        assert_close(got, want, 1e-5, f"{kind}, 2 rounds")
        a = purify(tmodel, torch.from_numpy(x), 3, PurifyConfig(**cfg))
        b = purify(tmodel, torch.from_numpy(x), SeededNoise(3, {"ode": 2, "ldsde": 1}[kind]),
                   PurifyConfig(**cfg))
        assert torch.equal(a, b)
    s = SeededNoise(5, streams=1)
    like = torch.zeros(2, 3)
    assert torch.equal(s.brownian(1, 4, like, 0.01),
                       brownian_increment(fold_in(5, 1), 4, like, 0.01))
    with pytest.raises(ValueError, match="no Brownian stream"):
        SeededNoise(5, streams=2).brownian(0, 0, like, 0.01)


def test_grad_mode_none_and_the_nfe_ledger(score):
    """'none' detaches in each runner; the ledger records each solver once
    a round (JAX's names)."""
    model, *_ = score
    x = torch.zeros(1, 16, 16, 3, requires_grad=True)
    want = {("ode", "none"): {"ode_euler": 4}, ("ode", "adjoint"): {"ode_euler_adjoint": 4},
            ("ode", "reversible"): {"sde_reversible_heun": 5},
            ("ldsde", "none"): {"sde_euler": 3}, ("sde", "reversible"): {"sde_reversible_heun": 5}}
    for (kind, mode), counts in want.items():
        cfg = PurifyConfig(diffusion_type=kind, t=30 if kind == "ldsde" else 4, grad_mode=mode)
        with count_nfe() as c:
            out = purify(model, x, 0, cfg)
        assert dict(c.counts) == counts, (kind, mode)
        assert out.requires_grad == (mode != "none")
    with pytest.raises(ValueError, match="Euler-only"):
        purify(model, x, 0, PurifyConfig(diffusion_type="ode", t=4, grad_mode="adjoint",
                                         ode_method="heun"))
