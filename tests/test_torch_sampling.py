"""The port's SDE methods, reverse SDE and PC / ODE samplers
(diffpure_tpu_torch/diffusion/{sde,sampling}.py) against diffpure_tpu's on
the same inputs, with JAX's draws injected: torch cannot reproduce
threefry, so each JAX key's normal draw is made on the JAX side and handed
to the port by its place in the sampler's stream layout (prior; step i's
corrector draw j; step i's predictor draw). The score is a smooth analytic
function of (x, t), the same on both sides. The JAX side is jitted where
it scans (the correctors, the samplers); a single elementwise step runs
eagerly, which costs a fraction of its compile.
Tolerance: fp32 1e-4 of the largest reference value (the samplers' time
grid is JAX's to an ulp of T), one step 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.diffusion import sampling as jsampling
from diffpure_tpu.diffusion import sde as jsde
from diffpure_tpu_torch.diffusion import sampling
from diffpure_tpu_torch.diffusion import sde as tsde
from torch_parity import REL, assert_close, normal

SHAPE = (2, 4, 4, 3)
STEP_REL = 1e-5
T_VEC = np.array([1e-4, 0.55], np.float32)  # t = 1e-4: index 0 at N = 1000


def _sdes(n=1000):
    return {"vp": (jsde.VPSDE(N=n), tsde.VPSDE(N=n)),
            "subvp": (jsde.SubVPSDE(N=n), tsde.SubVPSDE(N=n)),
            "ve": (jsde.VESDE(N=n), tsde.VESDE(N=n))}


def jscore(x, t):
    return -0.5 * x * (1.0 + t)[:, None, None, None] + 0.1 * jnp.sin(3.0 * x)


def tscore(x, t):
    return -0.5 * x * (1.0 + t)[:, None, None, None] + 0.1 * torch.sin(3.0 * x)


def _x(seed=0, scale=1.0):
    return normal(np.random.default_rng(seed), *SHAPE, scale=scale)


def _normals(key, n):
    """JAX's corrector draws: (k, sub) = split(k) per step, normal(sub)."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, SHAPE, jnp.float32)))
    return out


def _drawer(draws):
    it = iter(draws)
    return lambda: torch.from_numpy(next(it))


class JaxPCNoise:
    """The draws of JAX's get_pc_sampler / get_ode_sampler under ``key``,
    by place: the prior from the first split, at step i ``k, k1, k2 =
    split(k, 3)``, the corrector's j-th draw from k1's j-th split, the
    predictor's from k2 (``steps`` of them: the ODE sampler draws the
    prior only)."""

    def __init__(self, key, jax_sde, n_steps_each, steps=None):
        key, sub = jax.random.split(key)
        self._prior = np.asarray(jax_sde.prior_sampling(sub, SHAPE))
        self.corr, self.pred = {}, {}
        k = key
        for i in range(jax_sde.N if steps is None else steps):
            k, k1, k2 = jax.random.split(k, 3)
            for j, z in enumerate(_normals(k1, n_steps_each)):
                self.corr[i, j] = z
            self.pred[i] = np.asarray(jax.random.normal(k2, SHAPE, jnp.float32))

    def prior(self, sde, shape, device):
        return torch.from_numpy(self._prior).to(device)

    def corrector(self, i, j, like):
        return torch.from_numpy(self.corr[i, j])

    def predictor(self, i, like):
        return torch.from_numpy(self.pred[i])


# --- the SDE methods and the reverse SDE -------------------------------------

@pytest.mark.parametrize("kind", ["vp", "subvp", "ve"])
def test_sde_methods_match_jax(kind):
    jd, td = _sdes()[kind]
    x, t = _x(1), T_VEC
    f, G = jd.discretize(jnp.asarray(x), jnp.asarray(t))
    tf, tG = td.discretize(torch.from_numpy(x), torch.from_numpy(t))
    assert_close(tf, f, STEP_REL, f"{kind} discretize f")
    assert_close(tG, G, STEP_REL, f"{kind} discretize G")
    for got, want, what in zip(td.marginal_coeffs(torch.from_numpy(t)),
                               jd.marginal_coeffs(jnp.asarray(t)), ("mean", "std")):
        assert_close(torch.as_tensor(got).expand(2), jnp.broadcast_to(want, (2,)), STEP_REL,
                     f"{kind} marginal_coeffs {what}")
    z = _x(2, scale=3.0)
    assert_close(td.prior_logp(torch.from_numpy(z)), jd.prior_logp(jnp.asarray(z)), 1e-6,
                 f"{kind} prior_logp")


@pytest.mark.parametrize("kind", ["vp", "subvp", "ve"])
def test_prior_sampling_scale(kind):
    _, td = _sdes()[kind]
    g = torch.Generator().manual_seed(0)
    x = td.prior_sampling((4096, 8), generator=g)
    want = td.sigma_max if kind == "ve" else 1.0
    assert x.shape == (4096, 8)
    assert abs(float(x.std()) / want - 1.0) < 0.03 and abs(float(x.mean())) < 0.03 * want


@pytest.mark.parametrize("kind", ["vp", "subvp", "ve"])
@pytest.mark.parametrize("probability_flow", [False, True])
def test_reverse_sde_matches_jax(kind, probability_flow):
    jd, td = _sdes()[kind]
    x, t = _x(3), T_VEC
    want = jd.reverse(jscore, probability_flow).sde(jnp.asarray(x), jnp.asarray(t))
    rev = td.reverse(tscore, probability_flow)
    got = rev.sde(torch.from_numpy(x), torch.from_numpy(t))
    assert rev.T == 1.0
    assert_close(got[0], want[0], STEP_REL, f"{kind} reverse drift")
    assert_close(got[1], want[1], STEP_REL, f"{kind} reverse diffusion")


# --- one predictor or corrector step ------------------------------------------

PREDICTOR_CASES = [(p, k, pf) for p in ("euler_maruyama", "reverse_diffusion")
                   for k in ("vp", "subvp", "ve") for pf in (False, True)] + \
    [("ancestral_sampling", k, False) for k in ("vp", "ve")] + \
    [("none", k, False) for k in ("vp", "ve")]


@pytest.mark.parametrize("name,kind,probability_flow", PREDICTOR_CASES)
def test_predictor_step_matches_jax(name, kind, probability_flow):
    jd, td = _sdes()[kind]
    x, t = _x(4, scale=2.0), T_VEC
    key = jax.random.PRNGKey(11)
    jpred = jsampling.get_predictor(name)
    want = jpred(key, jd, jscore, jnp.asarray(x), jnp.asarray(t),
                 probability_flow=probability_flow)
    z = np.asarray(jax.random.normal(key, SHAPE, jnp.float32))
    got = sampling.get_predictor(name)(_drawer([z]), td, tscore, torch.from_numpy(x),
                                       torch.from_numpy(t), probability_flow=probability_flow)
    for g, w, what in zip(got, want, ("x", "x_mean")):
        assert_close(g, w, STEP_REL, f"{name} on {kind} (pf={probability_flow}): {what}")


def test_ancestral_sampling_refuses_subvp():
    _, td = _sdes()["subvp"]
    with pytest.raises(NotImplementedError):
        sampling.get_predictor("ancestral_sampling")(
            lambda: torch.zeros(SHAPE), td, tscore, torch.zeros(SHAPE),
            torch.from_numpy(T_VEC))


@pytest.mark.parametrize("name", ["langevin", "ald", "none"])
@pytest.mark.parametrize("kind", ["vp", "subvp", "ve"])
def test_corrector_steps_match_jax(name, kind):
    jd, td = _sdes()[kind]
    x, t, snr, n = _x(5, scale=2.0), T_VEC, 0.16, 3
    key = jax.random.PRNGKey(12)
    jcorr = jsampling.get_corrector(name)
    want = jax.jit(lambda k, x, t: jcorr(k, jd, jscore, x, t, snr, n))(
        key, jnp.asarray(x), jnp.asarray(t))
    got = sampling.get_corrector(name)(_drawer(_normals(key, n)), td, tscore,
                                       torch.from_numpy(x), torch.from_numpy(t), snr, n)
    for g, w, what in zip(got, want, ("x", "x_mean")):
        assert_close(g, w, 2 * STEP_REL, f"{name} on {kind}: {what}")


# --- the time grid ------------------------------------------------------------

@pytest.mark.parametrize("n", [1000, 232, 20])
def test_pc_time_grid_indices_match_jax(n):
    """The PC loop's float32 grid and its truncated indices, the VP and VE
    tables' row at every step."""
    eps = 1e-3
    want_t = np.asarray(jnp.linspace(1.0, eps, n))
    got_t = sampling.pc_timesteps(tsde.VESDE(N=n), eps)
    assert got_t.dtype == np.float32 and len(got_t) == n
    # XLA's fused arithmetic: within an ulp of T (the grid's largest value)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=np.spacing(np.float32(1.0)))
    want_i = np.asarray(jax.jit(lambda t: (t * (n - 1) / 1.0).astype(jnp.int32))(
        jnp.linspace(1.0, eps, n)))
    got_i = tsde._timestep(tsde.VESDE(N=n), torch.from_numpy(got_t)).numpy()
    np.testing.assert_array_equal(got_i, want_i)
    assert got_i[0] == n - 1 and got_i[-1] == 0


# --- the samplers --------------------------------------------------------------

PC_CASES = [("vp", "euler_maruyama", "none", 1, True),
            ("vp", "euler_maruyama", "langevin", 1, False),
            ("vp", "ancestral_sampling", "ald", 2, True),
            ("subvp", "reverse_diffusion", "langevin", 2, True),
            ("ve", "reverse_diffusion", "langevin", 1, True),
            ("ve", "reverse_diffusion", "langevin", 1, False),
            ("ve", "ancestral_sampling", "none", 1, True),
            ("ve", "none", "ald", 2, False)]


@pytest.mark.parametrize("kind,predictor,corrector,n_each,denoise", PC_CASES)
def test_pc_sampler_matches_jax(kind, predictor, corrector, n_each, denoise):
    # the VP's discrete betas reach beta_max / N: N = 40 keeps them below 1
    n = 40 if kind == "vp" else 12
    jd, td = _sdes(n=n)[kind]
    kw = dict(predictor=predictor, corrector=corrector, snr=0.16, n_steps_each=n_each,
              denoise=denoise)
    key = jax.random.PRNGKey(21)
    want, want_nfe = jax.jit(lambda k: jsampling.get_pc_sampler(jd, SHAPE, **kw)(k, jscore))(
        key)
    got, nfe = sampling.get_pc_sampler(td, SHAPE, device="cpu", **kw)(
        tscore, noise=JaxPCNoise(key, jd, n_each))
    assert nfe == int(want_nfe) == n * (n_each + 1)
    assert_close(got, want, REL["float32"], f"PC {kind} {predictor}+{corrector}")


@pytest.mark.parametrize("kind", ["vp", "ve"])
@pytest.mark.parametrize("denoise", [False, True])
def test_ode_sampler_matches_jax(kind, denoise):
    jd, td = _sdes(n=1000)[kind]
    key = jax.random.PRNGKey(22)
    want, want_n = jax.jit(lambda k: jsampling.get_ode_sampler(
        jd, SHAPE, denoise=denoise, n_steps=15)(k, jscore))(key)
    got, n = sampling.get_ode_sampler(td, SHAPE, denoise=denoise, n_steps=15, device="cpu")(
        tscore, noise=JaxPCNoise(key, jd, 0, steps=0))
    assert n == int(want_n) == 15
    assert_close(got, want, REL["float32"], f"ODE {kind} denoise={denoise}")


def test_pc_noise_stream_is_one_generator_in_loop_order():
    """PCNoise draws the prior, then each step's corrector and predictor
    draws, from the one generator, in that order; a sampler run twice from
    equal generators gives equal samples."""
    td = tsde.VESDE(N=3)
    seen = []

    def score(x, t):
        seen.append(float(t[0]))
        return -x

    kw = dict(predictor="reverse_diffusion", corrector="langevin", n_steps_each=2,
              device="cpu")
    a, nfe = sampling.get_pc_sampler(td, SHAPE, **kw)(score, torch.Generator().manual_seed(5))
    b, _ = sampling.get_pc_sampler(td, SHAPE, **kw)(score, torch.Generator().manual_seed(5))
    assert nfe == 9 and torch.equal(a, b)
    g = torch.Generator().manual_seed(5)
    prior = td.prior_sampling(SHAPE, generator=g)
    draws = [torch.randn(SHAPE, generator=g) for _ in range(9)]
    order = []

    class Recorder:
        def prior(self, sde, shape, device):
            return prior

        def corrector(self, i, j, like):
            order.append(("c", i, j))
            return draws[len(order) - 1]

        def predictor(self, i, like):
            order.append(("p", i))
            return draws[len(order) - 1]

    c, _ = sampling.get_pc_sampler(td, SHAPE, **kw)(score, noise=Recorder())
    assert torch.equal(a, c)
    assert order == [("c", 0, 0), ("c", 0, 1), ("p", 0), ("c", 1, 0), ("c", 1, 1), ("p", 1),
                     ("c", 2, 0), ("c", 2, 1), ("p", 2)]
    assert seen[:3] == [1.0, 1.0, 1.0] and len(seen) == 27
