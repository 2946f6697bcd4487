"""The port's discrete diffusion and its guided DDPM / DDIM purifier
against diffpure_tpu's (item 15), with the draws JAX makes injected: round
it's forward noise from fold_in(key, 2*it), step i's from the i-th split
of fold_in(key, 2*it + 1).

Tolerances: the schedules and the float64 tables exactly; one step's
tensors (p_mean_variance, p_sample, ddim_sample, the losses) 1e-5 of the
largest value; whole runners 1e-4; a bf16 model output 0.5%.

- every schedule, ``space_timesteps`` and the ``ddim50`` map;
- every table of ``GaussianDiffusion``; ``p_mean_variance`` for every mean
  and variance type; ``p_sample``, ``ddim_sample`` (eta 0 and 0.5),
  ``ddim_reverse_sample``, guidance (``condition_mean`` /
  ``condition_score``), ``p_sample_loop``, ``training_losses``; the
  respaced process's float timesteps;
- the ADM at a float timestep;
- ``purify_guided_ddpm`` through a small ADM: ancestral, DDIM, on the
  ddim50 respacing, two rounds; its checkpointed input gradient against
  ``jax.grad``; ``grad_mode='none'`` detaches; the NFE ledger.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffpure_tpu.diffusion.discrete as jdisc
import diffpure_tpu.diffusion.schedules as jsched
from diffpure_tpu.models import adm_unet as jadm
from diffpure_tpu.models.convert import translate_adm
from diffpure_tpu.purify import PurifyConfig as JaxPurifyConfig
from diffpure_tpu.purify.runners import make_imagenet_diffusion as jax_make_diffusion
from diffpure_tpu.purify.runners import purify_guided_ddpm as jax_guided
from diffpure_tpu_torch.diffusion import discrete as disc
from diffpure_tpu_torch.diffusion import schedules as sched
from diffpure_tpu_torch.models import ADMUNet
from diffpure_tpu_torch.purify import DiscreteNoise, PurifyConfig, make_imagenet_diffusion, \
    purify, purify_guided_ddpm
from diffpure_tpu_torch.utils.profiling import count_nfe
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from torch_parity import assert_close, np32

REL = 1e-5
RUNNER_REL = 1e-4
BF16_REL = 5e-3


class JaxDiscreteNoise:
    """The draws of diffpure_tpu's discrete runners for ``key``."""

    def __init__(self, key):
        self.key = key

    def forward_eps(self, it, shape, like):
        e = jax.random.normal(jax.random.fold_in(self.key, 2 * it), shape, jnp.float32)
        return torch.from_numpy(np.array(e)).to(like.dtype)

    def step_eps(self, it, i, like):
        k = jax.random.fold_in(self.key, 2 * it + 1)
        for _ in range(i + 1):
            k, sub = jax.random.split(k)
        return torch.from_numpy(np.array(jax.random.normal(sub, like.shape, jnp.float32))
                                ).to(like.dtype)


def test_schedules_match_jax_exactly():
    for n in (10, 1000):
        np.testing.assert_array_equal(sched.linear_beta_schedule(n), jsched.linear_beta_schedule(n))
        np.testing.assert_array_equal(sched.scaled_linear_beta_schedule(n),
                                      jsched.scaled_linear_beta_schedule(n))
        np.testing.assert_array_equal(sched.cosine_beta_schedule(n),
                                      jsched.cosine_beta_schedule(n))
        np.testing.assert_array_equal(sched.vp_discrete_betas(N=n), jsched.vp_discrete_betas(N=n))
        for name in ("linear", "cosine"):
            np.testing.assert_array_equal(sched.get_named_beta_schedule(name, n),
                                          jsched.get_named_beta_schedule(name, n))
    assert sched.linear_beta_schedule(5).dtype == np.float64
    for spec in ("ddim50", "ddim25", "10", "10,20,30", [5, 7]):
        assert sched.space_timesteps(1000, spec) == jsched.space_timesteps(1000, spec)
    with pytest.raises(ValueError):
        sched.space_timesteps(1000, "ddim333")
    with pytest.raises(NotImplementedError):
        sched.get_named_beta_schedule("sqrt", 10)


def _processes():
    betas = jsched.get_named_beta_schedule("linear", 40)
    out = []
    for mean in disc.ModelMeanType:
        for var in disc.ModelVarType:
            kw = dict(rescale_timesteps=True)
            out.append((
                disc.GaussianDiffusion(betas, model_mean_type=mean, model_var_type=var,
                                       **kw),
                jdisc.GaussianDiffusion.from_betas(
                    betas, model_mean_type=jdisc.ModelMeanType[mean.name],
                    model_var_type=jdisc.ModelVarType[var.name], **kw)))
    return out


TABLES = ("alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
          "sqrt_recipm1_alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
          "posterior_mean_coef1", "posterior_mean_coef2")


def test_tables_are_jax_s_float64():
    got, want = _processes()[0]
    assert got.num_timesteps == want.num_timesteps == 40
    for name in TABLES:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w, err_msg=name)
    t = torch.tensor([0, 7, 39])
    ext = disc._extract(got.sqrt_recipm1_alphas_cumprod, t, (3, 2, 2, 1))
    assert ext.dtype == torch.float32 and tuple(ext.shape) == (3, 1, 1, 1)
    np.testing.assert_array_equal(np32(ext), np.asarray(jdisc._extract(
        want.sqrt_recipm1_alphas_cumprod, jnp.asarray(t.numpy()), (3, 2, 2, 1))))


def _linear_models(channels, seed=0, H=4):
    """A nonlinear, time-dependent model of ``channels`` outputs per pixel."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((3, channels)) / np.sqrt(3)).astype(np.float32)
    jW, tW = jnp.asarray(W), torch.from_numpy(W)

    def jm(x, t):
        return jnp.tanh(x @ jW) * (1.0 + 0.001 * t.astype(jnp.float32))[:, None, None, None]

    def tm(x, t):
        return torch.tanh(x @ tW.to(x.dtype)) * (1.0 + 0.001 * t.float())[:, None, None, None]
    return jm, tm


def _state(seed=1, N=3, H=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, H, 3)).astype(np.float32)
    t = np.array([0, 17, 39][:N], np.int32)
    z = rng.standard_normal((N, H, H, 3)).astype(np.float32)
    return x, t, z


@pytest.mark.parametrize("clip", [True, False])
def test_p_mean_variance_every_type_matches_jax(clip):
    x, t, _ = _state()
    for got, want in _processes():
        learned = got.model_var_type in (disc.ModelVarType.LEARNED, disc.ModelVarType.LEARNED_RANGE)
        jm, tm = _linear_models(6 if learned else 3)
        g = got.p_mean_variance(tm, torch.from_numpy(x), torch.from_numpy(t), clip_denoised=clip)
        w = want.p_mean_variance(jm, jnp.asarray(x), jnp.asarray(t), clip_denoised=clip)
        for k in ("mean", "variance", "log_variance", "pred_xstart"):
            what = f"{got.model_mean_type.name}/{got.model_var_type.name} {k}"
            if k == "pred_xstart" and got.model_mean_type == disc.ModelMeanType.PREVIOUS_X:
                # x0 = xprev / coef1 - x_t coef2 / coef1: two terms up to ~1e3
                # that cancel; the error is a fraction of the terms, not of x0
                terms = max(np.abs(np32(jdisc._extract(1.0 / want.posterior_mean_coef1,
                                                       jnp.asarray(t), x.shape))).max(),
                            1.0) * np.abs(np32(w["mean"])).max()
                err = np.abs(np32(g[k]) - np32(w[k])).max()
                assert err <= REL * terms, f"{what}: {err:.3g} > {REL * terms:.3g}"
                continue
            assert_close(g[k].expand(w[k].shape), w[k], REL, what)


def test_learned_range_with_a_bf16_output_promotes_as_jax():
    x, t, _ = _state()
    got, want = [p for p in _processes()
                 if p[0].model_var_type == disc.ModelVarType.LEARNED_RANGE
                 and p[0].model_mean_type == disc.ModelMeanType.EPSILON][0]
    jm, tm = _linear_models(6)
    g = got.p_mean_variance(lambda xx, tt: tm(xx, tt).to(torch.bfloat16),
                            torch.from_numpy(x), torch.from_numpy(t))
    w = want.p_mean_variance(lambda xx, tt: jm(xx, tt).astype(jnp.bfloat16),
                             jnp.asarray(x), jnp.asarray(t))
    for k in ("mean", "log_variance", "pred_xstart"):
        assert g[k].dtype == torch.float32 and w[k].dtype == jnp.float32, k
        assert_close(g[k], w[k], BF16_REL, f"bf16 output {k}")


def _guidance():
    rng = np.random.default_rng(5)
    G = (rng.standard_normal((3, 3)) * 0.1).astype(np.float32)
    jG, tG = jnp.asarray(G), torch.from_numpy(G)
    return (lambda x, t: jnp.sin(x @ jG)), (lambda x, t: torch.sin(x @ tG))


@pytest.mark.parametrize("guided", [False, True])
def test_samplers_match_jax(guided):
    x, t, z = _state()
    jcond, tcond = _guidance() if guided else (None, None)
    for got, want in _processes():
        if got.model_mean_type != disc.ModelMeanType.EPSILON:
            continue
        learned = got.model_var_type in (disc.ModelVarType.LEARNED, disc.ModelVarType.LEARNED_RANGE)
        jm, tm = _linear_models(6 if learned else 3)
        key = jax.random.PRNGKey(3)
        jz = torch.from_numpy(np.array(jax.random.normal(key, x.shape)))
        tx, tt = torch.from_numpy(x), torch.from_numpy(t)
        g = got.p_sample(tm, tx, tt, cond_fn=tcond, noise=jz)
        w = want.p_sample(key, jm, jnp.asarray(x), jnp.asarray(t), cond_fn=jcond)
        assert_close(g["sample"], w["sample"], REL, f"p_sample {got.model_var_type.name}")
        for eta in (0.0, 0.5):
            g = got.ddim_sample(tm, tx, tt, cond_fn=tcond, eta=eta, noise=jz)
            w = want.ddim_sample(key, jm, jnp.asarray(x), jnp.asarray(t), cond_fn=jcond, eta=eta)
            assert_close(g["sample"], w["sample"], REL, f"ddim eta {eta}")
            assert_close(g["pred_xstart"], w["pred_xstart"], REL, "ddim pred_xstart")
        g = got.ddim_reverse_sample(tm, tx, tt)
        w = want.ddim_reverse_sample(jm, jnp.asarray(x), jnp.asarray(t))
        assert_close(g["sample"], w["sample"], REL, "ddim_reverse_sample")
    # the t == 0 example takes no noise
    g0 = got.p_sample(tm, tx, tt, noise=jz)["sample"]
    g1 = got.p_sample(tm, tx, tt, noise=jz * 0)["sample"]
    assert torch.equal(g0[0], g1[0]) and not torch.equal(g0[1], g1[1])


def test_p_sample_loop_matches_jax():
    betas = jsched.get_named_beta_schedule("linear", 100)
    got = disc.GaussianDiffusion(betas)
    want = jdisc.GaussianDiffusion.from_betas(betas)
    jm, tm = _linear_models(3)
    x, _, _ = _state(N=2)
    key = jax.random.PRNGKey(4)

    def step_noise(i, like):  # p_sample_loop splits its key once a step
        k = key
        for _ in range(i + 1):
            k, sub = jax.random.split(k)
        return torch.from_numpy(np.array(jax.random.normal(sub, like.shape)))

    w = want.p_sample_loop(key, jm, x.shape, noise=jnp.asarray(x), from_t=7)
    g = got.p_sample_loop(tm, x.shape, torch.from_numpy(x), step_noise, from_t=7)
    assert_close(g, w, RUNNER_REL, "p_sample_loop")


def test_training_losses_match_jax():
    x, t, z = _state()
    for got, want in _processes():
        learned = got.model_var_type in (disc.ModelVarType.LEARNED, disc.ModelVarType.LEARNED_RANGE)
        jm, tm = _linear_models(6 if learned else 3)
        g = got.training_losses(tm, torch.from_numpy(x), torch.from_numpy(t),
                                noise=torch.from_numpy(z))
        w = want.training_losses(jax.random.PRNGKey(0), jm, jnp.asarray(x), jnp.asarray(t),
                                 noise=jnp.asarray(z))
        assert set(g) == set(w)
        # the decoder term at t = 0 (a learned variance) scales the rounding
        # of its mean (the model output itself, for PREVIOUS_X and START_X)
        # by 1 / std, up to 1 / sqrt(beta_0)
        amp = 1.0 / np.sqrt(got.betas[0]) if learned else 1.0
        for k in g:
            assert_close(g[k], w[k], REL * amp, f"{got.model_mean_type.name}/"
                         f"{got.model_var_type.name} {k}")


def test_ddim50_respacing_and_float_timesteps():
    got, want = make_imagenet_diffusion("ddim50"), jax_make_diffusion("ddim50")
    assert got.timestep_map == want.timestep_map and len(got.timestep_map) == 50
    assert got.original_num_steps == 1000 and got.num_timesteps == 50
    np.testing.assert_array_equal(np.asarray(got.betas), np.asarray(want.betas))
    seen = {}

    def tm(x, t):
        seen["t"] = t
        return torch.zeros(x.shape[:3] + (6,))

    x, _, _ = _state(N=2)
    got.p_mean_variance(tm, torch.from_numpy(x), torch.tensor([49, 3]))
    assert seen["t"].dtype == torch.float32
    np.testing.assert_array_equal(seen["t"].numpy(), np.float32([980.0, 60.0]))
    full = make_imagenet_diffusion()
    full.p_mean_variance(tm, torch.from_numpy(x), torch.tensor([149, 0]))
    assert seen["t"].dtype == torch.float32 and seen["t"].tolist() == [149.0, 0.0]


SMALL_ADM = dict(image_size=16, model_channels=32, out_channels=6, num_res_blocks=1,
                 attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4,
                 num_head_channels=32, use_scale_shift_norm=True, resblock_updown=True)


@pytest.fixture(scope="module")
def adm():
    model = ADMUNet(**SMALL_ADM).eval().requires_grad_(False)
    sd = seeded_normal_state_dict(model, 4)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jmodel = jadm.ADMUNet(**SMALL_ADM)
    params = translate_adm(sd)
    return model, (lambda p, x, t: jmodel.apply(p, x, t)), params


def test_adm_at_a_float_timestep_matches_jax(adm):
    model, japply, params = adm
    x, _, _ = _state(N=2, H=16)
    t = np.float32([37.5, 980.0])
    want = jax.jit(japply)(params, jnp.asarray(x), jnp.asarray(t))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    assert_close(got, want, REL * 10, "ADM at float t")


# (cfg.t, respacing, use_ddim, sample_step)
RUNS = {"ancestral": (3, None, False, 1), "ddim": (3, None, True, 1),
        "ddim50": (2, "ddim50", True, 1), "two_rounds": (2, None, False, 2)}


@pytest.mark.parametrize("run", list(RUNS))
def test_purify_guided_ddpm_matches_jax(adm, run):
    model, japply, params = adm
    t_star, respacing, ddim, rounds = RUNS[run]
    x, _, _ = _state(N=2, H=16)
    x = np.clip(x * 0.4, -1, 1)
    key = jax.random.PRNGKey(11)
    kw = dict(t=t_star, sample_step=rounds, grad_mode="none")
    jdiff = jax_make_diffusion(respacing) if respacing else None
    want = jax.jit(lambda p, xx: jax_guided(japply, p, xx, key, JaxPurifyConfig(**kw),
                                            diffusion=jdiff, use_ddim=ddim))(params, jnp.asarray(x))
    diff = make_imagenet_diffusion(respacing) if respacing else None
    with count_nfe() as nfe:
        got = purify(model, torch.from_numpy(x), JaxDiscreteNoise(key),
                     PurifyConfig(diffusion_type="ddpm", **kw), diffusion=diff, use_ddim=ddim)
    assert got.shape == (2 * rounds, 16, 16, 3) and not got.requires_grad
    assert nfe.counts == {"guided_ddpm": t_star * rounds}
    assert_close(got, want, RUNNER_REL, f"purify_guided_ddpm {run}")


def test_purify_guided_ddpm_gradient_matches_jax(adm):
    model, japply, params = adm
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.8, 0.8, (1, 16, 16, 3)).astype(np.float32)
    ct = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    cfg = dict(t=2, grad_mode="checkpoint")

    def jloss(xx):
        return jnp.sum(jax_guided(japply, params, xx, key, JaxPurifyConfig(**cfg)) * ct)
    want = jax.jit(jax.grad(jloss))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = purify_guided_ddpm(model, tx, JaxDiscreteNoise(key), PurifyConfig(**cfg))
    (got,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), tx)
    assert_close(got, want, 5e-4, "guided DDPM input gradient")
    # 'none' detaches: no graph back to the input
    out = purify_guided_ddpm(model, tx, DiscreteNoise(0),
                             PurifyConfig(t=2, grad_mode="none"))
    assert not out.requires_grad and out.grad_fn is None


def test_discrete_noise_layout():
    like = torch.zeros(2, 4, 4, 3)
    a, b = DiscreteNoise(5), DiscreteNoise(5)
    assert torch.equal(a.forward_eps(1, like.shape, like), b.forward_eps(1, like.shape, like))
    assert torch.equal(a.step_eps(0, 3, like), b.step_eps(0, 3, like))
    assert not torch.equal(a.step_eps(0, 3, like), a.step_eps(0, 4, like))
    assert not torch.equal(a.forward_eps(0, like.shape, like), a.forward_eps(1, like.shape, like))
