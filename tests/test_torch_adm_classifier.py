"""guided-diffusion's guidance classifier and upsampler in the port
(``EncoderUNetADM`` with its three pools, ``AttentionPool2d``,
``SuperResADM``) against diffpure_tpu/models/adm_unet.py on the same
seeded weights, the factories against diffpure_tpu/models/factories.py,
the converter, the classifier's input gradient against ``jax.grad``, one
classifier-guided ancestral and DDIM step with JAX's draws injected, and
the full-width models' sizes and 256-px route census.

Tolerances: fp32 1e-4 of the largest value; bf16 0.5% (the upsampler, an
ADM UNet, by the UNet's bf16 rule of test_torch_adm.py). The 256-px routes
are on in both packages (``tiled_routes``, thresholds lowered so that the
64-px maps reach them); JAX's kernels run in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import adm_route_census, census_launches
from diffpure_tpu.models import adm_unet as jadm
from diffpure_tpu.models import factories as jfac
from diffpure_tpu.models.convert import translate_adm
from diffpure_tpu_torch.diffusion import discrete as disc
from diffpure_tpu_torch.models import adm_unet, factories
from diffpure_tpu_torch.models.adm_unet import AttentionPool2d, EncoderUNetADM, \
    SuperResADM
from diffpure_tpu_torch.models.convert import adm_state_dict_from_flax
from diffpure_tpu_torch.ops.resize import bilinear_resize
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from test_torch_adm import BF16_DRIFT_RATIO, BF16_MODEL_REL, tiled_routes
from test_torch_convert import _flax_zeros, _shapes
from torch_parity import DTYPES, assert_close, normal, np32, two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

REL = {"float32": 1e-4, "bfloat16": 5e-3}
CLASSIFIER_PARAMS = 54_096_360   # create_classifier(**classifier_defaults()) at 256 px
UPSAMPLER_PARAMS = 311_027_910   # sr_create_model(256, 64, ...) at guided-diffusion's width
UPSAMPLER_FLAGS = dict(num_channels=192, num_heads=4, num_res_blocks=2,
                       attention_resolutions="32,16,8", use_scale_shift_norm=True,
                       resblock_updown=True, learn_sigma=True, use_fp16=True)
SMALL_CLS = dict(image_size=32, model_channels=32, out_channels=10, num_res_blocks=1,
                 attention_resolutions=(4,), channel_mult=(1, 2, 2), num_head_channels=16)
SMALL_SR = dict(image_size=16, in_channels=6, model_channels=32, out_channels=6,
                num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                num_heads=2, num_head_channels=-1, use_scale_shift_norm=True,
                resblock_updown=True)
# the 256-px routes at levels 0 (32^2 x 32: 128 KiB) and 1 (16^2 x 64: 64 KiB)
MIN_BYTES = 64 * 1024


def to_flax(sd: dict, pool: str = "attention") -> dict:
    """The port's state dict -> flax params: ``translate_adm`` and, for the
    classifier's head, what it does not map (the attention pool's (C, T)
    position embedding -> (T, C); the adaptive pool's ``out.3`` -> flax's
    ``out_2``)."""
    sd = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}
    pes = {k: sd.pop(k) for k in list(sd) if k.endswith("positional_embedding")}
    if pool == "adaptive":
        sd = {k.replace("out.3.", "out.2."): v for k, v in sd.items()}
    params = translate_adm(sd)
    for k, pe in pes.items():  # the pool alone, or the classifier's out.2
        node = params["params"] if k == "positional_embedding" else params["params"]["out_2"]
        node["positional_embedding"] = pe.T
    return params


def seeded(module, seed, pool="attention"):
    sd = seeded_normal_state_dict(module, seed)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return module.eval(), to_flax(sd, pool)


def test_attention_pool_matches_jax():
    pool, params = seeded(AttentionPool2d(4, 64, 16, 10), 0)
    x = normal(np.random.default_rng(1), 2, 4, 4, 64)
    want = jadm.AttentionPool2d(spacial_dim=4, embed_dim=64, num_heads_channels=16,
                                output_dim=10).apply(params, jnp.asarray(x))
    with torch.inference_mode():
        got = pool(torch.from_numpy(x))
    assert_close(got, want, REL["float32"], "AttentionPool2d")


# the pools run in x's dtype (fp32) after the torso: bf16 is held on the
# two whose casts differ (the attention pool's single cast, the spatial
# pool's cast of each stage)
CASES = [("adaptive", "float32"), ("attention", "float32"), ("attention", "bfloat16"),
         ("spatial", "float32"), ("spatial", "bfloat16")]


@pytest.fixture(scope="module")
def encoders():
    """pool -> (port model, flax params, input, timesteps, JAX's logits by
    dtype)."""
    out = {}
    rng = np.random.default_rng(3)
    x, t = normal(rng, 2, 32, 32, 3), np.array([999, 13], np.int32)
    for i, pool in enumerate(("adaptive", "attention", "spatial")):
        model, params = seeded(EncoderUNetADM(**SMALL_CLS, pool=pool), 10 + i, pool)
        with tiled_routes(None if pool == "adaptive" else MIN_BYTES):
            want = {d: jax.jit(lambda p, xx, tt, pool=pool, jd=DTYPES[d][0]: jadm.EncoderUNetADM(
                **SMALL_CLS, pool=pool, dtype=jd).apply(p, xx, tt))(
                params, jnp.asarray(x), jnp.asarray(t)) for p_, d in CASES if p_ == pool}
        out[pool] = (model, params, x, t, want)
    return out


@pytest.mark.parametrize("pool,dtype", CASES)
def test_encoder_matches_jax(encoders, route_spy, pool, dtype):
    model, _, x, t, want = encoders[pool]
    model.dtype = DTYPES[dtype][1]
    tiled = pool != "adaptive"
    with tiled_routes(MIN_BYTES if tiled else None), torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    # the torso's routes (the adaptive pool's run is plain): level 0's residual
    # block on the halo route (two stages); the down block's input GN at
    # 32^2, level 1's second GN and its down block's input GN at 16^2 x 64
    # on the tiled one
    assert (route_spy["halo"], route_spy["tiled"]) == ((2, 3) if tiled else (0, 0))
    assert_close(got, want[dtype], REL[dtype], f"EncoderUNetADM {pool} {dtype}")


@pytest.fixture
def route_spy(monkeypatch):
    calls = {"halo": 0, "tiled": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(adm_unet, "gn_silu_conv_block", spy("halo", adm_unet.gn_silu_conv_block))
    monkeypatch.setattr(adm_unet, "group_norm_film_silu",
                        spy("tiled", adm_unet.group_norm_film_silu))
    return calls


def test_bilinear_resize_64_to_256_matches_jax():
    x = np.random.default_rng(4).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 256, 256, 3), "bilinear")
    assert_close(bilinear_resize(torch.from_numpy(x), 256), want, 1e-6, "64 -> 256")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_superres_matches_jax(dtype):
    model, params = seeded(SuperResADM(**SMALL_SR), 20)
    rng = np.random.default_rng(5)
    x, low, t = normal(rng, 1, 16, 16, 3), normal(rng, 1, 4, 4, 3), np.array([400], np.int32)
    want = {d: jax.jit(lambda p, a, b, c, jd=DTYPES[d][0]: jadm.SuperResADM(
        **SMALL_SR, dtype=jd).apply(p, a, c, low_res=b))(
        params, jnp.asarray(x), jnp.asarray(low), jnp.asarray(t)) for d in {"float32", dtype}}
    model.dtype = DTYPES[dtype][1]
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(t), low_res=torch.from_numpy(low))
    assert got.shape == (1, 16, 16, 6)
    if dtype == "float32":
        assert_close(got, want[dtype], REL[dtype], "SuperResADM fp32")
        return
    # the UNet's bf16 rule (test_torch_adm.py): the two bf16 runs within
    # BF16_MODEL_REL, the port's within BF16_DRIFT_RATIO x JAX's own drift
    # from fp32 (here 1.7e-2, 2.1e-2 and 2.0e-2 apart)
    assert_close(got, want[dtype], BF16_MODEL_REL, "SuperResADM bf16")
    ref = np32(want["float32"])
    assert np.abs(np32(got) - ref).max() <= BF16_DRIFT_RATIO * np.abs(
        np32(want[dtype]) - ref).max()


@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial"])
def test_converter_carries_classifier_weights(encoders, pool):
    """flax params -> adm_state_dict_from_flax: the port's keys and shapes
    exactly (strict load), the same tensors; and JAX's own tree of the
    classifier maps onto the port's."""
    model, params, *_ = encoders[pool]
    sd = adm_state_dict_from_flax(params)
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    flax = _flax_zeros(jadm.EncoderUNetADM(**SMALL_CLS, pool=pool), (1, 32, 32, 3), (1,))
    assert _shapes(adm_state_dict_from_flax(flax)) == _shapes(model.state_dict())


def test_converter_carries_upsampler_weights():
    flax = _flax_zeros(jadm.SuperResADM(**SMALL_SR), (1, 16, 16, 3), (1,), (1, 4, 4, 3))
    assert _shapes(adm_state_dict_from_flax(flax)) == _shapes(SuperResADM(**SMALL_SR).state_dict())


def _log_p(logits, y):
    return logits.log_softmax(-1).gather(-1, y[:, None])[:, 0]


@pytest.fixture(scope="module")
def small_classifier(encoders):
    return encoders["attention"][:2]


def test_classifier_input_gradient_matches_jax(small_classifier):
    """d/dx sum log p(y | x, t) through the tiled routes, fp32."""
    model, params = small_classifier
    model.dtype = None
    rng = np.random.default_rng(6)
    x, t, y = normal(rng, 2, 32, 32, 3), np.array([500, 20], np.int32), np.array([3, 7])

    def f(xx):
        logits = jadm.EncoderUNetADM(**SMALL_CLS, pool="attention").apply(params, xx,
                                                                           jnp.asarray(t))
        return jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(y)[:, None],
                                   -1).sum()

    with tiled_routes(MIN_BYTES):
        want = jax.jit(jax.grad(f))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        (got,) = torch.autograd.grad(_log_p(model(xt, torch.from_numpy(t)),
                                            torch.from_numpy(y)).sum(), xt)
    assert_close(got, want, 5e-4, "classifier input gradient")


def test_guided_steps_match_jax(small_classifier):
    """One p_sample and one DDIM step on a 1000-step process with the
    learned range, guided by the classifier (cond_fn = scale * d log p / dx
    at the model's timesteps), with a small ADM as the model and JAX's
    draws injected; the blocks on their plain route (the tiled ones'
    gradient is the test above's)."""
    model, params = small_classifier
    model.dtype = None
    adm_cfg = dict(image_size=32, model_channels=32, out_channels=6, num_res_blocks=1,
                   attention_resolutions=(4,), channel_mult=(1, 2, 2), num_heads=2,
                   num_head_channels=-1, use_scale_shift_norm=True, resblock_updown=True)
    adm, adm_params = seeded(adm_unet.ADMUNet(**adm_cfg), 30)
    got_d = factories.create_gaussian_diffusion(steps=1000, learn_sigma=True,
                                                rescale_timesteps=True)
    want_d = jfac.create_gaussian_diffusion(steps=1000, learn_sigma=True, rescale_timesteps=True)
    rng = np.random.default_rng(7)
    x, y = normal(rng, 2, 32, 32, 3), np.array([1, 4])
    t = np.array([600, 3], np.int32)
    key = jax.random.PRNGKey(8)
    scale = 2.0
    jm = lambda xx, tt: jadm.ADMUNet(**adm_cfg).apply(adm_params, xx, tt)  # noqa: E731

    def jcond(xx, tt):
        def f(v):
            logits = jadm.EncoderUNetADM(**SMALL_CLS, pool="attention").apply(params, v, tt)
            return jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(y)[:, None],
                                       -1).sum()
        return jax.grad(f)(xx) * scale

    def tcond(xx, tt):
        xi = xx.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(_log_p(model(xi, tt), torch.from_numpy(y)).sum(), xi)
        return g * scale

    tm = lambda xx, tt: adm(xx, tt)  # noqa: E731
    z = torch.from_numpy(np.array(jax.random.normal(key, x.shape)))
    want = jax.jit(lambda xx, tt: (
        want_d.p_sample(key, jm, xx, tt, cond_fn=jcond)["sample"],
        want_d.ddim_sample(key, jm, xx, tt, cond_fn=jcond)["sample"]))(jnp.asarray(x),
                                                                         jnp.asarray(t))
    with torch.no_grad():
        got = [step(tm, torch.from_numpy(x), torch.from_numpy(t), cond_fn=tcond,
                    noise=z)["sample"] for step in (got_d.p_sample, got_d.ddim_sample)]
    for what, g, w in zip(("p_sample", "ddim_sample"), got, want):
        assert_close(g, w, 1e-4, f"guided {what}")


def test_guidance_on_a_respaced_process_sees_the_model_timesteps():
    """On a respaced process cond_fn gets the timesteps the model gets (the
    original steps, rescaled), as guided-diffusion's respace.py wraps it;
    JAX's SpacedDiffusion hands it the respaced indices. The step equals
    JAX's given a cond_fn that maps the indices itself."""
    got_d = factories.create_gaussian_diffusion(steps=1000, learn_sigma=True,
                                                rescale_timesteps=True,
                                                timestep_respacing="ddim50")
    want_d = jfac.create_gaussian_diffusion(steps=1000, learn_sigma=True,
                                            rescale_timesteps=True, timestep_respacing="ddim50")
    seen = {}
    rng = np.random.default_rng(9)
    x, t = normal(rng, 2, 4, 4, 3), np.array([30, 2], np.int32)
    W = normal(rng, 3, 6, fan_in=3)

    def tm(xx, tt):
        seen["model"] = tt
        return torch.tanh(xx @ torch.from_numpy(W)) * (1 + 1e-3 * tt)[:, None, None, None]

    def tcond(xx, tt):
        seen["cond"] = tt
        return torch.sin(xx) * (1 + 1e-3 * tt)[:, None, None, None]

    tmap = jnp.asarray(want_d.timestep_map, jnp.float32) * (1000.0 / 1000)

    def jm(xx, tt):
        return jnp.tanh(xx @ jnp.asarray(W)) * (1 + 1e-3 * tt)[:, None, None, None]

    def jcond(xx, tt):  # JAX hands the respaced index: map it as the model's wrapper does
        return jnp.sin(xx) * (1 + 1e-3 * tmap[tt])[:, None, None, None]

    g = got_d.ddim_sample(tm, torch.from_numpy(x), torch.from_numpy(t), cond_fn=tcond,
                          noise=torch.zeros(x.shape))
    assert torch.equal(seen["cond"], seen["model"])
    assert seen["cond"].tolist() == [float(got_d.timestep_map[i]) for i in t]
    w = want_d.ddim_sample(jax.random.PRNGKey(0), jm, jnp.asarray(x), jnp.asarray(t),
                           cond_fn=jcond)
    assert_close(g["sample"], w["sample"], 1e-5, "respaced guided DDIM")
    w = want_d.p_sample(jax.random.PRNGKey(0), jm, jnp.asarray(x), jnp.asarray(t),
                        cond_fn=jcond)
    g = got_d.p_sample(tm, torch.from_numpy(x), torch.from_numpy(t), cond_fn=tcond,
                       noise=torch.from_numpy(np.array(jax.random.normal(
                           jax.random.PRNGKey(0), x.shape))))
    assert_close(g["sample"], w["sample"], 1e-5, "respaced guided p_sample")


def _count(model):
    return sum(p.numel() for p in model.parameters())


def _jax_count(model, *shapes, **kw):
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), *(jnp.zeros(s) for s in shapes),
                          **kw)
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree))


def test_full_width_models_and_census():
    """The classifier of ``classifier_defaults()`` at 256 px and the 64 ->
    256 upsampler at guided-diffusion's width: JAX's parameter counts, and
    the 256-px routes of one evaluation walked on the meta device. bf16's
    halo kernel takes cout % 128 == 0: the upsampler's 192-channel stages
    take the tiled route in bf16."""
    with torch.device("meta"):
        cls = factories.create_classifier(**dict(factories.classifier_defaults(),
                                                 image_size=256))
        sr = factories.sr_create_model(256, 64, **UPSAMPLER_FLAGS)
    assert _count(cls) == CLASSIFIER_PARAMS == _jax_count(
        jfac.create_classifier(**dict(jfac.classifier_defaults(), image_size=256)),
        (1, 256, 256, 3), (1,))
    assert _count(sr) == UPSAMPLER_PARAMS == _jax_count(
        jfac.sr_create_model(256, 64, **UPSAMPLER_FLAGS), (1, 256, 256, 3), (1,),
        low_res=jnp.zeros((1, 64, 64, 3)))
    assert sr.dtype == torch.bfloat16 and cls.dtype is None
    assert not any(getattr(b, "use_flash", False) for m in (cls, sr) for b in m.modules())

    census = {}
    for dtype in (None, torch.bfloat16):
        cls.dtype = dtype
        census[dtype] = adm_route_census(torch, cls, (2, 256, 256, 3))
    assert census[None] == census[torch.bfloat16]
    c = census[None]
    # levels 0-1 (256^2 and 128^2 x 128) and level 2 (64^2 x 256, with the
    # 128 -> 256 block's projected skip): halo; the down blocks tiled
    assert c[("halo", (2, 256, 256, 128), 128, False)] == 4
    assert c[("halo", (2, 128, 128, 128), 128, False)] == 4
    assert c[("halo", (2, 64, 64, 256), 256, True)] == 1
    assert census_launches(c) == {"group_stats": 17, "gn_film_silu_apply": 5,
                                  "gn_silu_conv3x3_halo": 12, "flash_attention": 0}
    low = torch.empty(1, 64, 64, 3, device="meta")
    sr_bf16 = adm_route_census(torch, sr, (1, 256, 256, 3), low_res=low)
    assert census_launches(sr_bf16) == {"group_stats": 44, "gn_film_silu_apply": 34,
                                        "gn_silu_conv3x3_halo": 10, "flash_attention": 0}
    assert all(k[2] % 128 == 0 for k in sr_bf16 if k[0] == "halo")
    sr.dtype = None
    sr_f32 = adm_route_census(torch, sr, (1, 256, 256, 3), low_res=low)
    assert census_launches(sr_f32) == {
        "group_stats": 44, "gn_film_silu_apply": 14, "gn_silu_conv3x3_halo": 30,
        "flash_attention": 0}


def test_factories_mirror_jax():
    """create_gaussian_diffusion's tables and types for each variance
    choice; the *_and_diffusion factories' models and processes."""
    for kw in (dict(), dict(learn_sigma=True), dict(sigma_small=True),
               dict(predict_xstart=True, noise_schedule="cosine", steps=100,
                    timestep_respacing="10,20")):
        got, want = factories.create_gaussian_diffusion(**kw), jfac.create_gaussian_diffusion(**kw)
        assert np.array_equal(got.betas, np.asarray(want.betas))
        assert got.timestep_map == tuple(want.timestep_map)
        assert got.model_var_type.name == want.model_var_type.name
        assert got.model_mean_type.name == want.model_mean_type.name
    with torch.device("meta"):
        cls, d = factories.create_classifier_and_diffusion(image_size=64, diffusion_steps=50,
                                                           learn_sigma=True)
        sr, d2 = factories.sr_create_model_and_diffusion(dict(num_channels=64, large_size=64,
                                                              timestep_respacing="25"))
        adm, d3 = factories.create_model_and_diffusion(dict(image_size=64, num_channels=64,
                                                            use_fp16=True))
    assert isinstance(cls, EncoderUNetADM) and d.num_timesteps == 50
    assert isinstance(sr, SuperResADM) and d2.num_timesteps == 25
    assert isinstance(adm, adm_unet.ADMUNet) and adm.dtype == torch.bfloat16
    assert d3.model_var_type == disc.ModelVarType.FIXED_LARGE
    jcls, _ = jfac.create_classifier_and_diffusion(image_size=64)
    assert _count(cls) == _jax_count(jcls, (1, 64, 64, 3), (1,))
    d = factories.sr_model_and_diffusion_defaults()
    assert "image_size" not in d and (d["large_size"], d["small_size"]) == (256, 64)
    assert d == jfac.sr_model_and_diffusion_defaults()
    assert factories.classifier_defaults() == jfac.classifier_defaults()
    with pytest.raises(ValueError):
        factories.sr_create_model(128, 32)
