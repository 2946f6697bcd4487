"""The ImageNet-256 defence's pieces in the port against diffpure_tpu: the
torchvision ResNets with the [0, 1] normalisation shim, their weight
carrier, DefendedModel's 224 -> 256 resize, and the guided-diffusion
purify_sde on a small ADM with the noise JAX draws injected, forward and
its input gradient in both grad modes (through the 256-px routes' autograd
Functions, as jax.grad goes through their custom_vjps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.classifiers import registry as jreg
from diffpure_tpu.classifiers.convert import translate_torchvision_resnet
from diffpure_tpu.eval.defended import DefendedModel as JaxDefended
from diffpure_tpu.models import adm_unet as jadm
from diffpure_tpu.purify import PurifyConfig as JaxPurifyConfig
from diffpure_tpu.purify.runners import purify_sde as jax_purify_sde
from diffpure_tpu_torch.classifiers import get_classifier
from diffpure_tpu_torch.classifiers.common import IMAGENET_MEAN, IMAGENET_STD, normalize
from diffpure_tpu_torch.classifiers.convert import torchvision_resnet_state_dict_from_flax
from diffpure_tpu_torch.classifiers.resnet import resnet50
from diffpure_tpu_torch.eval import DefendedModel
from diffpure_tpu_torch.eval.defended import bilinear_resize
from diffpure_tpu_torch.models import ADMUNet, adm_unet
from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops import halo_conv as halo
from diffpure_tpu_torch.ops import tiled_groupnorm as tgn
from diffpure_tpu_torch.purify import PurifyConfig, purify_sde
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from test_torch_adm import SMALL, _seeded
from test_torch_convert import _flax_zeros, _round_trip, _shapes
from test_torch_purify import JaxNoise
from torch_parity import assert_close, normal

GUIDED = dict(score_type="guided_diffusion", grad_mode="none")


def _seeded_classifier(name, seed):
    model = get_classifier(name).eval()
    sd = seeded_normal_state_dict(model, seed)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model, translate_torchvision_resnet(sd)


@pytest.mark.parametrize("name", ["imagenet-resnet50", "imagenet-resnet18"])
def test_imagenet_resnet_with_shim_matches_jax(name):
    model, params = _seeded_classifier(name, 0)
    x01 = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    _, _, logits_fn = jreg.get_classifier(name)
    want = logits_fn(params, jnp.asarray(x01))
    with torch.inference_mode():
        got = model(torch.from_numpy(x01))
    assert got.shape == (2, 1000)
    assert_close(got, want, 1e-4, name)


def test_normalisation_shim():
    x = torch.rand(2, 4, 4, 3)
    want = (x - torch.tensor(IMAGENET_MEAN)) / torch.tensor(IMAGENET_STD)
    torch.testing.assert_close(normalize(x, IMAGENET_MEAN, IMAGENET_STD), want)
    assert get_classifier("imagenet-resnet50").input_norm == (IMAGENET_MEAN, IMAGENET_STD)


def test_torchvision_resnet_carrier_both_ways():
    _round_trip(resnet50(), translate_torchvision_resnet,
                torchvision_resnet_state_dict_from_flax)
    flax = _flax_zeros(jreg.resnet50(), (1, 32, 32, 3))
    sd = torchvision_resnet_state_dict_from_flax(flax)
    assert _shapes(sd) == _shapes(resnet50().state_dict())
    assert "layer1.0.downsample.0.weight" in sd and "fc.weight" in sd


def test_resize_224_to_256_matches_jax_image_resize():
    x01 = np.random.default_rng(2).uniform(size=(2, 224, 224, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x01), (2, 256, 256, 3), "bilinear")
    assert_close(bilinear_resize(torch.from_numpy(x01), 256), want, 1e-6, "224 -> 256")
    seen = []
    dm = DefendedModel(lambda x, t: seen.append(tuple(x.shape)) or torch.zeros_like(x),
                       lambda x: x, PurifyConfig(t=1, grad_mode="none"), log_every=0,
                       resize_to=256)
    assert tuple(dm.purify(torch.from_numpy(x01), 0).shape) == (2, 256, 256, 3)
    assert seen == [(2, 256, 256, 3)]
    dm.purify(torch.zeros(1, 256, 256, 3), 0)  # already at size: no resize
    assert seen[-1] == (1, 256, 256, 3)


@pytest.fixture(scope="module")
def small_adm():
    return _seeded(ADMUNet(**SMALL), 4)


def test_guided_purify_sde_matches_jax(small_adm):
    model, params = small_adm
    x = normal(np.random.default_rng(3), 2, 32, 32, 3, scale=0.5)
    key = jax.random.PRNGKey(11)
    jm = jadm.ADMUNet(**SMALL)
    want = jax_purify_sde(lambda p, xx, t: jm.apply(p, xx, t), params, jnp.asarray(x), key,
                          JaxPurifyConfig(t=3, **GUIDED))
    with torch.inference_mode():
        got = purify_sde(model, torch.from_numpy(x), JaxNoise(key), PurifyConfig(t=3, **GUIDED))
    assert_close(got, want, 1e-4, "guided purify_sde")


# fp32 input gradients after 2 steps through the small ADM, both packages
# on the CPU: the forward agrees to ~1e-6 relative per evaluation, the
# backward repeats that in another summation order.
ADM_GRAD_REL = 2e-4


@pytest.mark.parametrize("grad_mode", ["checkpoint", "adjoint"])
def test_guided_purify_sde_input_grad_matches_jax(small_adm, grad_mode):
    """d/dx sum(w * purify_sde(x)) with the guided score, weights frozen.
    The port runs every ADM block on the halo or tiled route (maps of >= 64
    KiB), so its gradient goes through those routes' autograd Functions;
    JAX runs its plain route, the same function (its custom_vjp backwards
    are autodiff of the same plain versions, held Function by Function in
    test_torch_kernel_grads.py), whose interpret-mode kernels under
    jax.grad would take a minute to compile here."""
    model, params = small_adm
    rng = np.random.default_rng(7)
    x, w = normal(rng, 1, 32, 32, 3, scale=0.5), normal(rng, 1, 32, 32, 3)
    key = jax.random.PRNGKey(13)
    jm = jadm.ADMUNet(**SMALL)
    cfg = dict(t=2, score_type="guided_diffusion", grad_mode=grad_mode)
    want = jax.grad(lambda xx: jnp.sum(jnp.asarray(w) * jax_purify_sde(
        lambda p, a, t: jm.apply(p, a, t), params, xx, key, JaxPurifyConfig(**cfg))))(
        jnp.asarray(x))
    model.requires_grad_(False)
    calls = []
    fwd = _cuda.KernelFunction.forward
    adm_unet.set_tiled_gn_min_bytes(64 * 1024)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(_cuda.KernelFunction, "forward", staticmethod(
                lambda ctx, fns, cfg_, *t: calls.append(fns) or fwd(ctx, fns, cfg_, *t)))
            xt = torch.from_numpy(x).requires_grad_(True)
            out = purify_sde(model, xt, JaxNoise(key), PurifyConfig(**cfg))
            (got,) = torch.autograd.grad((torch.from_numpy(w) * out).sum(), xt)
    finally:
        adm_unet.set_tiled_gn_min_bytes(None)
    assert {halo._BLOCK, tgn._GNFS} <= set(calls)
    assert_close(got, want, ADM_GRAD_REL, f"guided d purify / dx, {grad_mode}")


def test_integer_steps_truncate_t_times_n_in_float32():
    """At t*=150 the model is fed (t * N) formed and truncated in float32 on
    each Euler step, exactly the steps JAX feeds."""
    x = np.zeros((1, 4, 4, 3), np.float32)
    cfg = dict(t=150, learn_sigma=False, **GUIDED)
    jax_steps, port_steps = [], []

    def jax_model(p, xx, t):
        jax.debug.callback(lambda s: jax_steps.append(int(np.asarray(s)[0])), t, ordered=True)
        return xx * 0.0

    def port_model(xx, t):
        assert t.dtype == torch.int32
        port_steps.append(int(t[0]))
        return xx * 0.0

    key = jax.random.PRNGKey(0)
    jax.block_until_ready(jax_purify_sde(jax_model, None, jnp.asarray(x), key,
                                         JaxPurifyConfig(**cfg)))
    with torch.inference_mode():
        purify_sde(port_model, torch.from_numpy(x), JaxNoise(key), PurifyConfig(**cfg))
    assert len(port_steps) == 150 and port_steps == jax_steps
    # float64 arithmetic, or rounding, would feed 150 where float32 feeds 149
    t0, dt = 1 - 0.15, ((1 - 1e-5) - (1 - 0.15)) / 150
    f64 = [int((1 - (t0 + i * dt)) * 1000) for i in range(150)]
    rounded = [round((1 - (t0 + i * dt)) * 1000) for i in range(150)]
    assert port_steps[0] == 149 and f64[0] == rounded[0] == 150


def test_defended_imagenet_forward_matches_jax(small_adm):
    """DefendedModel with resize_to (24 -> 32 here), guided-diffusion
    purification at t*=2 and an ImageNet ResNet-18 with its shim."""
    model, params = small_adm
    clf, cparams = _seeded_classifier("imagenet-resnet18", 5)
    x01 = np.random.default_rng(6).uniform(size=(2, 24, 24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jm = jadm.ADMUNet(**SMALL)
    _, _, logits_fn = jreg.get_classifier("imagenet-resnet18")
    jdm = JaxDefended(lambda p, xx, t: jm.apply(p, xx, t), params, logits_fn, cparams,
                      JaxPurifyConfig(t=2, **GUIDED), resize_to=32, log_every=0)
    want = jdm(jnp.asarray(x01), key)
    dm = DefendedModel(model, clf, PurifyConfig(t=2, **GUIDED), log_every=0, resize_to=32)
    with torch.inference_mode():
        got = dm(torch.from_numpy(x01), JaxNoise(key))
    assert got.shape == (2, 1000)
    assert_close(got, want, 1e-4, "defended logits")


@pytest.mark.parametrize("name, n_params", [
    ("imagenet-resnet18", 11_689_512), ("imagenet-resnet50", 25_557_032),
    ("imagenet-resnet101", 44_549_160), ("imagenet-wideresnet-50-2", 68_883_240)])
def test_registry_resnets_have_torchvision_sizes(name, n_params):
    """torchvision's parameter counts, which its checkpoints carry."""
    with torch.device("meta"):
        model = get_classifier(name)
    assert sum(p.numel() for p in model.parameters()) == n_params
