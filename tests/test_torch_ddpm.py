"""The DDPM++ residual block, the up/down layers, the score_sde DDPM, NCSN++
with ``resblock_type='ddpm'`` and a purification through the DDPM, in the
port (plain versions on the CPU) against diffpure_tpu on the same seeded
weights. fp32: 1e-5 of max |ref| for one layer, 1e-4 for a model.

bf16: the port and JAX round at other places (JAX's SiLU and bias adds
round separately), and at this depth either bf16 NCSN++ lands about 1%
from the fp32 model (0.8-1.2% for JAX, 0.6-1.0% for the port, over three
weight seeds). So the port's bf16 model is held within 2e-2 of JAX's bf16
one and, what matters, no farther from JAX's fp32 model than JAX's own
bf16 model is, with a quarter of margin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.models import layers as jl
from diffpure_tpu.models.convert import translate_ncsnpp
from diffpure_tpu.models.ddpm_v1 import DDPM as JaxDDPM
from diffpure_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffpure_tpu.purify import PurifyConfig as JaxPurifyConfig
from diffpure_tpu.purify.runners import purify_sde as jax_purify_sde
from diffpure_tpu_torch.models import DDPM, DDPMUNet, NCSNpp
from diffpure_tpu_torch.models import layers
from diffpure_tpu_torch.models.convert import ddpm_state_dict_from_flax, \
    ncsnpp_state_dict_from_flax
from diffpure_tpu_torch.models.registry import create_model, get_model_cls
from diffpure_tpu_torch.purify import PurifyConfig, purify_sde
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from test_torch_purify import JaxNoise
from torch_parity import DTYPES, assert_close, ddpm_census, normal, np32, to_torch

LAYER, MODEL = 1e-5, 1e-4
SMALL = dict(nf=32, ch_mult=(1, 2), image_size=16, attn_resolutions=(8,))
LABELS = np.array([99.9, 700.0], np.float32)


def _load(module, seed):
    sd = seeded_normal_state_dict(module, seed)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return module.eval(), sd


def _flax(sd):
    """The port's state dict as the flax params of all_modules.0."""
    return translate_ncsnpp({f"all_modules.0.{k}": v for k, v in sd.items()})["params"]["m0"]


# (in, out, conv_shortcut, pair input): identity, NIN and Conv_2 skips, and
# the up path's (h, skip) pair
BLOCKS = {"identity": (32, 32, False, False), "nin": (32, 64, False, False),
          "conv_shortcut": (32, 64, True, False), "pair": (48, 32, False, True)}


@pytest.mark.parametrize("skip_rescale", [False, True])
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_resnet_block_ddpmpp(kind, skip_rescale):
    cin, cout, conv_shortcut, pair = BLOCKS[kind]
    blk, sd = _load(layers.ResnetBlockDDPMpp(cin, cout, temb_dim=16, conv_shortcut=conv_shortcut,
                                             skip_rescale=skip_rescale), 3)
    rng = np.random.default_rng(cin + cout)
    x, temb = normal(rng, 2, 8, 8, cin), normal(rng, 2, 16)
    jx = (jnp.asarray(x[..., :16]), jnp.asarray(x[..., 16:])) if pair else jnp.asarray(x)
    want = jl.ResnetBlockDDPMpp(out_ch=cout, conv_shortcut=conv_shortcut,
                                skip_rescale=skip_rescale).apply(
        {"params": _flax(sd)}, jx, jnp.asarray(temb))
    tx = torch.from_numpy(x)
    with torch.inference_mode():
        got = blk((tx[..., :16], tx[..., 16:]) if pair else tx, torch.from_numpy(temb))
    assert_close(got, want, LAYER, f"ResnetBlockDDPMpp {kind}")


@pytest.mark.parametrize("with_conv", [False, True])
@pytest.mark.parametrize("up", [False, True])
def test_resample_layers(up, with_conv):
    """An asymmetric map (H != W, content that is not symmetric) catches a
    pad on the wrong axis or side."""
    layer = (layers.UpsampleLayer if up else layers.DownsampleLayer)(8, with_conv=with_conv)
    _, sd = _load(layer, 4)
    ramp = 0.3 * np.arange(10, dtype=np.float32)[:, None] \
        - 0.2 * np.arange(6, dtype=np.float32)[:, None, None]
    x = normal(np.random.default_rng(5), 2, 6, 10, 8) + ramp
    jmod = (jl.UpsampleLayer if up else jl.DownsampleLayer)(with_conv=with_conv)
    want = jmod.apply({"params": _flax(sd)} if with_conv else {}, jnp.asarray(x))
    with torch.inference_mode():
        got = layer(torch.from_numpy(x))
    assert_close(got, want, LAYER, f"{'up' if up else 'down'} with_conv={with_conv}")


def test_fir_raises():
    for layer in (layers.UpsampleLayer, layers.DownsampleLayer):
        with pytest.raises(NotImplementedError, match="ROADMAP Slice 1 item 5"):
            layer(8, fir=True)


@pytest.mark.parametrize("variant", ["cifar10", "uncentered_sigma_scaled"])
def test_small_ddpm_matches_jax(variant):
    """The DDPM, its weights carried from flax by ddpm_state_dict_from_flax."""
    cfg = dict(SMALL) if variant == "cifar10" else dict(
        nf=32, ch_mult=(1,), image_size=8, attn_resolutions=(8,), centered=False,
        scale_by_sigma=True)
    _, sd = _load(DDPM(**cfg), 0)
    params = translate_ncsnpp(sd)
    model = DDPM(**cfg).eval()
    model.load_state_dict(ddpm_state_dict_from_flax(
        params, scale_by_sigma=cfg.get("scale_by_sigma", False)), strict=True)
    x = normal(np.random.default_rng(1), 2, cfg["image_size"], cfg["image_size"], 3)
    want = jax.jit(JaxDDPM(**cfg).apply)(params, jnp.asarray(x), jnp.asarray(LABELS))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(LABELS))
    assert got.dtype == torch.float32
    assert_close(got, want, MODEL, f"DDPM {variant}")


def test_registry_and_full_width_count():
    assert get_model_cls("ddpm") is DDPM and get_model_cls("ncsnpp") is NCSNpp
    # SDEdit's CelebA-HQ UNet registers under JAX's name since item 17
    assert get_model_cls("ddpm_sdedit") is DDPMUNet
    with pytest.raises(KeyError, match="unknown model"):
        get_model_cls("ddpm_v2")
    with torch.device("meta"):
        model = create_model("ddpm")
    assert isinstance(model, DDPM)
    assert sum(p.numel() for p in model.parameters()) == 35_218_947


NCSN_DDPM = dict(nf=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                 image_size=16, resblock_type="ddpm")


@pytest.fixture(scope="module")
def ncsnpp_ddpm():
    """The NCSN++ 'ddpm' variant with seeded weights, carried from flax by
    ncsnpp_state_dict_from_flax, and JAX's fp32 output."""
    _, sd = _load(NCSNpp(**NCSN_DDPM), 0)
    params = translate_ncsnpp(sd)
    model = NCSNpp(**NCSN_DDPM).eval()
    model.load_state_dict(ncsnpp_state_dict_from_flax(params), strict=True)
    x = normal(np.random.default_rng(1), 2, 16, 16, 3)
    want32 = jax.jit(JaxNCSNpp(**NCSN_DDPM).apply)(params, jnp.asarray(x), jnp.asarray(LABELS))
    return model, params, x, np32(want32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ncsnpp_ddpm_variant_matches_jax(ncsnpp_ddpm, dtype):
    jdt, tdt = DTYPES[dtype]
    model, params, x, want32 = ncsnpp_ddpm
    model.dtype = tdt
    with torch.inference_mode():
        got = np32(model(torch.from_numpy(x), torch.from_numpy(LABELS)))
    model.dtype = None
    if dtype == "float32":
        assert_close(got, want32, MODEL, "NCSN++ ddpm fp32")
        return
    want = np32(jax.jit(JaxNCSNpp(**NCSN_DDPM, dtype=jdt).apply)(
        params, jnp.asarray(x), jnp.asarray(LABELS)))
    assert_close(got, want, 2e-2, "NCSN++ ddpm bf16 against JAX bf16")
    scale = np.abs(want32).max()
    drift_port = np.abs(got - want32).max() / scale
    drift_jax = np.abs(want - want32).max() / scale
    assert drift_port <= 1.25 * drift_jax, (drift_port, drift_jax)


def test_purify_sde_through_ddpm_matches_jax():
    """A short reverse-SDE purification through the small DDPM, with the
    noise JAX draws, against JAX's purify_sde."""
    model, sd = _load(DDPM(**SMALL), 0)
    jmodel, params = JaxDDPM(**SMALL), translate_ncsnpp(sd)
    x01 = np.random.default_rng(2).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jax_purify_sde(lambda p, x, t: jmodel.apply(p, x, t), params,
                          (jnp.asarray(x01) - 0.5) * 2.0, key,
                          JaxPurifyConfig(t=4, grad_mode="none"))
    with torch.inference_mode():
        got = purify_sde(model, to_torch(x01) * 2.0 - 1.0, JaxNoise(key),
                         PurifyConfig(t=4, grad_mode="none"))
    assert_close(got, want, MODEL, "purify_sde through the DDPM")


def test_ddpm_census_is_the_kernels_path():
    """The full-width DDPM's kernel calls per evaluation, walked on the meta
    device: 44 GNSiLU (#10) at 11 (H, C) shapes, and 4 attention blocks
    (#3), 3 at 16x16x256 and the middle block at 4x4x256, what
    chip_smoke.py's phase 10 counts 100 times over."""
    gn, attn = ddpm_census()
    assert gn == {(32, 128): 7, (32, 256): 2, (32, 384): 1, (16, 128): 1, (16, 256): 6,
                  (16, 384): 1, (16, 512): 2, (8, 256): 7, (8, 512): 3, (4, 256): 11,
                  (4, 512): 3}
    assert sum(gn.values()) == 44
    assert attn == {(16, 256): 3, (4, 256): 1}
