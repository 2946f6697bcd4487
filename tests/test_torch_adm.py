"""The port's ADM UNet against diffpure_tpu/models/adm_unet.py on the same
seeded weights: its blocks on each route (halo, tiled with up and down,
plain), the attention block, a small UNet in fp32 and bf16, the
ImageNet-256 configuration's size, and the weight carriers.

The JAX side runs its 256-px kernels in interpret mode, forced on as
tests/test_tiled_groupnorm.py does (``set_fused_resblock(True)``, a lowered
``set_tiled_gn_min_bytes``, ``set_halo_conv(True)``), each restored in a
``finally``; the port lowers its own threshold the same way.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.models import adm_unet as jadm
from diffpure_tpu.models import layers as jlayers
from diffpure_tpu.models.convert import translate_adm
from diffpure_tpu_torch.models import ADMUNet, create_model, imagenet256_config
from diffpure_tpu_torch.models import adm_unet
from diffpure_tpu_torch.models.convert import adm_state_dict_from_flax
from diffpure_tpu_torch.models.factories import channel_mult_for_image_size
from diffpure_tpu_torch.models.layers import adm_timestep_embedding
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from test_torch_convert import _flax_zeros, _round_trip, _shapes
from torch_parity import DTYPES, REL, assert_close, normal, np32

ADM_PARAMS = 552_814_086  # bench.py:48
SMALL = dict(image_size=32, model_channels=32, out_channels=6, num_res_blocks=1,
             attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4,
             num_head_channels=32, use_scale_shift_norm=True, resblock_updown=True)


@contextlib.contextmanager
def tiled_routes(min_bytes):
    """Both packages' 256-px routes on, at maps of at least min_bytes."""
    jlayers.set_fused_resblock(True)
    jadm.set_halo_conv(True)
    jadm.set_tiled_gn_min_bytes(min_bytes)
    adm_unet.set_tiled_gn_min_bytes(min_bytes)
    try:
        yield
    finally:
        jlayers.set_fused_resblock("auto")
        jadm.set_tiled_gn_min_bytes(None)
        adm_unet.set_tiled_gn_min_bytes(None)


def _seeded(module, seed):
    sd = seeded_normal_state_dict(module, seed)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return module.eval(), translate_adm(sd)


@pytest.fixture
def route_spy(monkeypatch):
    """Counts the port's calls of the two 256-px routes."""
    calls = {"halo": 0, "tiled": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(adm_unet, "gn_silu_conv_block",
                        spy("halo", adm_unet.gn_silu_conv_block))
    monkeypatch.setattr(adm_unet, "group_norm_film_silu",
                        spy("tiled", adm_unet.group_norm_film_silu))
    return calls


# route -> (in, out, H, resample, threshold bytes, halo calls, tiled calls)
ROUTES = {"halo": (32, 32, 8, None, 4096, 2, 0),
          "halo_proj": (32, 64, 8, None, 4096, 2, 0),
          "tiled_down": (32, 32, 8, "down", 2048, 0, 2),
          "tiled_up": (32, 32, 4, "up", 2048, 0, 2),
          "plain": (32, 64, 8, None, None, 0, 0)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_resblock_routes_match_jax(route_spy, dtype, route):
    jdt, tdt = DTYPES[dtype]
    cin, cout, H, rs, min_bytes, n_halo, n_tiled = ROUTES[route]
    blk, params = _seeded(adm_unet.ResBlockADM(cin, 16, cout, up=rs == "up",
                                               down=rs == "down"), 0)
    rng = np.random.default_rng(1)
    x, emb = normal(rng, 2, H, H, cin), normal(rng, 2, 16)
    jblk = jadm.ResBlockADM(out_channels=cout, emb_channels=16, up=rs == "up",
                            down=rs == "down", dtype=jdt)
    with tiled_routes(min_bytes):
        want = jblk.apply(params, jnp.asarray(x).astype(jdt), jnp.asarray(emb))
        with torch.inference_mode():
            got = blk(torch.from_numpy(x).to(tdt), torch.from_numpy(emb))
    assert (route_spy["halo"], route_spy["tiled"]) == (n_halo, n_tiled)
    assert got.dtype == tdt
    assert_close(got, want, REL[dtype], f"ResBlockADM {route} {dtype}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("order", [False, True])
def test_attention_block_matches_jax(dtype, order):
    jdt, tdt = DTYPES[dtype]
    blk, params = _seeded(adm_unet.AttentionBlockADM(64, num_head_channels=32,
                                                     use_new_attention_order=order), 2)
    x = normal(np.random.default_rng(3), 2, 8, 8, 64)
    want = jadm.AttentionBlockADM(num_head_channels=32, use_new_attention_order=order,
                                  dtype=jdt).apply(params, jnp.asarray(x).astype(jdt))
    with torch.inference_mode():
        got = blk(torch.from_numpy(x).to(tdt))
    assert_close(got, want, REL[dtype], f"AttentionBlockADM {dtype}")


# A bf16 UNet of random weights drifts from its fp32 self by rounding
# alone: JAX's bf16 run of this model lands 1.3% (max abs, relative to
# max |fp32|) from its fp32 run, the port's 1.5%, and the two bf16 runs
# 1.9% apart, since they round at different places (CPU rehearsal). So the
# bf16 runs are held to 3e-2 of each other, and the port's bf16 run to the
# fp32 reference within 1.5x the distance of JAX's own bf16 run.
BF16_MODEL_REL, BF16_DRIFT_RATIO = 3e-2, 1.5


@pytest.fixture(scope="module")
def small_adm():
    model, params = _seeded(ADMUNet(**SMALL), 4)
    rng = np.random.default_rng(5)
    x, t = normal(rng, 2, 32, 32, 3), np.array([150, 7], np.int32)
    with tiled_routes(64 * 1024):
        want = {d: jadm.ADMUNet(**SMALL, dtype=DTYPES[d][0]).apply(
            params, jnp.asarray(x), jnp.asarray(t)) for d in DTYPES}
    return model, x, t, want


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_small_adm_matches_jax_with_tiled_routes(small_adm, dtype):
    """Every level's blocks take the halo or tiled route (maps of >= 64 KiB),
    the attention blocks the dense path."""
    model, x, t, want = small_adm
    model.dtype = DTYPES[dtype][1]
    with tiled_routes(64 * 1024), torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 6)
    if dtype == "float32":
        assert_close(got, want[dtype], REL[dtype], "ADM fp32")
        return
    assert_close(got, want[dtype], BF16_MODEL_REL, "ADM bf16")
    ref = np32(want["float32"])
    jax_drift = np.abs(np32(want[dtype]) - ref).max()
    assert np.abs(np32(got) - ref).max() <= BF16_DRIFT_RATIO * jax_drift


def test_timestep_embedding_matches_jax():
    from diffpure_tpu.models.layers import adm_timestep_embedding as jemb
    t = np.array([0, 1, 150, 999], np.int32)
    # the same fp32 arguments (up to 999); sin and cos differ in the last
    # bits between the two libraries
    for dim in (32, 33):
        assert_close(adm_timestep_embedding(torch.from_numpy(t), dim),
                     jemb(jnp.asarray(t), dim), 1e-5, f"embedding {dim}")


def test_imagenet256_config_size():
    with torch.device("meta"):
        model = ADMUNet(**imagenet256_config())
    assert sum(p.numel() for p in model.parameters()) == ADM_PARAMS
    assert model.dtype == torch.bfloat16
    assert all(m.use_flash for m in model.modules()
               if isinstance(m, adm_unet.AttentionBlockADM))
    sd = model.state_dict()
    assert tuple(sd["input_blocks.4.0.in_layers.0.weight"].shape) == (256,)
    assert tuple(sd["input_blocks.10.1.qkv.weight"].shape) == (1536, 512, 1)
    assert tuple(sd["output_blocks.0.0.emb_layers.1.weight"].shape) == (2048, 1024)


def test_weight_carriers_both_ways():
    """seeded state dict -> translate_adm -> carrier is the identity, and the
    carrier of JAX's own tree has the port's keys and shapes, at the
    ImageNet structure (6 levels, 2 blocks, attention at ds 8/16/32) cut to
    32 channels."""
    _round_trip(ADMUNet(**SMALL), translate_adm, adm_state_dict_from_flax)
    narrow = dict(imagenet256_config(use_bf16=False), model_channels=32,
                  num_head_channels=16, image_size=64)
    flax = _flax_zeros(jadm.ADMUNet(**narrow), (1, 64, 64, 3), (1,))
    assert _shapes(adm_state_dict_from_flax(flax)) == _shapes(ADMUNet(**narrow).state_dict())


def test_create_model_mirrors_jax():
    assert channel_mult_for_image_size(256) == (1, 1, 2, 2, 4, 4)
    with pytest.raises(ValueError):
        channel_mult_for_image_size(100)
    with torch.device("meta"):
        m = create_model(256, 256, 2, learn_sigma=True, attention_resolutions="32,16,8",
                         num_head_channels=64, use_scale_shift_norm=True,
                         resblock_updown=True, use_fp16=True)
    assert sum(p.numel() for p in m.parameters()) == ADM_PARAMS
    # as in JAX, a model built here never takes the flash kernel
    assert not any(getattr(b, "use_flash", False) for b in m.modules())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("which", ["up", "down"])
def test_conv_resample_layers_match_jax(dtype, which):
    """The resample layers of resblock_updown=False configurations."""
    jdt, tdt = DTYPES[dtype]
    cls, jcls = ((adm_unet.UpsampleADM, jadm.UpsampleADM) if which == "up"
                 else (adm_unet.DownsampleADM, jadm.DownsampleADM))
    layer, params = _seeded(cls(32, 48), 6)
    x = normal(np.random.default_rng(7), 2, 8, 8, 32)
    want = jcls(48, dtype=jdt).apply(params, jnp.asarray(x).astype(jdt))
    with torch.inference_mode():
        got = layer(torch.from_numpy(x).to(tdt))
    assert_close(got, want, REL[dtype], f"{which}sample {dtype}")
