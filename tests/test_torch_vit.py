"""The port's DeiT (classifiers/vit.py) against diffpure_tpu's ViT on the
same seeded weights: a narrow one at its trained grid and at a larger
input (the position grid resampled by jax.image.resize's bicubic), the
resample weights themselves, the weight carrier both ways, and the
registry's DeiT-S with its ImageNet shim at timm's size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.classifiers import registry as jreg
from diffpure_tpu.classifiers.common import normalize
from diffpure_tpu.classifiers.convert import translate_vit
from diffpure_tpu.classifiers.vit import ViT as JaxViT
from diffpure_tpu_torch.classifiers import get_classifier
from diffpure_tpu_torch.classifiers.common import IMAGENET_MEAN, IMAGENET_STD
from diffpure_tpu_torch.classifiers.convert import vit_state_dict_from_flax
from diffpure_tpu_torch.classifiers.vit import ViT, cubic_resize, cubic_weights
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from test_torch_convert import _flax_zeros, _round_trip, _shapes
from torch_parity import assert_close, normal

NARROW = dict(image_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2,
              mlp_ratio=2.0, num_classes=10)
DEIT_S_PARAMS = 22_050_664  # timm's deit_small_patch16_224


def _seeded_vit(seed, **kw):
    model = ViT(**NARROW, **kw).eval()
    sd = {k: torch.from_numpy(v) for k, v in seeded_normal_state_dict(model, seed).items()}
    # position embeddings of unit scale, so that their resample shows
    sd["pos_embed"] = torch.from_numpy(normal(np.random.default_rng(seed), *sd["pos_embed"].shape))
    model.load_state_dict(sd)
    return model, translate_vit(sd)


@pytest.mark.parametrize("size", [32, 48, 24])
def test_narrow_vit_matches_jax(size):
    """At the trained 4 x 4 grid, and at 6 x 6 and 3 x 3, where both resample
    the position grid."""
    model, params = _seeded_vit(0)
    x = normal(np.random.default_rng(1), 2, size, size, 3)
    want = JaxViT(**NARROW).apply(params, jnp.asarray(x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 10)
    assert_close(got, want, 1e-4, f"ViT at {size} px")


@pytest.mark.parametrize("n_in, n_out", [(14, 16), (4, 6), (4, 3), (5, 5)])
def test_cubic_resize_matches_jax_image_resize(n_in, n_out):
    grid = normal(np.random.default_rng(n_in + n_out), 1, n_in, n_in, 5)
    want = jax.image.resize(jnp.asarray(grid), (1, n_out, n_out, 5), "bicubic")
    assert_close(cubic_resize(torch.from_numpy(grid), n_out), want, 1e-6, "bicubic")
    w = cubic_weights(n_in, n_out)
    assert w.shape == (n_in, n_out) and torch.allclose(w.sum(0), torch.ones(n_out))


def test_vit_carrier_both_ways():
    _round_trip(ViT(**NARROW), translate_vit, vit_state_dict_from_flax)
    sd = vit_state_dict_from_flax(_flax_zeros(JaxViT(**NARROW), (1, 32, 32, 3)))
    assert _shapes(sd) == _shapes(ViT(**NARROW).state_dict())
    assert {"patch_embed.proj.weight", "cls_token", "pos_embed", "blocks.1.mlp.fc2.bias",
            "blocks.0.attn.qkv.weight", "norm.weight", "head.bias"} <= set(sd)


def test_registry_deit_s_has_timm_size_and_the_shim():
    with torch.device("meta"):
        model = get_classifier("imagenet-deit-s")
    assert sum(p.numel() for p in model.parameters()) == DEIT_S_PARAMS
    assert model.input_norm == (IMAGENET_MEAN, IMAGENET_STD)
    jmodel, _, _ = jreg.get_classifier("imagenet-deit-s")
    assert _shapes(vit_state_dict_from_flax(_flax_zeros(jmodel, (1, 224, 224, 3)))) \
        == _shapes(model.state_dict())


def test_registry_shim_matches_jax_logits_fn():
    """A narrow DeiT behind the registry's shim against JAX's logits_fn."""
    model, params = _seeded_vit(2, input_norm=(IMAGENET_MEAN, IMAGENET_STD))
    x01 = np.random.default_rng(3).uniform(size=(2, 40, 40, 3)).astype(np.float32)
    jmodel = JaxViT(**NARROW)
    want = jmodel.apply(params, normalize(jnp.asarray(x01), IMAGENET_MEAN, IMAGENET_STD))
    with torch.inference_mode():
        got = model(torch.from_numpy(x01))
    assert_close(got, want, 1e-4, "shimmed ViT")
