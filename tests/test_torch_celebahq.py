"""The port's CelebA-HQ defence against diffpure_tpu's (item 17): the SDEdit
DDPM UNet, its purifier, the attribute classifier, the checkpoint
converters and the data reader.

Tolerances: the DDPM UNet fp32 1e-4 of max |JAX|; bf16: JAX's bf16 run of
the small model lands about 1-2% from its fp32 run, and the two bf16 runs
round at different places, so they are held to 3e-2 of each other and the
port's bf16 run to JAX's fp32 one within 1.5x the distance of JAX's own
(tests/test_torch_adm.py's rule); the purifier 1e-4 with JAX's draws
injected; the attribute net 1e-5; the converters and the data exactly.

- a small ``DDPMUNet`` against flax, fp32 and bf16, with the halo route
  taken on both sides (JAX's fused route forced on, the tiled-GN threshold
  lowered in both packages) at the 32^2 blocks and the plain route at the
  16^2 ones, and the fp32 model on the plain route alone;
- the full-width model: its parameters against JAX's count, its halo
  census on the meta device (every stage a shape the kernels take, #6 and
  #8 each 30 a evaluation, pre_shift on every second stage);
- ``purify_celebahq_ddpm`` (two rounds; the NFE ledger; 'none' detaches);
- ``AttributeD`` at 32 px with and without minibatch stddev,
  ``mean_pool_to``, the registry's ``celebahq__<attribute>`` wrapper;
- ``load_sdedit_checkpoint`` on a synthetic DataParallel state dict and
  ``attribute_state_dict`` on a reference-style one, against JAX's
  translators;
- ``celebahq_subset`` and ``load_data('celebahq')`` against JAX on a
  fixture, the ``min_count`` floor included.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffpure_tpu.classifiers import attribute as jattr
from diffpure_tpu.classifiers.convert import translate_attribute_d
from diffpure_tpu.data import datasets as jds
from diffpure_tpu.models import adm_unet as jadm
from diffpure_tpu.models import layers as jlayers
from diffpure_tpu.models.convert import load_sdedit_checkpoint as jax_load_sdedit
from diffpure_tpu.models.convert import translate_ddpm
from diffpure_tpu.models.ddpm_unet import DDPMUNet as JaxDDPMUNet
from diffpure_tpu.purify import PurifyConfig as JaxPurifyConfig
from diffpure_tpu.purify.runners import purify_celebahq_ddpm as jax_celebahq
from diffpure_tpu_torch.classifiers import get_classifier
from diffpure_tpu_torch.classifiers.attribute import AttributeClassifier, AttributeD, \
    mean_pool_to, minibatch_std
from diffpure_tpu_torch.classifiers.convert import attribute_state_dict, \
    attribute_state_dict_from_flax
from diffpure_tpu_torch.data import celebahq_subset, load_data
from diffpure_tpu_torch.models import DDPMUNet, adm_unet
from diffpure_tpu_torch.models import ddpm_unet
from diffpure_tpu_torch.models.convert import ddpm_unet_state_dict_from_flax, \
    load_sdedit_checkpoint
from diffpure_tpu_torch.ops.halo_conv import check_halo_shape
from diffpure_tpu_torch.purify import PurifyConfig, purify, purify_celebahq_ddpm
from diffpure_tpu_torch.utils.profiling import count_nfe
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from test_torch_discrete import JaxDiscreteNoise
from torch_parity import assert_close, np32

CELEBAHQ_PARAMS = 113_673_219  # jax.eval_shape of DDPMUNet() at 256^2
SMALL = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,))
# the halo route at the 32^2 maps of SMALL (32 x 32 x 32 x 4 bytes), not
# at its 16^2 ones
HALO_MIN_BYTES = 128 * 1024
BF16_MODEL_REL, BF16_DRIFT_RATIO = 3e-2, 1.5


@contextlib.contextmanager
def halo_routes(min_bytes):
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


def _seeded(model, seed):
    sd = seeded_normal_state_dict(model, seed)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.eval().requires_grad_(False), translate_ddpm(sd)


@pytest.fixture(scope="module")
def small():
    model, params = _seeded(DDPMUNet(**SMALL), 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    return model, params, x, t


def _jax_apply(params, x, t, dtype):
    return jax.jit(lambda p, xx, tt: JaxDDPMUNet(**SMALL, dtype=dtype).apply(p, xx, tt))(
        params, jnp.asarray(x), jnp.asarray(t))


def test_small_ddpm_unet_matches_flax_on_the_plain_route(small):
    model, params, x, t = small
    want = _jax_apply(params, x, t, None)
    model.dtype = None
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32
    assert_close(got, want, 1e-4, "DDPMUNet fp32, plain route")
    # the resampling without convs (2x2 mean-pool, nearest)
    pooled, pparams = _seeded(DDPMUNet(**SMALL, resamp_with_conv=False), 2)
    want = jax.jit(lambda p, xx, tt: JaxDDPMUNet(**SMALL, resamp_with_conv=False).apply(
        p, xx, tt))(pparams, jnp.asarray(x), jnp.asarray(t))
    with torch.inference_mode():
        got = pooled(torch.from_numpy(x), torch.from_numpy(t))
    assert_close(got, want, 1e-4, "DDPMUNet fp32, resamp_with_conv=False")


@pytest.fixture(scope="module")
def small_halo(small):
    """JAX's fp32 and bf16 runs of SMALL with the halo route at 32^2."""
    model, params, x, t = small
    with halo_routes(HALO_MIN_BYTES):
        return {d: _jax_apply(params, x, t, jd)
                for d, jd in (("float32", None), ("bfloat16", jnp.bfloat16))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_ddpm_unet_matches_flax_on_the_halo_route(small, small_halo, monkeypatch,
                                                         dtype):
    model, params, x, t = small
    stages = []
    real = ddpm_unet.gn_silu_conv_block

    def spy(*a, **k):
        stages.append((tuple(a[0].shape), a[9] is not None))
        return real(*a, **k)

    monkeypatch.setattr(ddpm_unet, "gn_silu_conv_block", spy)
    model.dtype = torch.bfloat16 if dtype == "bfloat16" else None
    with halo_routes(HALO_MIN_BYTES), torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    model.dtype = None
    # the 32^2 blocks (down 0, up 0's two) take the halo route, two stages
    # each, the second with the timestep embedding as pre_shift
    assert len(stages) == 6 and all(s[0][1] == 32 for s in stages)
    assert [s[1] for s in stages] == [False, True] * 3
    assert got.dtype == torch.float32
    if dtype == "float32":
        assert_close(got, small_halo["float32"], 1e-4, "DDPMUNet fp32, halo route")
        return
    want32 = np32(small_halo["float32"])
    assert_close(got, small_halo["bfloat16"], BF16_MODEL_REL, "DDPMUNet bf16 against JAX bf16")
    jax_drift = np.abs(np32(small_halo["bfloat16"]) - want32).max()
    ours = np.abs(np32(got) - want32).max()
    assert ours <= BF16_DRIFT_RATIO * jax_drift, (ours, jax_drift)


def test_full_width_parameters_and_halo_census():
    with torch.device("meta"):
        model = DDPMUNet()
    n = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(lambda: JaxDDPMUNet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), jnp.zeros((1,), jnp.int32)))
    assert n == CELEBAHQ_PARAMS == sum(int(np.prod(s.shape))
                                       for s in jax.tree_util.tree_leaves(shapes))
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (1, 2):
            census = ddpm_unet.halo_census(batch, dtype if dtype == torch.bfloat16 else None)
            assert sum(census.values()) == 30  # 15 blocks at 256^2-64^2, two stages each
            assert sum(c for k, c in census.items() if k[4]) == 15  # pre_shift
            for (x_shape, cout, cr, proj, _), _ in census.items():
                assert x_shape[0] == batch and x_shape[1] in (64, 128, 256)
                check_halo_shape(dtype, x_shape, (3, 3, x_shape[3], cout), cr, proj)


def test_purify_celebahq_ddpm_matches_jax(small):
    model, params, x, _ = small
    x = np.clip(x * 0.4, -1, 1)
    key = jax.random.PRNGKey(7)
    kw = dict(t=3, sample_step=2, grad_mode="none")
    jmodel = JaxDDPMUNet(**SMALL)
    want = jax.jit(lambda p, xx: jax_celebahq(lambda pp, a, b: jmodel.apply(pp, a, b), p, xx,
                                              key, JaxPurifyConfig(**kw)))(params, jnp.asarray(x))
    model.dtype = None
    with count_nfe() as nfe:
        got = purify(model, torch.from_numpy(x), JaxDiscreteNoise(key),
                     PurifyConfig(diffusion_type="celebahq-ddpm", **kw))
    assert nfe.counts == {"celebahq_ddpm": 6}
    assert got.shape == (4, 32, 32, 3) and not got.requires_grad
    assert_close(got, want, 1e-4, "purify_celebahq_ddpm")
    tx = torch.from_numpy(x[:1]).requires_grad_(True)
    out = purify_celebahq_ddpm(model, tx, 0, PurifyConfig(t=2, grad_mode="none"))
    assert out.grad_fn is None


@pytest.mark.parametrize("mbstd", [False, True])
def test_attribute_net_matches_flax(mbstd):
    model = AttributeD(resolution=32, use_mbstd=mbstd).eval()
    sd = seeded_normal_state_dict(model, 3)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    params = translate_attribute_d(sd)
    x = np.random.default_rng(4).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    want = jax.jit(lambda p, xx: jattr.AttributeD(resolution=32, use_mbstd=mbstd).apply(p, xx))(
        params, jnp.asarray(x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (4, 1)
    assert_close(got, want, 1e-5, f"AttributeD mbstd={mbstd}")
    # the flax tree maps back to the reference's keys
    back = attribute_state_dict_from_flax(params)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_attribute_helpers_and_registry():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 4, 4, 6)).astype(np.float32)
    np.testing.assert_allclose(np32(minibatch_std(torch.from_numpy(x))),
                               np.asarray(jattr.minibatch_std(jnp.asarray(x))), atol=1e-6)
    big = rng.uniform(size=(1, 512, 512, 3)).astype(np.float32)
    np.testing.assert_allclose(np32(mean_pool_to(torch.from_numpy(big), 256)),
                               np.asarray(jattr.mean_pool_to(jnp.asarray(big), 256)), atol=1e-6)
    with torch.device("meta"):
        clf = get_classifier("celebahq__Smiling")
    assert isinstance(clf, AttributeClassifier) and clf.resolution == 256
    jshapes = jax.eval_shape(lambda: jattr.AttributeD().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3))))
    assert sum(p.numel() for p in clf.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jshapes))
    small_clf = AttributeClassifier(resolution=32).eval()
    x01 = torch.from_numpy(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        out = small_clf(x01)
        logit = AttributeD.forward(small_clf, (x01 - 0.5) / 0.5)
    assert torch.equal(out, torch.cat([logit, -logit], dim=1))
    with pytest.raises(KeyError):
        get_classifier("cifar10-nope")


def test_load_sdedit_checkpoint_matches_jax(small, tmp_path):
    model, params, x, t = small
    sd = {"module." + k: torch.as_tensor(v) for k, v in
          ddpm_unet_state_dict_from_flax(params).items()}
    path = str(tmp_path / "celeba_hq.ckpt")
    torch.save(sd, path)
    got = load_sdedit_checkpoint(path, DDPMUNet(**SMALL))
    want = jax_load_sdedit(path)
    assert set(got) == set(model.state_dict())
    back = ddpm_unet_state_dict_from_flax(want)
    for k, v in got.items():
        torch.testing.assert_close(v, back[k], rtol=0, atol=0)
    torch.save({k: v for k, v in sd.items() if "norm_out" not in k}, path)
    with pytest.raises(ValueError, match="missing"):
        load_sdedit_checkpoint(path, DDPMUNet(**SMALL))


def test_attribute_state_dict_matches_jax_translator():
    model = AttributeD(resolution=32)
    sd = {k: torch.from_numpy(v) for k, v in seeded_normal_state_dict(model, 6).items()}
    ref = {"module." + k: v for k, v in sd.items()}
    ref["module.lod_in"] = torch.tensor(0.0)
    got = attribute_state_dict(ref)
    model.load_state_dict(got)  # strict: the reference's keys less its buffers
    want = attribute_state_dict_from_flax(translate_attribute_d(
        {k: v.numpy() for k, v in ref.items()}))
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.fixture(scope="module")
def celebahq_root(tmp_path_factory):
    """<root>/celebahq/images/*.jpg with the two CelebA lists beside them."""
    root = tmp_path_factory.mktemp("dataset")
    d = root / "celebahq"
    (d / "images").mkdir(parents=True)
    rng = np.random.default_rng(8)
    n = 24
    names = [f"{i:06d}.jpg" for i in range(n)]
    for name in names:
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
            d / "images" / name)
    attrs = rng.choice([-1, 1], size=(n, 3))
    with open(d / "list_attr_celeba.txt", "w") as f:
        f.write(f"{n}\nEyeglasses Male Smiling\n")
        for name, a in zip(names, attrs):
            f.write(f"{name} {' '.join(str(v) for v in a)}\n")
    with open(d / "list_eval_partition.txt", "w") as f:
        for i, name in enumerate(names):
            f.write(f"{name} {i % 3}\n")
    return root


@pytest.mark.parametrize("attribute, partition, fraction, min_count",
                         [("Smiling", "val", 2.0, 1), ("Eyeglasses", "val", 2.0, 5),
                          ("Eyeglasses", "train", 50.0, 1), ("Smiling", "test", None, 1),
                          ("Smiling", "val", 2.0, 100)])
def test_celebahq_subset_matches_jax(celebahq_root, attribute, partition, fraction, min_count):
    root = str(celebahq_root / "celebahq")
    got = celebahq_subset(root, attribute, partition, fraction, 3, 64, min_count)
    want = jds.celebahq_subset(root, attribute, partition, fraction, 3, 64, min_count)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.float32 and got[0].shape[1:] == (64, 64, 3)
    assert got[1].dtype == np.int32 and set(got[1].tolist()) <= {0, 1}
    if fraction == 2.0:  # int(2% of 8) == 0: the floor sets the size, up to the partition
        assert len(got[0]) == min(min_count, 8)


def test_load_data_celebahq_matches_jax(celebahq_root):
    root = str(celebahq_root)
    for batch, shard, shards in ((2, 0, 1), (4, 1, 2)):
        got = load_data("celebahq", -1, 1, root=root, classifier_name="celebahq__Smiling",
                        adv_batch_size=batch, shard=shard, num_shards=shards)
        want = jds.load_data("celebahq", -1, 1, root=root, classifier_name="celebahq__Smiling",
                             adv_batch_size=batch, shard=shard, num_shards=shards)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].shape == (batch // shards, 256, 256, 3)
