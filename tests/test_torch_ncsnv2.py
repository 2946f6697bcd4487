"""The port's NCSN family (diffpure_tpu_torch/models/{normalization,
legacy_layers,ncsnv2}.py) against diffpure_tpu's on the same seeded
weights: each norm of the zoo, each legacy block (every ResidualBlock
branch, max and mean pooling, the bilinear resize with aligned corners),
NCSNv2 / NCSN / NCSNv2_128 / NCSNv2_256 at small width, get_network's
dispatch and the converters. fp32 at 1e-4 of the largest JAX value; the
JAX side is jitted. Weights go port -> flax through JAX's translate_ncsnv2
(score_sde's keys) and back through the port's ncsnv2_state_dict_from_flax.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu.models import legacy_layers as jll
from diffpure_tpu.models import ncsnv2 as jv2
from diffpure_tpu.models import normalization as jnorm
from diffpure_tpu.models.convert import translate_ncsnv2 as jax_translate_ncsnv2
from diffpure_tpu_torch.models import legacy_layers as ll
from diffpure_tpu_torch.models import ncsnv2 as v2
from diffpure_tpu_torch.models import normalization as tnorm
from diffpure_tpu_torch.models.convert import ncsnv2_state_dict_from_flax, translate_ncsnv2
from diffpure_tpu_torch.models.registry import get_model_cls
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from torch_parity import REL, assert_close, normal, two_torch_threads  # noqa: F401

TOL = REL["float32"]
K = 10  # noise levels of the conditional norms
LABELS = np.array([1, 7], np.int32)


class _Holder(nn.Module):
    """One submodule named ``m``: JAX's translator needs a module path."""

    def __init__(self, m):
        super().__init__()
        self.m = m


def _flax_params(module, seed):
    """Seeded weights for ``module``, loaded into it, and the same as flax
    params through JAX's translator."""
    holder = _Holder(module)
    sd = seeded_normal_state_dict(holder, seed)
    holder.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return {"params": jax_translate_ncsnv2(sd)["params"]["m"]}


def _run(jmod, params, tmod, x, cond=False):
    """Module on x (and the labels, ``cond``): JAX's jitted apply against
    the port's forward."""
    ys = [LABELS] if cond else []
    want = jax.jit(jmod.apply)(params, jnp.asarray(x), *map(jnp.asarray, ys))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), *map(torch.from_numpy, ys))
    assert_close(got, want, TOL, type(tmod).__name__)


def _x(*shape, seed=0, shift=0.0):
    return normal(np.random.default_rng(seed), *shape, shift=shift)


# --- the norm zoo --------------------------------------------------------------

NORMS = {
    "instance": (lambda: jnorm.InstanceNorm2d(), lambda: tnorm.InstanceNorm2d(6), False),
    "variance": (lambda: jnorm.VarianceNorm2d(), lambda: tnorm.VarianceNorm2d(6), False),
    "none": (lambda: jnorm.NoneNorm2d(), lambda: tnorm.NoneNorm2d(6), False),
    "instance++": (lambda: jnorm.InstanceNorm2dPlus(), lambda: tnorm.InstanceNorm2dPlus(6),
                   False),
    "instance++_nobias": (lambda: jnorm.InstanceNorm2dPlus(bias=False),
                          lambda: tnorm.InstanceNorm2dPlus(6, bias=False), False),
    "cond_instance++": (lambda: jnorm.ConditionalInstanceNorm2dPlus(num_classes=K),
                        lambda: tnorm.ConditionalInstanceNorm2dPlus(6, K), True),
    "cond_instance++_nobias": (lambda: jnorm.ConditionalInstanceNorm2dPlus(num_classes=K,
                                                                           bias=False),
                               lambda: tnorm.ConditionalInstanceNorm2dPlus(6, K, bias=False),
                               True),
    "cond_variance": (lambda: jnorm.ConditionalVarianceNorm2d(num_classes=K),
                      lambda: tnorm.ConditionalVarianceNorm2d(6, K), True),
    "cond_none": (lambda: jnorm.ConditionalNoneNorm2d(num_classes=K),
                  lambda: tnorm.ConditionalNoneNorm2d(6, K), True),
    "cond_none_nobias": (lambda: jnorm.ConditionalNoneNorm2d(num_classes=K, bias=False),
                         lambda: tnorm.ConditionalNoneNorm2d(6, K, bias=False), True),
}


@pytest.mark.parametrize("name", list(NORMS))
def test_norm_matches_jax(name):
    jmake, tmake, cond = NORMS[name]
    tmod = tmake()
    params = _flax_params(tmod, 1) if list(tmod.parameters()) else {}
    # channel means far apart, so InstanceNorm++'s mean term carries weight
    x = _x(2, 5, 7, 6, seed=2) * 3.0 + np.arange(6, dtype=np.float32)
    _run(jmake(), params, tmod, x, cond=cond)


def test_get_normalization_dispatch():
    assert tnorm.get_normalization("InstanceNorm") is tnorm.InstanceNorm2d
    assert tnorm.get_normalization("InstanceNorm++") is tnorm.InstanceNorm2dPlus
    assert tnorm.get_normalization("VarianceNorm") is tnorm.VarianceNorm2d
    gn = tnorm.get_normalization("GroupNorm")(64)
    assert gn.num_groups == 32 and gn.eps == 1e-5
    cond = tnorm.get_normalization("InstanceNorm++", conditional=True, num_classes=K)(6)
    assert isinstance(cond, tnorm.ConditionalInstanceNorm2dPlus)
    assert cond.embed.weight.shape == (K, 18)
    assert float(cond.embed.weight.detach()[:, 12:].abs().max()) == 0.0  # beta starts at 0
    with pytest.raises(NotImplementedError):
        tnorm.get_normalization("VarianceNorm", conditional=True)
    with pytest.raises(ValueError):
        tnorm.get_normalization("BatchNorm")


# --- the legacy blocks -----------------------------------------------------------

JNORM = jnorm.InstanceNorm2dPlus
JCNORM = functools.partial(jnorm.ConditionalInstanceNorm2dPlus, num_classes=K)
TCNORM = tnorm.ConditionalInstanceNorm2dPlus

BLOCKS = {
    "crp_max": (lambda: jll.CRPBlock(8, 2, fnn.relu, maxpool=True),
                lambda: ll.CRPBlock(8, 2, F.relu, maxpool=True), False),
    "crp_mean": (lambda: jll.CRPBlock(8, 2, fnn.elu, maxpool=False),
                 lambda: ll.CRPBlock(8, 2, F.elu, maxpool=False), False),
    "cond_crp": (lambda: jll.CondCRPBlock(8, 2, JCNORM, fnn.elu),
                 lambda: ll.CondCRPBlock(8, 2, K, TCNORM, F.elu), True),
    "rcu": (lambda: jll.RCUBlock(8, 2, 2, fnn.elu), lambda: ll.RCUBlock(8, 2, 2, F.elu), False),
    "cond_rcu": (lambda: jll.CondRCUBlock(8, 3, 2, JCNORM, fnn.elu),
                 lambda: ll.CondRCUBlock(8, 3, 2, K, TCNORM, F.elu), True),
    "conv_mean_pool": (lambda: jll.ConvMeanPool(6, 3), lambda: ll.ConvMeanPool(8, 6, 3), False),
    "conv_mean_pool_1x1": (lambda: jll.ConvMeanPool(6, 1, biases=False),
                           lambda: ll.ConvMeanPool(8, 6, 1, biases=False), False),
    "mean_pool_conv": (lambda: jll.MeanPoolConv(6, 3), lambda: ll.MeanPoolConv(8, 6, 3), False),
    "upsample_conv": (lambda: jll.UpsampleConv(6, 3), lambda: ll.UpsampleConv(8, 6, 3), False),
}
for _name, _kw in (("res_down", dict(resample="down")),
                   ("res_down_dilated", dict(resample="down", dilation=2)),
                   ("res_dilated_same", dict(dilation=2, same=True)),
                   ("res_dilated", dict(dilation=4)),
                   ("res_same", dict(same=True)),
                   ("res_wider", dict())):
    _same = _kw.pop("same", False)
    _out = 8 if _same else 12
    BLOCKS[_name] = (
        functools.partial(lambda kw, out: jll.ResidualBlock(out, act=fnn.elu,
                                                            normalization=JNORM, **kw),
                          dict(_kw), _out),
        functools.partial(lambda kw, out: ll.ResidualBlock(8, out, act=F.elu, **kw),
                          dict(_kw), _out), False)
    BLOCKS["cond_" + _name] = (
        functools.partial(lambda kw, out: jll.ConditionalResidualBlock(
            out, act=fnn.elu, normalization=JCNORM, **kw), dict(_kw), _out),
        functools.partial(lambda kw, out: ll.ConditionalResidualBlock(
            8, out, K, act=F.elu, normalization=TCNORM, **kw), dict(_kw), _out), True)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name, two_torch_threads):  # noqa: F811
    jmake, tmake, cond = BLOCKS[name]
    tmod = tmake()
    _run(jmake(), _flax_params(tmod, 3), tmod, _x(2, 8, 8, 8, seed=4), cond=cond)


def test_conv_mean_pool_adjust_padding_matches_jax():
    """adjust_padding (the 28 px model's): score_sde's Sequential(ZeroPad2d,
    Conv2d) keeps the conv as ``conv.1``; flax names it ``conv``."""
    tmod = ll.ConvMeanPool(4, 6, 3, adjust_padding=True)
    conv = tmod.conv[1]
    rng = np.random.default_rng(5)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(normal(rng, 6, 4, 3, 3, fan_in=36)))
        conv.bias.copy_(torch.from_numpy(normal(rng, 6, scale=0.1)))
    params = {"params": {"conv": {"kernel": conv.weight.detach().numpy().transpose(2, 3, 1, 0),
                                  "bias": conv.bias.detach().numpy()}}}
    _run(jll.ConvMeanPool(6, 3, adjust_padding=True), params, tmod, _x(2, 7, 7, 4, seed=6))


@pytest.mark.parametrize("cond", [False, True])
def test_msf_and_refine_blocks_match_jax(cond, two_torch_threads):  # noqa: F811
    """Two inputs at 4x4 and 8x8 fused at 8x8 (the 4x4 one resized with
    aligned corners), and the Refine block in its start (one input as wide
    as the block), middle and end forms."""
    a, b = _x(2, 8, 8, 6, seed=7), _x(2, 4, 4, 8, seed=8)
    jlab = [jnp.asarray(LABELS)] if cond else []
    tlab = [torch.from_numpy(LABELS)] if cond else []
    if cond:
        jmsf, tmsf = jll.CondMSFBlock(8, JCNORM), ll.CondMSFBlock([6, 8], 8, K, TCNORM)
    else:
        jmsf, tmsf = jll.MSFBlock(8), ll.MSFBlock([6, 8], 8)
    params = _flax_params(tmsf, 9)
    want = jax.jit(lambda p, a, b, *y: jmsf.apply(p, [a, b], *y, (8, 8)))(
        params, jnp.asarray(a), jnp.asarray(b), *jlab)
    with torch.no_grad():
        got = tmsf([torch.from_numpy(a), torch.from_numpy(b)], *tlab, (8, 8))
    assert_close(got, want, TOL, "MSF")
    for start, end, xs, planes in ((True, False, [b], [8]), (False, False, [a, b], [6, 8]),
                                   (False, True, [a, b], [6, 8])):
        if cond:
            jref = jll.CondRefineBlock(8, JCNORM, fnn.elu, start=start, end=end)
            tref = ll.CondRefineBlock(planes, 8, K, TCNORM, F.elu, start=start, end=end)
        else:
            jref = jll.RefineBlock(8, fnn.elu, start=start, end=end)
            tref = ll.RefineBlock(planes, 8, F.elu, start=start, end=end)
        shape = tuple(xs[0].shape[1:3])
        params = _flax_params(tref, 10)
        want = jax.jit(lambda p, *a: jref.apply(p, list(a[:len(xs)]), *a[len(xs):], shape))(
            params, *[jnp.asarray(x) for x in xs], *jlab)
        with torch.no_grad():
            got = tref([torch.from_numpy(x) for x in xs], *tlab, shape)
        assert_close(got, want, TOL, f"Refine start={start} end={end} cond={cond}")


def test_resize_bilinear_align_matches_jax():
    x = _x(2, 3, 5, 4, seed=11)
    for shape in ((7, 9), (3, 5), (6, 10)):
        want = jll._resize_bilinear_align(jnp.asarray(x), shape)
        assert_close(ll._resize_bilinear_align(torch.from_numpy(x), shape), want, 1e-6,
                     f"resize to {shape}")


# --- the networks -----------------------------------------------------------------

MODELS = {"ncsnv2_64": (jv2.NCSNv2, 16), "ncsn": (jv2.NCSN, 16),
          "ncsnv2_128": (jv2.NCSNv2_128, 16), "ncsnv2_256": (jv2.NCSNv2_256, 16)}


@pytest.mark.parametrize("name", list(MODELS))
def test_small_network_matches_jax(name, two_torch_threads):  # noqa: F811
    jcls, size = MODELS[name]
    cfg = dict(image_size=size, nf=8, num_scales=K, sigma_min=0.01, sigma_max=50.0)
    tmod = get_model_cls(name)(**cfg).eval()
    sd = seeded_normal_state_dict(tmod, 12)
    tmod.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    params = jax_translate_ncsnv2(sd)
    # the converters: flax -> the port's keys, every leaf once; a score_sde
    # state dict (DataParallel's prefix) -> the port's module
    back = ncsnv2_state_dict_from_flax(params, num_scales=K)
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        np.testing.assert_allclose(v.numpy(), sd[k], rtol=1e-7, err_msg=k)
    got_sd = translate_ncsnv2({"module." + k: torch.from_numpy(v) for k, v in sd.items()}, tmod)
    tmod.load_state_dict(got_sd, strict=True)
    x = _x(2, size, size, 3, seed=13) * 0.5 + 0.5
    want = jax.jit(jcls(**cfg).apply)(params, jnp.asarray(x), jnp.asarray(LABELS))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(LABELS))
    assert_close(got, want, TOL, name)


def test_translate_ncsnv2_refuses_a_state_dict_that_does_not_fit():
    model = v2.NCSNv2(image_size=16, nf=8, num_scales=K)
    sd = dict(model.state_dict())
    sd.pop("begin_conv.bias")
    with pytest.raises(ValueError, match="missing"):
        translate_ncsnv2(sd, model)


def test_get_network_dispatch():
    for size, want_t, want_j in ((32, v2.NCSNv2, jv2.NCSNv2), (95, v2.NCSNv2, jv2.NCSNv2),
                                 (96, v2.NCSNv2_128, jv2.NCSNv2_128),
                                 (128, v2.NCSNv2_128, jv2.NCSNv2_128),
                                 (256, v2.NCSNv2_256, jv2.NCSNv2_256)):
        assert v2.get_network(size) is want_t and jv2.get_network(size) is want_j
    with pytest.raises(NotImplementedError):
        v2.get_network(512)
    for name in MODELS:
        assert get_model_cls(name).__name__ == MODELS[name][0].__name__


def test_full_width_cifar_ncsnv2_matches_flax_tree():
    """ncsnv2_64 at 32 px, nf 128 (score_sde's configs/ncsnv2/cifar10.py):
    the port's parameters equal JAX's model.init leaf for leaf."""
    with torch.device("meta"):
        tmod = v2.NCSNv2(image_size=32, nf=128, num_scales=232)
    shapes = jax.eval_shape(lambda: jv2.NCSNv2(image_size=32, nf=128, num_scales=232).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,), jnp.int32)))
    flat = {"/".join(str(getattr(k, "key", k)) for k in p): v.shape
            for p, v in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {k: tuple(v.shape) for k, v in tmod.state_dict().items() if k != "sigmas"}
    assert sum(int(np.prod(s)) for s in flat.values()) == sum(
        int(np.prod(s)) for s in got.values()) == 29_694_083
    assert len(flat) == len(got)
