"""Weight carry-over between the packages: the port's flax -> torch
converters are exact inverses of the JAX package's translators, and the
port's modules have the keys and shapes of the JAX modules' trees."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffpure_tpu.classifiers.convert import translate_wideresnet
from diffpure_tpu.classifiers.wideresnet import WideResNet as JaxWRN
from diffpure_tpu.models.convert import translate_ncsnpp
from diffpure_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffpure_tpu_torch.classifiers import WideResNet, get_classifier
from diffpure_tpu_torch.classifiers.convert import wideresnet_state_dict_from_flax
from diffpure_tpu_torch.models import NCSNpp
from diffpure_tpu_torch.models.convert import flatten_params, \
    ncsnpp_state_dict_from_flax
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

SMALL = dict(nf=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             image_size=16)
CIFAR_PARAMS = 106_632_579  # bench.py:47


def _assert_trees_equal(a, b):
    fa, fb = dict(flatten_params(a)), dict(flatten_params(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg="/".join(k))


def _flax_zeros(model, *shapes):
    """The model's flax param tree, zero-filled (np.zeros maps untouched
    pages, so a full-width tree stays cheap)."""
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          *(jnp.zeros(s) for s in shapes))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree)


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


def _round_trip(module, to_flax, from_flax):
    """seeded torch sd -> flax (JAX translator) -> torch (port) -> flax."""
    sd0 = {k: torch.from_numpy(v) for k, v in
           seeded_normal_state_dict(module, 0).items()}
    p = to_flax(sd0)
    sd1 = from_flax(p)
    _assert_trees_equal(to_flax(sd1), p)
    assert sd1.keys() == sd0.keys()
    for k in sd0:
        assert torch.equal(sd1[k], sd0[k]), k
    module.load_state_dict(sd1, strict=True)


def test_ncsnpp_round_trip():
    _round_trip(NCSNpp(**SMALL), translate_ncsnpp, ncsnpp_state_dict_from_flax)


def test_wideresnet_round_trip():
    model = WideResNet(depth=10, widen_factor=2)
    _round_trip(model, translate_wideresnet, wideresnet_state_dict_from_flax)
    flax = _flax_zeros(JaxWRN(depth=10, widen_factor=2, normalize_input=False),
                       (1, 32, 32, 3))
    assert _shapes(wideresnet_state_dict_from_flax(flax)) == _shapes(model.state_dict())


def test_full_width_cifar_ncsnpp_matches_flax_tree():
    """configs/cifar10.yml's NCSN++: parameter count, and every key and
    shape of the inverse-translated flax tree."""
    with torch.device("meta"):
        model = NCSNpp()
    assert sum(p.numel() for p in model.parameters()) == CIFAR_PARAMS
    sd = ncsnpp_state_dict_from_flax(_flax_zeros(JaxNCSNpp(), (1, 32, 32, 3), (1,)))
    assert _shapes(sd) == _shapes(model.state_dict())


def test_registry_wrn_28_10_has_robustbench_keys():
    """The robustbench 'Standard' WRN-28-10 carries an unused sub_block1
    built like block1 (16 -> 160 channels, with a shortcut conv)."""
    with torch.device("meta"):
        model = get_classifier("cifar10-wideresnet-28-10")
    sd = _shapes(model.state_dict())
    for k, v in sd.items():
        if k.startswith("block1."):
            assert sd["sub_" + k] == v
    assert sd["fc.weight"] == (10, 640)
    n_run = sum(int(np.prod(v)) for k, v in sd.items() if not k.startswith("sub_")
                and "running" not in k and "num_batches" not in k)
    assert n_run == 36_479_194
