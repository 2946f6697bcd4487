"""The port's CIFAR classifier zoo against diffpure_tpu's (ROADMAP item 14).

- ``CifarResNet50`` at its full [3, 4, 6, 3] depth, and small
  ``WideResNet`` (depth 16, width 2, internal normalisation as
  wrn_70_16_dropout builds it; JAX's side with its dropout 0.3, inactive
  in eval) and ``DMWideResNet`` (depth 10, width 1,
  with and without padding) against JAX's models on the same seeded
  weights, batch 2, at 1e-4 of max |logit|. The weights reach JAX through
  JAX's own translator run on the port's state dict (so the port's keys are
  the ones the torch checkpoints carry), and come back through the port's
  converter (an exact round trip);
- every CIFAR name of JAX's registry builds in the port, and its full-width
  state dict translates (JAX's translator) to exactly JAX's param tree;
- the CLI's checkpoint paths for the reference's own CIFAR classifiers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.classifiers import convert as jcv
from diffpure_tpu.classifiers import registry as jreg
from diffpure_tpu.classifiers.resnet import CifarResNet50 as JaxResNet50
from diffpure_tpu.classifiers.wideresnet import DMWideResNet as JaxDM
from diffpure_tpu.classifiers.wideresnet import WideResNet as JaxWRN
from diffpure_tpu_torch import cli
from diffpure_tpu_torch.classifiers import CifarResNet50, DMWideResNet, WideResNet, \
    get_classifier
from diffpure_tpu_torch.classifiers.convert import cifar_resnet_state_dict_from_flax, \
    dm_wideresnet_state_dict_from_flax, wideresnet_state_dict_from_flax
from diffpure_tpu_torch.models.convert import flatten_params
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from test_torch_convert import _round_trip
from torch_parity import assert_close
from torch_parity import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

CASES = {
    "resnet50": (CifarResNet50, lambda: JaxResNet50(), jcv.translate_cifar_resnet,
                 cifar_resnet_state_dict_from_flax),
    "wrn16_2_dropout": (lambda: WideResNet(depth=16, widen_factor=2, normalize_input=True),
                        lambda: JaxWRN(depth=16, widen_factor=2, drop_rate=0.3),
                        jcv.translate_wideresnet, wideresnet_state_dict_from_flax),
    "dm10_1": (lambda: DMWideResNet(depth=10, width=1), lambda: JaxDM(depth=10, width=1),
               jcv.translate_dm_wideresnet, dm_wideresnet_state_dict_from_flax),
    "dm10_1_pad2": (lambda: DMWideResNet(depth=10, width=1, padding=2),
                    lambda: JaxDM(depth=10, width=1, padding=2),
                    jcv.translate_dm_wideresnet, dm_wideresnet_state_dict_from_flax),
}


@pytest.mark.parametrize("case", list(CASES))
def test_classifier_matches_jax(case):
    make, make_jax, translate, from_flax = CASES[case]
    model = make().eval()
    sd = seeded_normal_state_dict(model, 3)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    x = np.random.default_rng(4).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = jax.jit(make_jax().apply)(translate(sd), jnp.asarray(x))
    assert got.shape == (2, 10)
    assert_close(got, want, 1e-4, case)
    # and the converter carries JAX's params back exactly
    _round_trip(make(), translate, from_flax)


def test_dm_block_pads_bottom_right_on_stride_two():
    """The stride-2 conv_0 reads the (0, 1, 0, 1)-padded map: its output
    differs from a symmetric padding=1 conv (the trap the reference keeps)."""
    from diffpure_tpu_torch.classifiers.wideresnet import DMBlock
    from diffpure_tpu_torch.ops.conv import conv2d_nhwc

    blk = DMBlock(4, 8, 2).eval().requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8, 8, 4)).astype(np.float32))
    pre = torch.nn.functional.silu(blk.batchnorm_0(x))
    got = conv2d_nhwc(torch.nn.functional.pad(pre, (0, 0, 0, 1, 0, 1)), blk.conv_0.weight,
                      stride=2, padding=0)
    sym = conv2d_nhwc(pre, blk.conv_0.weight, stride=2, padding=1)
    assert got.shape == sym.shape == (1, 4, 4, 8)
    assert float((got - sym).abs().max()) > 1e-3


JAX_CIFAR = [n for n in jreg.CLASSIFIER_NAMES if n.startswith("cifar10")]


def _zero_views(sd):
    """Zero-cost read-only numpy stand-ins of the state dict's tensors."""
    return {k: np.broadcast_to(np.zeros((), np.float32), tuple(v.shape)) for k, v in sd.items()}


@pytest.mark.parametrize("name", JAX_CIFAR)
def test_registry_builds_every_cifar_classifier_with_jax_keys(name):
    """Full width on the meta device: JAX's translator of the port's state
    dict gives exactly the leaves and shapes of JAX's param tree."""
    assert len(JAX_CIFAR) == 9
    with torch.device("meta"):
        model = get_classifier(name)
    jmodel, translate, _ = jreg.get_classifier(name)
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    want = {k: tuple(v.shape) for k, v in flatten_params(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree))}
    got = {k: tuple(v.shape) for k, v in flatten_params(translate(_zero_views(model.state_dict())))}
    if name == "cifar10-wideresnet-28-10":
        # JAX builds the never-run sub_block1 on block1's output, unlike
        # robustbench (ROADMAP Queue 3); the port keeps robustbench's keys
        got, want = ({k: v for k, v in d.items() if k[0] != "sub_block1"} for d in (got, want))
    assert got == want


def test_registry_widths():
    """WRN-70-16 (dropout and DeepMind) at the reference's size; the
    dropout variant normalises inside, the robustbench WRN-28-10 does not."""
    with torch.device("meta"):
        dp = get_classifier("cifar10-wrn-70-16-dropout")
        dm = get_classifier("cifar10-wrn-70-16-at0")
        rn = get_classifier("cifar10-resnet-50")
        std = get_classifier("cifar10-wideresnet-28-10")
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert count(dp) == 266_796_506
    assert count(dm) == 266_796_506
    assert count(rn) == 23_520_842
    assert dp.normalize_input and not std.normalize_input


def test_cli_checkpoint_paths(tmp_path, monkeypatch):
    """The reference's own CIFAR classifiers load from JAX's paths
    (cli.py:97-108), unwrapping ``state_dict`` and stripping ``module.``."""
    assert cli.CKPT_MAP == {
        "cifar10-resnet-50": "pretrained/cifar10/resnet-50/weights.pt",
        "cifar10-wrn-70-16-dropout": "pretrained/cifar10/wrn-70-16-dropout/weights.pt",
        "cifar10-wideresnet-70-16": "pretrained/cifar10/wresnet-76-10/weights-best.pt"}
    small = lambda: WideResNet(depth=10, widen_factor=1, normalize_input=True)  # noqa: E731
    from diffpure_tpu_torch.classifiers import registry
    monkeypatch.setitem(registry._REGISTRY, "cifar10-wrn-70-16-dropout", small)
    sd = {f"module.{k}": torch.from_numpy(v)
          for k, v in seeded_normal_state_dict(small(), 5).items()}
    path = tmp_path / "pretrained" / "cifar10" / "wrn-70-16-dropout" / "weights.pt"
    path.parent.mkdir(parents=True)
    torch.save({"state_dict": sd}, path)
    monkeypatch.chdir(tmp_path)

    class Args:
        classifier_name = "cifar10-wrn-70-16-dropout"
        random_weights = False

    model = cli.build_classifier(Args, torch.device("cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[f"module.{k}"]), k
