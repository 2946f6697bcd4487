"""The port's CLI on the ImageNet domain, on the CPU (``--device cpu``), with
the flags of each of the three rand run scripts
(run_scripts/torch/imagenet/run_in_rand_inf*.sh), read from the script,
and a tiny budget: 1 image at t*=1, APGD cut to 2 iterations, one EOT
sample.

The fixture writes a seeded image folder and a configs/imagenet.yml with
the ADM narrowed (32 channels, one block a level, attention at 8 x 8 only,
fp32); each script's classifier is a narrow one of its architecture whose
logits carry a large constant bias towards class 0, the fixture's only
label, so that every example starts robust and APGD runs through the
defence (DefendedModel(resize_to=256): the ADM at 256 x 256).
"""
import functools
import io
import logging
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from diffpure_tpu_torch import cli
from diffpure_tpu_torch.classifiers import registry
from diffpure_tpu_torch.classifiers.common import IMAGENET_MEAN, IMAGENET_STD
from diffpure_tpu_torch.classifiers.resnet import TorchvisionResNet
from diffpure_tpu_torch.classifiers.vit import ViT
from diffpure_tpu_torch.data import load_data
from diffpure_tpu_torch.eval import drivers

REPO = os.path.join(os.path.dirname(__file__), "..")
SCRIPTS = {"run_in_rand_inf.sh": "imagenet-resnet50",
           "run_in_rand_inf_50-2.sh": "imagenet-wideresnet-50-2",
           "run_in_rand_inf_deits.sh": "imagenet-deit-s"}
NARROW = {"num_channels: 256": "num_channels: 32", "num_res_blocks: 2": "num_res_blocks: 1",
          'attention_resolutions: "32,16,8"': 'attention_resolutions: "8"',
          "use_fp16: true": "use_fp16: false"}
# the budget the test cuts the scripts' runs to
BUDGET = {"--num_sub": "1", "--adv_batch_size": "1", "--t": "1", "--eot_iter": "1"}
_IMAGENET = dict(input_norm=(IMAGENET_MEAN, IMAGENET_STD), num_classes=3)  # DLR needs three
NARROW_CLASSIFIERS = {
    "imagenet-resnet50": lambda: TorchvisionResNet(layers=(1, 1, 1, 1), **_IMAGENET),
    "imagenet-wideresnet-50-2": lambda: TorchvisionResNet(layers=(1, 1, 1, 1),
                                                          width_per_group=128, **_IMAGENET),
    "imagenet-deit-s": lambda: ViT(embed_dim=32, depth=1, num_heads=2, **_IMAGENET)}


class _TowardsClassZero(torch.nn.Module):
    """The classifier's logits + (20, 0, 0): class 0 wins whatever the weights
    (the CLI loads seeded random ones into ``net``)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return self.net(x) + torch.tensor([20.0, 0.0, 0.0])


def script_flags(name):
    """The script's ``--flag value`` pairs, the budget's in place of its own."""
    with open(os.path.join(REPO, "run_scripts", "torch", "imagenet", name)) as f:
        pairs = re.findall(r"^\s+(--\w+) (\S+)", f.read(), re.M)
    flags = {k: v for k, v in pairs if not v.startswith("$")}
    flags.update({"--seed": "0", "--data_seed": "0", **BUDGET})
    return [t for kv in flags.items() for t in kv]


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    d = tmp_path / "dataset" / "imagenet" / "val" / "n01440764"
    d.mkdir(parents=True)
    for i, (w, h) in enumerate(((300, 260), (260, 280), (240, 320))):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "JPEG")
        (d / f"{i}.JPEG").write_bytes(buf.getvalue())
    (tmp_path / "configs").mkdir()
    with open(os.path.join(REPO, "configs", "imagenet.yml")) as f:
        text = f.read()
    for a, b in NARROW.items():
        assert a in text
        text = text.replace(a, b)
    (tmp_path / "configs" / "imagenet.yml").write_text(text)
    for name, make in NARROW_CLASSIFIERS.items():
        monkeypatch.setitem(registry._REGISTRY, name, lambda make=make: _TowardsClassZero(make()))
    monkeypatch.setattr(drivers, "AutoAttackConfig",
                        functools.partial(drivers.AutoAttackConfig, n_iter=2))
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield tmp_path
    torch.set_num_threads(threads)


def _run_cli(argv):
    out, err, handlers = sys.stdout, sys.stderr, list(logging.getLogger().handlers)
    try:
        return cli.main(argv)
    finally:
        for stream in (sys.stdout, sys.stderr):
            if stream not in (out, err):
                stream.close()
        sys.stdout, sys.stderr = out, err
        logging.getLogger().handlers = handlers


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_imagenet_rand_script_on_cpu(workdir, script):
    flags = script_flags(script)
    assert flags[flags.index("--classifier_name") + 1] == SCRIPTS[script]
    assert flags[flags.index("--domain") + 1] == "imagenet"
    res = _run_cli(flags + ["--random_weights", "--device", "cpu"])
    assert 0.0 <= res["defended_robust_acc"] <= 1.0
    x_adv = res["x_adv"]
    assert tuple(x_adv.shape) == (1, 224, 224, 3)
    x, _ = load_data("imagenet", 1, 0)
    assert float((x_adv - torch.from_numpy(x)).abs().max()) <= 0.0157 + 1e-6
    assert 0.0 <= float(x_adv.min()) and float(x_adv.max()) <= 1.0
    log_dir = os.path.join("exp_results", "images", SCRIPTS[script], "sde_rand", "seed0",
                           "data0")
    with open(os.path.join(log_dir, "log.txt")) as f:
        log = f.read()
    assert "NFE total=" in log and "results: {" in log and "on cpu" in log
    # both APGD runs went through the defence's gradient
    assert len(re.findall(r"\[sde\] apgd-(ce|dlr): robust accuracy .*\(attacked 1,", log)) == 2
