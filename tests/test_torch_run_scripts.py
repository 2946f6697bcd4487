"""The port's run scripts opened by ROADMAP items 11, 12 and 14
(run_scripts/torch/): the twelve CIFAR-10 scripts (ResNet-50, WRN-70-16
with dropout, the ODE purifier, the standard suite) and the three ImageNet
``stand`` scripts.

- each keeps its original's flags (run_scripts/cifar10/, imagenet/) and
  calls ``python -m diffpure_tpu_torch.cli``;
- each script's flags, read from the script, go through ``cli.main`` on the
  CPU with the models, the data and the attack replaced by recorders: the
  classifier the registry builds (full width, on the meta device), the
  purifier's config and the suite's config are the ones the flags name;
- the standard suite end to end through the CLI on the CPU with the ODE
  script's flags: a narrow NCSN++ and WRN (the fixture of
  tests/test_torch_cli.py), t = 2, the suite cut to 2 iterations, 2
  targets and 4 Square queries.
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

import diffpure_tpu_torch.data as data_mod
from diffpure_tpu_torch import cli
from diffpure_tpu_torch.classifiers import get_classifier
from diffpure_tpu_torch.eval import drivers
from test_torch_cli import _run_cli, workdir  # noqa: F401  (a fixture)
from torch_parity import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

REPO = os.path.join(os.path.dirname(__file__), "..")
CIFAR = ["rand_inf_rn50", "rand_inf_70-16-dp", "rand_inf_ode", "rand_L2_70-16-dp",
         "rand_L2_rn50_eps1", "stand_inf", "stand_inf_rn50", "stand_inf_70-16-dp",
         "stand_inf_ode", "stand_L2", "stand_L2_70-16-dp", "stand_L2_rn50_eps1"]
SCRIPTS = [("cifar10", f"run_cifar_{n}.sh") for n in CIFAR] + [
    ("imagenet", f"run_in_stand_inf{n}.sh") for n in ("", "_50-2", "_deits")]


def _flags(path):
    with open(path) as f:
        text = f.read()
    return dict(re.findall(r"^\s+(--\w+) (\S+)", text, re.M)), text


def test_every_cifar_script_but_stadv_has_a_port():
    """Of the reference's CIFAR-10 scripts only the StAdv one (item 13)
    waits."""
    orig = set(os.listdir(os.path.join(REPO, "run_scripts", "cifar10")))
    port = set(os.listdir(os.path.join(REPO, "run_scripts", "torch", "cifar10")))
    assert orig - port == {"run_cifar_stadv_rn50.sh"}
    assert len(port) == 15


@pytest.mark.parametrize("domain,name", SCRIPTS)
def test_script_keeps_the_original_flags(domain, name):
    port, text = _flags(os.path.join(REPO, "run_scripts", "torch", domain, name))
    orig, _ = _flags(os.path.join(REPO, "run_scripts", domain, name))
    assert port == orig
    assert "python -m diffpure_tpu_torch.cli" in text
    assert 'cd "$(dirname "$0")/../../.."' in text


@pytest.mark.parametrize("domain,name", SCRIPTS)
def test_script_flags_reach_the_right_models_and_suite(domain, name, monkeypatch, tmp_path):
    flags, _ = _flags(os.path.join(REPO, "run_scripts", "torch", domain, name))
    flags.update({"--seed": "0", "--data_seed": "0"})
    seen = {}

    def classifier(args, device):
        with torch.device("meta"):
            seen["classifier"] = type(get_classifier(args.classifier_name)).__name__
        seen["classifier_name"] = args.classifier_name
        return lambda x: x

    def attack(defended, x, y, seed, aa_cfg, log_dir=None, log=print):
        seen.update(purify=defended.purify_cfg, suite=aa_cfg, x=tuple(x.shape),
                    resize_to=defended.resize_to)
        return dict(classifier_robust_acc=1.0, defended_robust_acc=1.0, x_adv=x)

    size = 224 if domain == "imagenet" else 32
    monkeypatch.setattr(cli, "build_score_model", lambda args, config, device: None)
    monkeypatch.setattr(cli, "build_classifier", classifier)
    monkeypatch.setattr(data_mod, "load_data", lambda domain, n, seed, **kw: (
        np.zeros((n, size, size, 3), np.float32), np.zeros(n, np.int64)))
    monkeypatch.setattr(drivers, "eval_autoattack", attack)
    monkeypatch.chdir(tmp_path)
    argv = [t for kv in flags.items() for t in kv]
    argv[argv.index("--config") + 1] = os.path.join(REPO, "configs", flags["--config"])
    _run_cli(argv + ["--device", "cpu", "--random_weights"])

    want_clf = {"cifar10-resnet-50": "CifarResNet50",
                "cifar10-wrn-70-16-dropout": "WideResNet",
                "cifar10-wideresnet-28-10": "WideResNet",
                "imagenet-resnet50": "TorchvisionResNet",
                "imagenet-wideresnet-50-2": "TorchvisionResNet",
                "imagenet-deit-s": "ViT"}
    assert seen["classifier_name"] == flags["--classifier_name"]
    assert seen["classifier"] == want_clf[flags["--classifier_name"]]
    p, s = seen["purify"], seen["suite"]
    assert p.diffusion_type == flags["--diffusion_type"] and p.t == int(flags["--t"])
    assert p.score_type == flags["--score_type"] and p.grad_mode == "checkpoint"
    assert p.step_size == float(flags.get("--step_size", 1e-3))
    assert seen["resize_to"] == (256 if domain == "imagenet" else None)
    assert s.version == flags["--attack_version"]
    assert s.norm == flags.get("--lp_norm", "Linf") and s.eps == float(flags["--adv_eps"])
    # the standard suite runs without EOT, rand with the script's
    assert s.eot_iter == (1 if s.version == "standard" else int(flags["--eot_iter"]))
    assert seen["x"] == (int(flags["--num_sub"]), size, size, 3)


def test_cli_standard_suite_on_cpu(workdir, monkeypatch):  # noqa: F811
    """run_cifar_stand_inf_ode.sh's flags end to end: the ODE purifier and
    APGD-CE, APGD-T, FAB-T and Square through it (tiny budget; an eps small
    enough that APGD leaves examples to the later attacks)."""
    flags, _ = _flags(os.path.join(REPO, "run_scripts", "torch", "cifar10",
                                   "run_cifar_stand_inf_ode.sh"))
    flags.update({"--seed": "0", "--data_seed": "0", "--num_sub": "2", "--adv_batch_size": "2",
                  "--t": "2", "--adv_eps": "0.001"})
    monkeypatch.setattr(drivers, "AutoAttackConfig", functools.partial(
        drivers.AutoAttackConfig, n_iter=2, apgd_t_n_target_classes=2,
        fab_n_target_classes=2, square_n_queries=4))
    res = _run_cli([t for kv in flags.items() for t in kv] + ["--random_weights",
                                                              "--device", "cpu"])
    assert 0.0 <= res["defended_robust_acc"] <= 1.0
    x_adv = res["x_adv"]
    assert tuple(x_adv.shape) == (2, 32, 32, 3) and bool(torch.isfinite(x_adv).all())
    log_dir = os.path.join("exp_results", "images", "cifar10-wideresnet-28-10", "ode_standard",
                           "seed0", "data0")
    assert os.path.exists(os.path.join(log_dir, "x_adv_defended_standard.npy"))
    with open(os.path.join(log_dir, "log.txt")) as f:
        log = f.read()
    assert "ode_euler=" in log
    for name in ("apgd-ce", "apgd-t", "fab-t", "square"):
        assert f"[sde] {name}: robust accuracy" in log, name
