"""The port's CLI layer against diffpure_tpu's: parser, run directory, data
subset, checkpoint flow, resumable evaluation, and the CLI itself on the
CPU (``--device cpu``) on a seeded CIFAR-10 pickle fixture.

The CLI runs a narrow NCSN++ from a cifar10.yml the fixture writes, and a
narrow WRN in place of WRN-28-10 whose labels are its own predictions, so
that the attacks run (tests/test_cli.py runs the full-size models at t=2
with no attack).
"""
import functools
import logging
import os
import pickle
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from diffpure_tpu import config as jax_config
from diffpure_tpu.data import datasets as jax_datasets
from diffpure_tpu.models import convert as jax_convert
from diffpure_tpu_torch import cli
from diffpure_tpu_torch import config
from diffpure_tpu_torch.classifiers import WideResNet, registry
from diffpure_tpu_torch.data import cifar10_subset, load_data
from diffpure_tpu_torch.eval import drivers
from diffpure_tpu_torch.eval.resume import EvalCheckpoint, resumable_autoattack
from diffpure_tpu_torch.models import NCSNpp
from diffpure_tpu_torch.models.convert import load_score_sde_checkpoint
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

CLF = "cifar10-wideresnet-28-10"
NARROW = {"nf: 128": "nf: 16", "num_res_blocks: 8": "num_res_blocks: 1",
          "ch_mult: [1, 2, 2, 2]": "ch_mult: [1, 2]"}


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.required,
                     a.const, a.nargs) for a in parser._actions if a.dest != "help"}


def test_parser_has_jax_flags_and_device():
    want, got = _actions(jax_config.build_parser()), _actions(config.build_parser())
    assert set(got) == set(want) | {"device"}
    for dest, spec in want.items():
        assert got[dest] == spec, dest
    assert config.build_parser().parse_args(["--config", "c"]).device == "cuda"


def test_make_log_dir_matches_jax():
    args = SimpleNamespace(exp="./exp_results", image_folder="images", classifier_name=CLF,
                           diffusion_type="sde", attack_version="bpda", seed=3, data_seed=1)
    assert config.make_log_dir(args) == jax_config.make_log_dir(args)
    ns = config.dict2namespace({"a": {"b": 1}, "c": [1, 2]})
    assert config.namespace2dict(ns) == jax_config.namespace2dict(ns)


def _write_cifar(root, n=64, labels=None):
    rng = np.random.RandomState(0)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    data = (rng.rand(n, 3072) * 255).astype(np.uint8)
    if labels is None:
        labels = rng.randint(0, 10, n)
    with open(os.path.join(d, "test_batch"), "wb") as f:
        pickle.dump({b"data": data, b"labels": [int(v) for v in labels]}, f)
    return data


def test_cifar10_subset_and_shards_match_jax(tmp_path):
    root = str(tmp_path)
    _write_cifar(root)
    for num_sub, seed in ((-1, 0), (10, 0), (10, 3)):
        x, y = cifar10_subset(root, num_sub, seed)
        jx, jy = jax_datasets.cifar10_subset(root, num_sub, seed)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.dtype == np.float32 and x.shape[1:] == (32, 32, 3)
    for shard in range(3):
        got = load_data("cifar10", 10, 2, root=root, shard=shard, num_shards=3)
        want = jax_datasets.load_data("cifar10", 10, 2, root=root, shard=shard,
                                      num_shards=3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the CelebA-HQ reader is ported (test_torch_celebahq.py): here it
    # finds no <root>/celebahq
    with pytest.raises(FileNotFoundError, match="celebahq"):
        load_data("celebahq", 4, 0, root=root)
    # the ImageNet readers are ported (test_torch_imagenet_data.py): here
    # they find no <root>/imagenet/val
    with pytest.raises(FileNotFoundError, match="imagenet"):
        load_data("imagenet", 4, 0, root=root)


def test_score_sde_checkpoint_flow_matches_jax(tmp_path):
    """A DataParallel checkpoint with EMA shadow parameters: the port's
    state dict is JAX's params, key for key."""
    model = NCSNpp(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
                   image_size=32)
    sd = {k: torch.from_numpy(v) for k, v in seeded_normal_state_dict(model, 0).items()}
    shadow = [torch.from_numpy(v) for k, v in seeded_normal_state_dict(model, 1).items()
              if k != "sigmas"]
    path = tmp_path / "checkpoint_8.pth"
    torch.save(dict(model={f"module.{k}": v for k, v in sd.items()},
                    ema=dict(decay=0.9999, num_updates=8, shadow_params=shadow),
                    optimizer={}, step=8), path)
    got = load_score_sde_checkpoint(str(path))
    model.load_state_dict(got, strict=True)
    assert torch.equal(got["sigmas"], sd["sigmas"])
    assert torch.equal(got["all_modules.0.weight"], shadow[0])  # the EMA applied
    want = jax.tree_util.tree_leaves_with_path(jax_convert.load_score_sde_checkpoint(str(path)))
    mine = jax.tree_util.tree_leaves_with_path(
        jax_convert.translate_ncsnpp({k: v.numpy() for k, v in got.items()}))
    assert [p for p, _ in mine] == [p for p, _ in want]
    for (path_, a), (_, b) in zip(mine, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path_))


def test_eval_checkpoint_roundtrip_and_resume(tmp_path):
    ck = EvalCheckpoint(str(tmp_path))
    xa, rb = np.random.rand(3, 2, 2, 1).astype(np.float32), np.array([True, False, True])
    ck.save_phase("apgd-ce", xa, rb)
    again = EvalCheckpoint(str(tmp_path))
    assert again.has_phase("apgd-ce") and not again.has_phase("apgd-dlr")
    for got, want in zip(again.load_phase("apgd-ce"), (xa, rb)):
        np.testing.assert_array_equal(got, want)

    class StandIn:
        """AutoAttack's interface: each phase breaks one example."""
        attacks = ["apgd-ce", "apgd-dlr"]

        def __init__(self, allowed):
            self.allowed, self.lines = allowed, []

        def model_fn(self, x, seed):
            return torch.nn.functional.one_hot(torch.zeros(x.shape[0], dtype=torch.long), 3)

        def log(self, s):
            self.lines.append(s)

        def _run_one(self, name, x, y, seed):
            assert name in self.allowed, f"{name} ran again"
            found = torch.zeros(x.shape[0], dtype=torch.bool)
            found[self.attacks.index(name)] = True
            return x + 0.5, found

    x, y = torch.rand(4, 2, 2, 1), torch.zeros(4, dtype=torch.long)
    d = str(tmp_path / "run")
    xa1, r1 = resumable_autoattack(StandIn(StandIn.attacks), x, y, 0, log_dir=d)
    assert r1.tolist() == [False, False, True, True]
    assert torch.equal(xa1[:2], x[:2] + 0.5) and torch.equal(xa1[2:], x[2:])
    resumed = StandIn(())
    xa2, r2 = resumable_autoattack(resumed, x, y, 0, log_dir=d)
    assert torch.equal(xa2, xa1) and torch.equal(r2, r1)
    assert all("resumed" in s for s in resumed.lines)


def _narrow_wrn():
    return WideResNet(depth=10, widen_factor=1, sub_block1=True)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """dataset/ with 64 seeded images labelled by the narrow classifier's
    own predictions, configs/cifar10.yml narrowed, cwd there."""
    clf = _narrow_wrn().eval()
    clf.load_state_dict({k: torch.from_numpy(v)
                         for k, v in seeded_normal_state_dict(clf, 1).items()})
    data = _write_cifar(str(tmp_path / "dataset"))
    x = torch.from_numpy(data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32)
                         / 255.0)
    with torch.no_grad():
        labels = clf(x).argmax(-1).numpy()
    _write_cifar(str(tmp_path / "dataset"), labels=labels)
    (tmp_path / "configs").mkdir()
    with open(os.path.join(os.path.dirname(__file__), "..", "configs", "cifar10.yml")) as f:
        text = f.read()
    for a, b in NARROW.items():
        text = text.replace(a, b)
    (tmp_path / "configs" / "cifar10.yml").write_text(text)
    monkeypatch.setitem(registry._REGISTRY, CLF, _narrow_wrn)
    monkeypatch.chdir(tmp_path)
    return tmp_path


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


SCRIPT = ["--exp", "./exp_results", "--seed", "0", "--data_seed", "0",
          "--config", "cifar10.yml", "--domain", "cifar10", "--diffusion_type", "sde",
          "--score_type", "score_sde", "--adv_eps", "0.031373", "--classifier_name", CLF,
          "--random_weights", "--device", "cpu"]


def test_cli_bpda_on_cpu(workdir):
    res = _run_cli(SCRIPT + ["--attack_version", "bpda", "--num_sub", "4",
                             "--adv_batch_size", "4", "--adv_steps", "1",
                             "--eot_attack_reps", "2", "--eot_defense_reps", "2", "--t", "3"])
    log_dir = os.path.join("exp_results", "images", CLF, "sde_bpda", "seed0", "data0")
    assert res["classifier_init_acc"] == 1.0  # labels are the classifier's
    assert res["class_batch"].shape == (3, 4)
    x_adv = np.load(os.path.join(log_dir, "x_adv_bpda.npy"))
    x, _ = cifar10_subset("dataset", 4, 0)
    assert x_adv.shape == x.shape and np.abs(x_adv - x).max() <= 0.031373 + 1e-6
    with open(os.path.join(log_dir, "log.txt")) as f:
        log = f.read()
    # the defence vote, two PGD steps and any verification, 3 evaluations each
    assert "NFE total=" in log and "results: {" in log and "sde_euler=" in log
    assert "on cpu" in log


def test_cli_rand_on_cpu(workdir, monkeypatch):
    """The rand suite with APGD cut to 4 iterations (the CLI has no flag for
    it: 100 iterations through even a narrow defence take a minute here)."""
    monkeypatch.setattr(drivers, "AutoAttackConfig",
                        functools.partial(drivers.AutoAttackConfig, n_iter=4))
    res = _run_cli(SCRIPT + ["--attack_version", "rand", "--num_sub", "2",
                             "--adv_batch_size", "2", "--t", "2", "--eot_iter", "1"])
    assert res["classifier_robust_acc"] <= 1.0 and res["defended_robust_acc"] <= 1.0
    assert tuple(res["x_adv"].shape) == (2, 32, 32, 3)
    log_dir = os.path.join("exp_results", "images", CLF, "sde_rand", "seed0", "data0")
    assert os.path.exists(os.path.join(log_dir, "x_adv_defended_rand.npy"))


def test_cli_refuses_cuda_without_a_card(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_cli(SCRIPT[:-2] + ["--attack_version", "bpda"])
    assert not os.path.exists("exp_results")  # refused before any work
    # every domain of the reference runs since item 17; an unknown one raises
    with pytest.raises(NotImplementedError, match="unknown domain"):
        _run_cli(SCRIPT + ["--attack_version", "bpda", "--domain", "mnist"])


def test_cli_stadv_on_cpu(workdir, monkeypatch):
    """run_cifar_stadv_rn50.sh's attack through the CLI on the CPU (item 13):
    the narrow NCSN++ and WRN of the fixture, t = 2, StAdv cut from the
    CLI's 100 iterations to 2, one EOT sample."""
    kwargs = cli._attack_kwargs
    monkeypatch.setattr(cli, "_attack_kwargs", lambda args: {**kwargs(args), "n_iter": 2})
    res = _run_cli(SCRIPT + ["--attack_version", "stadv", "--adv_eps", "0.05", "--t", "2",
                             "--num_sub", "2", "--adv_batch_size", "2", "--eot_iter", "1"])
    assert set(res) == {"classifier_robust_acc", "defended_clean_acc", "defended_robust_acc",
                        "x_adv"}
    assert all(0.0 <= res[k] <= 1.0 for k in res if k != "x_adv")
    x_adv = res["x_adv"]
    assert tuple(x_adv.shape) == (2, 32, 32, 3) and 0 <= float(x_adv.min()) <= float(x_adv.max()) <= 1
    log_dir = os.path.join("exp_results", "images", CLF, "sde_stadv", "seed0", "data0")
    for name in ("x_adv_classifier_stadv.npy", "x_adv_defended_stadv.npy"):
        assert os.path.exists(os.path.join(log_dir, name)), name


def test_cli_celebahq_models_and_checkpoints(tmp_path, monkeypatch):
    """The celebahq domain (item 17): build_score_model builds SDEdit's DDPM
    UNet at --precision and loads pretrained/celebahq/celeba_hq.ckpt (a
    DataParallel state dict); build_classifier loads
    pretrained/celebahq/<attribute>/net_best.pth (with a constant buffer the
    model does not hold). A narrow UNet stands in for the full width."""
    from diffpure_tpu_torch import models
    from diffpure_tpu_torch.classifiers.attribute import AttributeClassifier
    from diffpure_tpu_torch.models import DDPMUNet

    small = functools.partial(DDPMUNet, resolution=32, ch=32, ch_mult=(1, 2),
                              num_res_blocks=1, attn_resolutions=(16,))
    monkeypatch.setattr(models, "DDPMUNet", small)
    monkeypatch.chdir(tmp_path)
    unet_sd = {k: torch.from_numpy(v) for k, v in seeded_normal_state_dict(small(), 5).items()}
    clf_sd = {k: torch.from_numpy(v)
              for k, v in seeded_normal_state_dict(AttributeClassifier(), 6).items()}
    os.makedirs("pretrained/celebahq/Smiling")
    torch.save({"module." + k: v for k, v in unet_sd.items()}, "pretrained/celebahq/celeba_hq.ckpt")
    torch.save({**clf_sd, "lod_in": torch.tensor(0.0)}, "pretrained/celebahq/Smiling/net_best.pth")
    args = config.build_parser().parse_args(
        ["--config", "celeba.yml", "--domain", "celebahq", "--diffusion_type", "celebahq-ddpm",
         "--classifier_name", "celebahq__Smiling", "--precision", "bf16"])
    args.random_weights = False
    cpu = torch.device("cpu")
    score = cli.build_score_model(args, None, cpu)
    assert score.dtype == torch.bfloat16 and not any(p.requires_grad for p in score.parameters())
    for k, v in score.state_dict().items():
        assert torch.equal(v, unet_sd[k]), k
    clf = cli.build_classifier(args, cpu)
    assert isinstance(clf, AttributeClassifier)
    for k, v in clf.state_dict().items():
        assert torch.equal(v, clf_sd[k]), k
    with torch.inference_mode():
        out = clf(torch.rand(1, 256, 256, 3))
    assert tuple(out.shape) == (1, 2) and torch.equal(out[:, 0], -out[:, 1])
