"""The defence demonstration's functions and entry point on the port, on
the CPU, with tiny models:
- ``train_demo_classifier`` / ``train_demo_score`` (the EMA weights kept,
  the weights frozen for the attacks);
- ``run_demo_protocol``'s per-phase checkpoints through the standard suite,
  and ``run_dose_response``;
- ``python -m diffpure_tpu_torch.experiments.defense_demo``: the flags of
  scripts/defense_demo.py plus ``--device``, the presets, the weight cache
  and its training key, ``--device cuda`` without a card.
"""
import argparse
import dataclasses
import importlib.util
import os

import pytest
import torch

from diffpure_tpu_torch.experiments import defense_demo as demo
from diffpure_tpu_torch.utils.prng import fold_in, generator
from torch_parity import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


TINY = dict(size=8, t_star=2, n_eval=4, apgd_iter=1, eot_iter=1, aa_iter=1, defense_reps=2,
            score_nf=8, score_ch_mult=(1, 2), score_blocks=1, clf_steps=200,
            clf_train_size=128, aa_attacks=("apgd-ce", "apgd-t"), score_steps=2,
            score_batch=4, score_warmup=1)


@pytest.fixture(scope="module")
def tiny_models():
    cfg = demo.DemoConfig(**TINY)
    clf = demo.train_demo_classifier(cfg, device="cpu")
    score = demo.train_demo_score(cfg, log=lambda s: None, device="cpu")
    return cfg, clf, score


def test_trained_models(tiny_models):
    cfg, clf, score = tiny_models
    assert not any(p.requires_grad for p in score.parameters())
    fresh = demo.demo_score_model(cfg).init_(generator(fold_in(cfg.seed, 2)))
    moved = [not torch.equal(a, b) for a, b in zip(score.parameters(), fresh.parameters())]
    assert any(moved)  # the EMA of two Adam steps (the first at lr 0) is not the init
    x01 = torch.rand(3, 8, 8, 3)
    assert clf(x01).shape == (3, 4)


def test_protocol_checkpoints_every_phase(tiny_models):
    cfg, clf, score = tiny_models
    snapshots = []
    results = demo.run_demo_protocol(cfg, score, clf, attacks=("aa-standard",),
                                     diffusion_types=("dpm",), log=lambda s: None,
                                     checkpoint=lambda r: snapshots.append(
                                         {k: dict(v) if isinstance(v, dict) else v
                                          for k, v in r.items()}))
    assert len(snapshots) >= 4 and "robust_acc_undefended" in snapshots[0]
    for tag in ("dpm20",):
        names = [p["attack"] for p in results[tag]["aa_per_attack"]]
        assert names and names == ["apgd-ce", "apgd-t"][:len(names)], names
        assert 0 <= results[tag]["robust_acc_aa_standard"] <= 1
    assert any(len(s.get("dpm20", {}).get("aa_per_attack", [])) == 1 for s in snapshots)
    curve = demo.run_dose_response(cfg, score, clf, t_values=(0, 2), log=lambda s: None)
    assert set(curve) == {0, 2} and all(0 <= v["robust_acc"] <= 1 for v in curve.values())


def _jax_script_parser():
    """scripts/defense_demo.py builds its parser inside main(): run main up
    to parse_args and take the parser there."""
    spec = importlib.util.spec_from_file_location(
        "jax_defense_demo_script", os.path.join(REPO, "scripts", "defense_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = []

    class Stop(Exception):
        pass

    def grab(self, *a, **k):
        seen.append(self)
        raise Stop

    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser, "parse_args", grab)
    try:
        with pytest.raises(Stop):
            mod.main()
    finally:
        mp.undo()
    return seen[0]


def _actions(parser):
    return {a.dest: (a.option_strings, a.default, a.type, a.nargs, a.const)
            for a in parser._actions if a.dest != "help"}


def test_parser_is_the_scripts_plus_device():
    want, got = _actions(_jax_script_parser()), _actions(demo.build_parser())
    assert set(got) == set(want) | {"device"}
    for dest, spec in want.items():
        if dest == "out":  # JAX writes into docs/; the port's default keeps out of it
            assert got[dest][0] == spec[0]
            continue
        assert got[dest] == spec, dest
    args = demo.build_parser().parse_args(["--large", "--hard", "--n_eval", "3"])
    assert args.device == "cuda"
    cfg = demo.config_from_args(args)
    assert (cfg.score_nf, cfg.score_blocks, cfg.size, cfg.n_classes, cfg.n_eval) == \
        (128, 8, 32, 8, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            demo.main(["--out", "unused"])
    assert demo.resolve_device(demo.build_parser().parse_args(
        ["--platform", "cpu"])).type == "cpu"
    # fp32 stays fp32 on the card: the entry point turns cuDNN's TF32 off
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_entry_point_on_the_cpu_from_the_weight_cache(tmp_path):
    argv = ["--device", "cpu", "--out", str(tmp_path), "--size", "8", "--score_nf", "8",
            "--n_eval", "4", "--apgd_iter", "1", "--eot_iter", "1", "--sweep", "0,2"]
    run_cfg = demo.config_from_args(demo.build_parser().parse_args(argv))
    # the cache is keyed by the training fields: write one for this config
    blob = {"config": dataclasses.asdict(run_cfg),
            "clf": demo.demo_classifier(run_cfg).init_(generator(1)).state_dict(),
            "score": demo.demo_score_model(run_cfg).init_(generator(2)).state_dict()}
    torch.save(blob, tmp_path / "trained_weights.pt")
    results = demo.main(argv)
    assert set(results["dose_response"]) == {0, 2} and results["platform"] == "cpu"
    assert os.path.exists(tmp_path / "dose_response.json")
    blob["config"] = dict(blob["config"], score_steps=7)
    torch.save(blob, tmp_path / "trained_weights.pt")
    with pytest.raises(ValueError, match="different DemoConfig"):
        demo.main(argv)
