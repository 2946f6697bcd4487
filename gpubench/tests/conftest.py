"""Fixtures of the benchmark's own tests: tiny configurations and cells in
a temporary directory laid out as ``gpubench/`` is, so a whole run goes
through the harness on the CPU in seconds.

    python -m pytest gpubench/tests -q
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench.lib import manifest  # noqa: E402

TINY_CONFIGS = {
    "tiny-ncsnpp-wrn": {
        "name": "tiny-ncsnpp-wrn", "source": "a narrow copy of cifar10-ncsnpp-wrn28-fp32",
        "reduced": ["nf", "ch_mult", "num_res_blocks", "image_size"], "dtype": "float32",
        "input_size": 16, "classes": 10,
        "purify": {"score_type": "score_sde", "beta_min": 0.1, "beta_max": 20.0},
        "score_model": {"family": "ncsnpp", "args": {
            "image_size": 16, "nf": 16, "ch_mult": [1, 2], "num_res_blocks": 1,
            "attn_resolutions": [8]}},
        "classifier": {"family": "wrn", "args": {"depth": 10, "widen_factor": 1,
                                                  "num_classes": 10}},
        "flops": {"score_forward": 1.0, "classifier_forward": 1.0}},
    "tiny-adm-rn": {
        "name": "tiny-adm-rn", "source": "a narrow copy of imagenet256-adm-rn50-bf16",
        "reduced": ["model_channels", "channel_mult", "num_res_blocks", "image_size"],
        "dtype": "float32", "input_size": 24, "classes": 10,
        "purify": {"score_type": "guided_diffusion", "beta_min": 0.1, "beta_max": 20.0,
                   "resize_to": 32},
        "score_model": {"family": "adm", "args": {
            "image_size": 32, "model_channels": 32, "out_channels": 6, "num_res_blocks": 1,
            "attention_resolutions": [2], "channel_mult": [1, 2], "num_head_channels": 16,
            "use_flash": True}},
        "classifier": {"family": "resnet", "args": {"layers": [1, 1, 1, 1], "num_classes": 10}},
        "flops": {"score_forward": 1.0, "classifier_forward": 1.0}},
}
TINY_CELLS = {
    "tiny-purify": {"config": "tiny-ncsnpp-wrn", "entry": "purify", "batch": 4, "t_star": 5,
                    "chips": 1, "check_rows": 4, "trace": {"start": 1, "steps": 2}},
    "tiny-adm-purify": {"config": "tiny-adm-rn", "entry": "purify", "batch": 2, "t_star": 4,
                        "chips": 1, "check_rows": 2, "trace": {"start": 1, "steps": 2}},
    "tiny-eotgrad": {"config": "tiny-ncsnpp-wrn", "entry": "eotgrad", "batch": 4, "t_star": 5,
                     "eot_samples": 2, "chips": 1, "check_rows": 4, "reference": "fp64"},
}
# the end-to-end rate each tiny cell reports, as its full-size cell does
TINY_RATES = {"tiny-purify": "purify_img_per_s", "tiny-adm-purify": "adm_purify_img_per_s",
              "tiny-eotgrad": "grad_img_per_s"}
# on the CPU the program runs its plain paths in fp32: it meets the
# reference to rounding
TINY_LIMITS = {"purify": {"purified_rel_err": 1e-4, "logits_rel_err": 1e-4},
               "eotgrad": {"grad_octile_rel_err": 1e-4, "grad_rel_err": 1e-4,
                           "logits_rel_err": 1e-4}}


def tiny_bench() -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": n, "config": c["config"], "traffic": n, "chips": 1,
                           "why": "a tiny cell of the benchmark's tests"}
                          for n, c in TINY_CELLS.items()]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [n for n in TINY_CELLS if TINY_RATES[n] == m["name"]]
    for m in bench["per_layer"]:
        m["workloads"] = [n for n in TINY_CELLS if TINY_RATES[n] == m["moves"]]
    return bench


@pytest.fixture
def tiny(tmp_path):
    """(base directory, benchmark manifest) of the tiny cells."""
    for d in ("configs", "workloads"):
        (tmp_path / d).mkdir()
    shutil.copytree(manifest.HERE / "metrics", tmp_path / "metrics")
    for n, c in TINY_CONFIGS.items():
        (tmp_path / "configs" / f"{n}.json").write_text(json.dumps(c))
    for n, w in TINY_CELLS.items():
        w = dict(w, limits=TINY_LIMITS[w["entry"]], why="a tiny cell")
        (tmp_path / "workloads" / f"{n}.json").write_text(json.dumps(w))
    return tmp_path, tiny_bench()


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card with python -m pytest gpubench/tests -m card")
    return torch.device("cuda:0")
