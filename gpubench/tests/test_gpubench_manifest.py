"""The benchmark's files: every configuration, cell and metric loads, keeps to
the manifest's rules, and nothing under gpubench/ imports JAX or the JAX
package."""
import ast
import json
import re

import pytest
import torch

from conftest import ROOT
from gpubench.counts import adm, blocks, flops, ncsnpp, peaks
from gpubench.lib import manifest

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|channels|nf$"
                    r"|ch_mult|widen")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and not word.startswith("/")


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
    assert c["file"] == f"gpubench/configs/{c['name']}.json"
    body = manifest.config(c["name"])
    assert body["reduced"] == c["reduced"] == []
    assert not any(WIDTHS.search(k) for k in c["reduced"])
    for spec in (body["score_model"], body["classifier"]):
        model = __import__("gpubench.models", fromlist=["family"]).family(spec["family"])
        n = sum(p.numel() for p in model.reference(spec["args"]).parameters())
        key = "score_model" if spec is body["score_model"] else "classifier"
        assert n == body["parameters"][key]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    body = manifest.workload(w["name"])
    assert body["config"] == w["config"] and body["why"] == w["why"]
    assert body["chips"] == w["chips"]
    assert (ROOT / "gpubench" / "entries" / f"{body['entry']}.py").exists()
    e2e = {m["name"] for m in manifest.end_to_end(BENCH, w["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer(BENCH, w["name"])
    assert set(body["limits"]) and all(v > 0 for v in body["limits"].values())
    assert len({(x["config"], x["traffic"]) for x in BENCH["workloads"]}) == len(BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in manifest.SOURCES
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        return
    reader = manifest.reader(m["name"])
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.BETTER, reader.MOVES) == (
        m["layer"], m["unit"], m["source"], m["better"], m["moves"])
    for cell in m["workloads"]:
        assert m["moves"] in {x["name"] for x in manifest.end_to_end(BENCH, cell)}
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_every_metric_file_is_listed():
    files = {p.stem for p in (ROOT / "gpubench" / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted((ROOT / "gpubench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "diffpure_tpu"}
    if "reference" in path.parts:
        assert "diffpure_tpu_torch" not in tops and tops <= {"__future__", "math", "typing",
                                                             "numpy", "torch", "gpubench"}
        assert all(n.startswith("gpubench.reference") for n in _imports(path)
                   if n.startswith("gpubench"))


def test_frozen_flops_match_the_reference():
    """The configurations' FLOP counts are FlopCounterMode's on the
    reference at the published widths (meta device)."""
    for c in BENCH["configs"]:
        body = manifest.config(c["name"])
        size = body["score_model"]["args"]["image_size"]
        assert flops.forward_flops(body["score_model"], size, True) \
            == body["flops"]["score_forward"]
        assert flops.forward_flops(body["classifier"], size, False) \
            == body["flops"]["classifier_forward"]


def _module_flops(model, x, t):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, t)
    return fc.get_flop_counts()


def _block_flops(census, n):
    return sum(calls * blocks.block_cost(kind, rs, H, cin, cout, proj, n, 4)[0]
               for (kind, rs, H, cin, cout, proj), calls in census.items())


def test_ncsnpp_block_counts_match_flop_counter():
    """Each block's counted FLOPs at a small width, batch 2, are
    FlopCounterMode's for that block less its temb Dense (a plain op)."""
    from gpubench.models import family
    from gpubench.reference.ncsnpp import AttnBlockpp
    args = dict(image_size=16, nf=16, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8])
    model = family("ncsnpp").reference(args)
    counted = _module_flops(model, torch.empty(2, 3, 16, 16, device="meta"),
                            torch.zeros(2, device="meta"))
    census = ncsnpp.census(args)
    want = 0
    for name, mod in model.named_modules():
        if isinstance(mod, AttnBlockpp) or type(mod).__name__ == "ResnetBlockBigGANpp":
            f = sum(counted[f"NCSNpp.{name}"].values())
            if hasattr(mod, "Dense_0"):
                f -= 2 * 2 * mod.Dense_0.in_features * mod.Dense_0.out_features
            want += f
    assert _block_flops(census, 2) == want and sum(census.values()) == 13


def test_adm_block_counts_match_flop_counter():
    """Every residual block's (resampling ones included) and attention
    block's counted FLOPs at a small width, batch 2, are FlopCounterMode's
    for that block less its emb Linear (a plain op)."""
    from gpubench.models import family
    from gpubench.reference.adm import AttentionBlock, ResBlock
    args = dict(image_size=32, model_channels=32, out_channels=6, num_res_blocks=1,
                attention_resolutions=[2], channel_mult=[1, 2], num_head_channels=16)
    model = family("adm").reference(args)
    counted = _module_flops(model, torch.empty(2, 3, 32, 32, device="meta"),
                            torch.zeros(2, dtype=torch.int32, device="meta"))
    census = adm.census(args)
    want = 0
    for name, mod in model.named_modules():
        if isinstance(mod, (ResBlock, AttentionBlock)):
            f = sum(counted[f"ADMUNet.{name}"].values())
            if isinstance(mod, ResBlock):
                lin = mod.emb_layers[1]
                f -= 2 * 2 * lin.in_features * lin.out_features
            want += f
    kinds = {(k, rs, proj) for k, rs, _, _, _, proj in census}
    assert {("resblock", "down", False), ("resblock", "up", False),
            ("resblock", "none", True), ("attnblock", "none", False)} <= kinds
    assert _block_flops(census, 2) == want > 0


def test_published_census():
    full = manifest.config("imagenet256-adm-rn50-bf16")["score_model"]["args"]
    kinds = {}
    for (k, *_), calls in adm.census(full).items():
        kinds[k] = kinds.get(k, 0) + calls
    assert kinds == {"resblock": 42, "attnblock": 16}
    cifar = manifest.config("cifar10-ncsnpp-wrn28-fp32")["score_model"]["args"]
    c = ncsnpp.census(cifar)
    assert len(c) == 19 and sum(c.values()) == 86
    assert peaks.bound_s(989e12, 0, "bfloat16") == 1.0
