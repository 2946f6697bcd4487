"""Whole runs of tiny cells on the CPU (the program on its plain paths):
the result line's form, the check that decides ``correct`` with the timed
path broken underneath, the control, and a cell added as files alone."""
import json
import time

import pytest
import torch

from conftest import TINY_CELLS, TINY_RATES
from gpubench import control
from gpubench.lib import harness

SEED = 2 ** 31 + 977


def run(tiny, cell, traced=False, seed=SEED, seconds=0.2):
    base, bench = tiny
    return harness.run_cell(cell, seed, seconds, traced, time.perf_counter(), device="cpu",
                            bench=bench, base=base, log=lambda line: None)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_tiny_cell_runs(tiny, cell, traced):
    r = run(tiny, cell, traced)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    json.dumps(r)
    rate = TINY_RATES[cell]
    if traced:
        # the CPU has no device trace: only the host's metrics are read
        assert rate not in r["metrics"] and "setup_s" not in r["metrics"]
        assert all(k.startswith(("solver.", "mfu.")) for k in r["metrics"])
        assert r["metrics"]
    else:
        assert set(r["metrics"]) == {rate, "setup_s"}
        assert r["metrics"]["setup_s"]["value"] > 0
    for v in r["checks"].values():
        assert 0 <= v["value"] < v["limit"]


def test_same_seed_same_numbers(tiny):
    # a window of one call: the checked call is drawn from the calls made,
    # whose number follows the host's speed
    a, b = run(tiny, "tiny-purify", seconds=0), run(tiny, "tiny-purify", seconds=0)
    assert a["attempted"] == b["attempted"] == 1
    assert a["checks"] == b["checks"]
    assert run(tiny, "tiny-purify", seed=5, seconds=0)["checks"] != a["checks"]


def _state_unchanged(monkeypatch):
    from diffpure_tpu_torch.solvers import em
    monkeypatch.setattr(em, "em_step", lambda drift, diffusion, x, t, dt, dw: x)


def _half_batch(monkeypatch):
    from diffpure_tpu_torch.eval.defended import DefendedModel
    orig = DefendedModel.purify

    def purify(self, x01, noise):
        out = orig(self, x01, noise)
        half = out.shape[0] // 2
        return torch.cat([out[:half], out[:half]])

    monkeypatch.setattr(DefendedModel, "purify", purify)


def _answer_altered(monkeypatch):
    from diffpure_tpu_torch.eval.defended import DefendedModel
    orig = DefendedModel.classify

    def classify(self, x01):
        logits = orig(self, x01)
        bump = torch.zeros_like(logits)
        bump[0] = 0.05 * logits[0].abs().max()
        return logits + bump

    monkeypatch.setattr(DefendedModel, "classify", classify)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_broken_program_is_not_correct(tiny, cell, fault, monkeypatch):
    """The harness's whole run but the look for a card, with the timed path
    broken: ``correct`` comes out false."""
    fault(monkeypatch)
    r = run(tiny, cell)
    assert r["correct"] is False and r["failed"] >= 1


def test_half_batch_gradient_is_not_correct(tiny, monkeypatch):
    """The EOT gradient of half the batch left out (zero), the forward and
    its logits untouched: the gradient of all checked rows together fails,
    though the octile row, the best of the tiny cell's four, is sound."""
    from diffpure_tpu_torch.attacks import eot
    orig = eot.eot_average

    def eot_average(*args, **kw):
        out = orig(*args, **kw)
        return tuple(torch.cat([g[:len(g) // 2], torch.zeros_like(g[len(g) // 2:])])
                     for g in out)

    monkeypatch.setattr(eot, "eot_average", eot_average)
    r = run(tiny, "tiny-eotgrad")
    assert r["correct"] is False and r["failed"] >= 1
    checks = r["checks"]
    assert checks["grad_rel_err"]["value"] > checks["grad_rel_err"]["limit"]
    assert checks["grad_octile_rel_err"]["value"] <= checks["grad_octile_rel_err"]["limit"]
    assert checks["logits_rel_err"]["value"] <= checks["logits_rel_err"]["limit"]


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_control_fails(tiny, cell):
    """The reference one precision down in the program's place fails the
    cell's limits, where the program meets them (the control's test at a size
    a test run holds; control.py reads it at the cells' own sizes)."""
    base, _ = tiny
    wl = json.loads((base / "workloads" / f"{cell}.json").read_text())
    r = control.readings(cell, SEED, True, device="cpu", base=base)
    (numbers,) = r["control"].values()
    assert all(v < wl["limits"][k] for k, v in r["program"].items())
    assert any(v > wl["limits"][k] for k, v in numbers.items())


def test_new_cell_as_files_only(tiny):
    """A configuration, a cell and a per-layer metric added as new files (and
    manifest entries) run with no edit to the harness."""
    base, bench = tiny
    cfg = json.loads((base / "configs" / "tiny-ncsnpp-wrn.json").read_text())
    cfg["name"] = "tiny-ncsnpp-wrn-b"
    cfg["score_model"]["args"]["num_res_blocks"] = 2
    (base / "configs" / "tiny-ncsnpp-wrn-b.json").write_text(json.dumps(cfg))
    wl = json.loads((base / "workloads" / "tiny-purify.json").read_text())
    wl.update(config="tiny-ncsnpp-wrn-b", batch=8, check_rows=3)
    (base / "workloads" / "tiny-purify-b8.json").write_text(json.dumps(wl))
    (base / "metrics" / "solver.steps_traced.purify.py").write_text(
        'LAYER = "solver"\nUNIT = "steps"\nSOURCE = "program_span"\nBETTER = "higher"\n'
        'MOVES = "purify_img_per_s"\n\n\ndef read(t):\n'
        '    return None if t is None else float(t.steps)\n')
    bench["workloads"].append({"name": "tiny-purify-b8", "config": "tiny-ncsnpp-wrn-b",
                               "traffic": "purify-b8", "chips": 1, "why": "added"})
    for m in bench["end_to_end"]:
        if m["name"] == "purify_img_per_s":
            m["workloads"].append("tiny-purify-b8")
    bench["per_layer"].append({"name": "solver.steps_traced.purify", "unit": "steps",
                               "better": "higher", "source": "program_span", "layer": "solver",
                               "moves": "purify_img_per_s", "workloads": ["tiny-purify-b8"]})
    r = run((base, bench), "tiny-purify-b8")
    assert r["correct"] and r["metrics"]["purify_img_per_s"]["value"] > 0
    r = run((base, bench), "tiny-purify-b8", traced=True)
    assert r["metrics"]["solver.steps_traced.purify"]["value"] == 2.0


@pytest.mark.card
def test_cell_on_the_card(card):
    """One short run of the first cell on the card: the result line's form
    and a correct check."""
    r = harness.run_cell("cifar10-ncsnpp-purify-b64", SEED, 1.0, False, time.perf_counter(),
                         device=card, log=lambda line: None)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {"purify_img_per_s", "setup_s"}
