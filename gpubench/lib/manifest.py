"""What the benchmark holds, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``workloads/<cell>.json`` and
``metrics/<metric>.py`` beside this package. A later change adds a cell, a
configuration or a per-layer metric as new files and new entries."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
READER_FIELDS = ("LAYER", "UNIT", "SOURCE", "BETTER", "MOVES")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(name: str, base: Path = HERE) -> dict:
    w = _json(base / "workloads" / f"{check_name(name)}.json")
    w["name"] = name
    return w


def config(name: str, base: Path = HERE) -> dict:
    c = _json(base / "configs" / f"{check_name(name)}.json")
    if c.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {c.get('name')!r}")
    return c


def reader(name: str, base: Path = HERE):
    """The metric's reader module: ``read(trace) -> float | None`` and its
    LAYER, UNIT, SOURCE, BETTER and MOVES."""
    path = base / "metrics" / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for field in READER_FIELDS:
        if not hasattr(mod, field):
            raise ValueError(f"metrics/{name}.py declares no {field}")
    return mod


def per_layer(bench: dict, cell: str) -> list:
    """The per-layer metrics a traced run of ``cell`` reports."""
    return [m for m in bench["per_layer"] if cell in m.get("workloads", [cell])]


def end_to_end(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def cell_entry(bench: dict, cell: str) -> Optional[dict]:
    return next((w for w in bench["workloads"] if w["name"] == cell), None)
