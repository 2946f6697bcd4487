"""YAML configs as attribute namespaces (port of diffpure_tpu/config.py)."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict

import yaml


def dict2namespace(config: Dict[str, Any]) -> SimpleNamespace:
    """Recursive dict -> attribute namespace."""
    ns = SimpleNamespace()
    for key, value in config.items():
        setattr(ns, key,
                dict2namespace(value) if isinstance(value, dict) else value)
    return ns


def load_config(path: str) -> SimpleNamespace:
    with open(path) as f:
        return dict2namespace(yaml.safe_load(f))
