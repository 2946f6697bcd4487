"""Score-model registry (port of diffpure_tpu/models/registry.py; ref
score_sde/models/utils.py:26-46). ``models/__init__`` imports the models,
which registers ``"ncsnpp"`` and ``"ddpm"``. The ADM is built by
``models/factories`` instead, as in JAX."""
from __future__ import annotations

from typing import Dict

_MODELS: Dict[str, type] = {}


def register_model(cls=None, *, name: str | None = None):
    """Register a model class under ``name`` (or its class name)."""
    def _register(c):
        local_name = name if name is not None else c.__name__
        if local_name in _MODELS:
            raise ValueError(f"model {local_name} already registered")
        _MODELS[local_name] = c
        return c

    if cls is None:
        return _register
    return _register(cls)


def get_model_cls(name: str) -> type:
    if name not in _MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(_MODELS)}")
    return _MODELS[name]


def create_model(name: str, **kwargs):
    """Instantiate a registered model."""
    return get_model_cls(name)(**kwargs)
