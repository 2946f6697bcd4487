"""flax params -> PyTorch state dict for the classifiers: the inverse of
diffpure_tpu/classifiers/convert.py (``_classifier_leaf`` :35,
``translate_classifier`` :54)."""
from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from diffpure_tpu_torch.models.convert import flatten_params, to_tensor

_MERGED = re.compile(r"^(.+?)((?:_\d+)+)$")
_BN_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _split_module(name: str):
    """'layer_0' -> ['layer', '0']: undo the JAX translator's digit merge."""
    m = _MERGED.match(name)
    if m is None:
        return [name]
    return [m.group(1)] + m.group(2).lstrip("_").split("_")


def wideresnet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Keys ``block1/layer_0/bn1/scale`` -> ``block1.layer.0.bn1.weight``;
    BN ``mean``/``var`` -> ``running_mean``/``running_var`` (plus the
    ``num_batches_tracked`` counter that PyTorch BatchNorm keys carry)."""
    sd = {}
    for path, v in flatten_params(params):
        *mods, leaf = path
        prefix = ".".join(p for m in mods for p in _split_module(m))
        if leaf == "kernel":
            name, arr = "weight", (v.transpose(3, 2, 0, 1) if v.ndim == 4
                                   else v.transpose(1, 0))
        elif leaf == "scale":
            name, arr = "weight", v
        elif leaf in _BN_LEAVES:
            name, arr = _BN_LEAVES[leaf], v
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "bias":
            name, arr = "bias", v
        else:
            raise ValueError(f"unhandled classifier leaf {'/'.join(path)}")
        sd[f"{prefix}.{name}"] = to_tensor(arr)
    return sd
