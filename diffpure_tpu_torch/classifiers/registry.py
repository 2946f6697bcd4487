"""Classifier factory (port of the CIFAR-10 WRN-28-10 entry of
diffpure_tpu/classifiers/registry.py:32)."""
from __future__ import annotations

import torch.nn as nn

from diffpure_tpu_torch.classifiers.wideresnet import WideResNet

_REGISTRY = {
    # robustbench 'Standard': [0, 1] pixels in, no internal normalisation
    "cifar10-wideresnet-28-10": lambda: WideResNet(
        depth=28, widen_factor=10, sub_block1=True),
}


def get_classifier(name: str) -> nn.Module:
    """A classifier taking [0, 1] NHWC images to logits."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"classifier {name!r} is not ported yet (ROADMAP Slice 2 item 14, "
            f"Slice 3 item 16, Slice 4 item 17); have {tuple(_REGISTRY)}")
    return _REGISTRY[name]()
