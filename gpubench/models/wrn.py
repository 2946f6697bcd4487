"""The robustbench / TRADES WideResNet on [0, 1] CIFAR pixels."""
from __future__ import annotations

import torch


def port(args: dict, dtype: torch.dtype):
    from diffpure_tpu_torch.classifiers.wideresnet import WideResNet
    with torch.device("meta"):
        return WideResNet(**args, sub_block1=True)


def reference(args: dict):
    from gpubench.reference.classifiers import WideResNet
    with torch.device("meta"):
        return WideResNet(**args)


def fixed(args: dict) -> dict:
    return {}
