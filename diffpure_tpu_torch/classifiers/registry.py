"""Classifier factory (port of the CIFAR-10 and ImageNet entries of
diffpure_tpu/classifiers/registry.py:32-54)."""
from __future__ import annotations

import torch.nn as nn

from diffpure_tpu_torch.classifiers import resnet
from diffpure_tpu_torch.classifiers.common import IMAGENET_MEAN, IMAGENET_STD
from diffpure_tpu_torch.classifiers.vit import ViT, deit_small_config
from diffpure_tpu_torch.classifiers.wideresnet import DMWideResNet, WideResNet, \
    wrn_70_16_dropout

# ImageNet models take [0, 1] images through the normalisation shim
# (ref utils.py:144-155)
_IMAGENET = dict(input_norm=(IMAGENET_MEAN, IMAGENET_STD))

_REGISTRY = {
    # robustbench 'Standard': [0, 1] pixels in, no internal normalisation
    "cifar10-wideresnet-28-10": lambda: WideResNet(
        depth=28, widen_factor=10, sub_block1=True),
    # robustbench's DeepMind AT checkpoints and the local wideresnet-70-16
    "cifar10-wrn-28-10-at0": lambda: DMWideResNet(depth=28, width=10),
    "cifar10-wrn-28-10-at1": lambda: DMWideResNet(depth=28, width=10),
    "cifar10-wrn-70-16-at0": lambda: DMWideResNet(depth=70, width=16),
    "cifar10-wrn-70-16-at1": lambda: DMWideResNet(depth=70, width=16),
    "cifar10-wrn-70-16-L2-at1": lambda: DMWideResNet(depth=70, width=16),
    "cifar10-wideresnet-70-16": lambda: DMWideResNet(depth=70, width=16),
    "cifar10-resnet-50": resnet.CifarResNet50,
    "cifar10-wrn-70-16-dropout": wrn_70_16_dropout,
    "imagenet-resnet18": lambda: resnet.resnet18(**_IMAGENET),
    "imagenet-resnet50": lambda: resnet.resnet50(**_IMAGENET),
    "imagenet-resnet101": lambda: resnet.resnet101(**_IMAGENET),
    "imagenet-wideresnet-50-2": lambda: resnet.wide_resnet50_2(**_IMAGENET),
    "imagenet-deit-s": lambda: ViT(**deit_small_config(), **_IMAGENET),
}


def get_classifier(name: str) -> nn.Module:
    """A classifier taking [0, 1] NHWC images to logits."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"classifier {name!r} is not ported yet (ROADMAP Slice 4 item 17 for "
            f"celebahq__<attribute>); have {tuple(_REGISTRY)}")
    return _REGISTRY[name]()
