"""Classifier factory (port of the CIFAR-10 WRN-28-10 and the ImageNet
ResNet and DeiT-S entries of diffpure_tpu/classifiers/registry.py:32-95)."""
from __future__ import annotations

import torch.nn as nn

from diffpure_tpu_torch.classifiers import resnet
from diffpure_tpu_torch.classifiers.common import IMAGENET_MEAN, IMAGENET_STD
from diffpure_tpu_torch.classifiers.vit import ViT, deit_small_config
from diffpure_tpu_torch.classifiers.wideresnet import WideResNet

# ImageNet models take [0, 1] images through the normalisation shim
# (ref utils.py:144-155)
_IMAGENET = dict(input_norm=(IMAGENET_MEAN, IMAGENET_STD))

_REGISTRY = {
    # robustbench 'Standard': [0, 1] pixels in, no internal normalisation
    "cifar10-wideresnet-28-10": lambda: WideResNet(
        depth=28, widen_factor=10, sub_block1=True),
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
            f"classifier {name!r} is not ported yet (ROADMAP Slice 2 item 14, "
            f"Slice 4 item 17); have {tuple(_REGISTRY)}")
    return _REGISTRY[name]()
