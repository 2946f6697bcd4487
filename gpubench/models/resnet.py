"""torchvision's bottleneck ResNet on [0, 1] ImageNet pixels, normalised
inside."""
from __future__ import annotations

import torch


def port(args: dict, dtype: torch.dtype):
    from diffpure_tpu_torch.classifiers.common import IMAGENET_MEAN, IMAGENET_STD
    from diffpure_tpu_torch.classifiers.resnet import TorchvisionResNet
    with torch.device("meta"):
        return TorchvisionResNet(layers=tuple(args["layers"]), block="bottleneck",
                                 num_classes=args["num_classes"],
                                 input_norm=(IMAGENET_MEAN, IMAGENET_STD))


def reference(args: dict):
    from gpubench.reference.classifiers import ResNet
    with torch.device("meta"):
        return ResNet(layers=tuple(args["layers"]), num_classes=args["num_classes"])


def fixed(args: dict) -> dict:
    return {}
