"""torchvision-style ImageNet ResNets over NHWC images (port of
diffpure_tpu/classifiers/resnet.py:79-168): 7x7 stem, max-pool, four stages
of basic or bottleneck blocks, global mean, fc. Eval mode.

Module names follow torchvision's state dict (``conv1``, ``bn1``,
``layer1.0.downsample.0``, ``fc``), so its checkpoints load strictly. The
convolutions are plain PyTorch (cuDNN on the card), as JAX leaves them to
XLA. ``input_norm`` = (mean, std) normalises [0, 1] input first: the
registry's ImageNet shim (ref utils.py:144-155).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.classifiers.common import BatchNormInference, normalize
from diffpure_tpu_torch.ops.conv import conv2d_nhwc

Tensor = torch.Tensor


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


class _Downsample(nn.Sequential):
    """1x1 strided conv + BN (keys ``downsample.0`` / ``downsample.1``)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__(_conv(cin, cout, 1, stride), BatchNormInference(cout))
        self.stride = stride

    def forward(self, x: Tensor) -> Tensor:
        return self[1](conv2d_nhwc(x, self[0].weight, stride=self.stride))


class TVBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, base_width: int = 64):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = BatchNormInference(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNormInference(planes)
        if downsample:
            self.downsample = _Downsample(cin, planes, stride)

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(conv2d_nhwc(x, self.conv1.weight, stride=self.stride)))
        out = self.bn2(conv2d_nhwc(out, self.conv2.weight))
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return F.relu(out + x)


class TVBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0))
        self.stride = stride
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = BatchNormInference(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = BatchNormInference(width)
        self.conv3 = _conv(width, planes * 4, 1)
        self.bn3 = BatchNormInference(planes * 4)
        if downsample:
            self.downsample = _Downsample(cin, planes * 4, stride)

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(conv2d_nhwc(x, self.conv1.weight)))
        out = F.relu(self.bn2(conv2d_nhwc(out, self.conv2.weight, stride=self.stride)))
        out = self.bn3(conv2d_nhwc(out, self.conv3.weight))
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return F.relu(out + x)


class TorchvisionResNet(nn.Module):
    """[0, 1] (with ``input_norm``) or normalised NHWC images -> logits."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3), block: str = "bottleneck",
                 num_classes: int = 1000, width_per_group: int = 64,
                 input_norm: Optional[Tuple[tuple, tuple]] = None):
        super().__init__()
        Block = TVBottleneck if block == "bottleneck" else TVBasicBlock
        self.input_norm = input_norm
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNormInference(64)
        cin = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            blocks = []
            for bi in range(n):
                stride = 1 if (li == 1 or bi > 0) else 2
                down = bi == 0 and (stride != 1 or cin != planes * Block.expansion)
                blocks.append(Block(cin, planes, stride, down, width_per_group))
                cin = planes * Block.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: Tensor) -> Tensor:
        if self.input_norm is not None:
            x = normalize(x, *self.input_norm)
        out = F.relu(self.bn1(conv2d_nhwc(x, self.conv1.weight, stride=2)))
        out = F.max_pool2d(out.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        return self.fc(out.mean(dim=(1, 2)))


def resnet18(**kw) -> TorchvisionResNet:
    return TorchvisionResNet(layers=(2, 2, 2, 2), block="basic", **kw)


def resnet50(**kw) -> TorchvisionResNet:
    return TorchvisionResNet(layers=(3, 4, 6, 3), block="bottleneck", **kw)


def resnet101(**kw) -> TorchvisionResNet:
    return TorchvisionResNet(layers=(3, 4, 23, 3), block="bottleneck", **kw)


def wide_resnet50_2(**kw) -> TorchvisionResNet:
    return TorchvisionResNet(layers=(3, 4, 6, 3), block="bottleneck",
                             width_per_group=128, **kw)
