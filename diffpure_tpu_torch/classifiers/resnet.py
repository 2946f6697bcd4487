"""ResNets over NHWC images, eval mode (port of
diffpure_tpu/classifiers/resnet.py):

  - ``CifarResNet50`` (:54; ref classifiers/cifar10_resnet.py:17-85): a
    post-activation bottleneck [3, 4, 6, 3] with a 3x3 stem, internal CIFAR
    normalisation, a 4x4 average pool and ``linear``; keys ``layer1.0.conv1``,
    ``layer1.0.shortcut.0`` / ``.1``.
  - torchvision-style ImageNet ResNets (:79-168): 7x7 stem, max-pool, four
    stages of basic or bottleneck blocks, global mean, fc; keys
    torchvision's (``conv1``, ``bn1``, ``layer1.0.downsample.0``, ``fc``).

Either publisher's checkpoints load strictly. The
convolutions are plain PyTorch (cuDNN on the card), as JAX leaves them to
XLA. ``input_norm`` = (mean, std) normalises [0, 1] input first: the
registry's ImageNet shim (ref utils.py:144-155).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.classifiers.common import CIFAR10_MEAN, CIFAR10_STD, \
    BatchNormInference, normalize
from diffpure_tpu_torch.ops.conv import conv2d_nhwc

Tensor = torch.Tensor


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


class _Downsample(nn.Sequential):
    """1x1 strided conv + BN (keys ``downsample.0`` / ``.1``, or
    ``shortcut.0`` / ``.1`` in the CIFAR bottleneck)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__(_conv(cin, cout, 1, stride), BatchNormInference(cout))
        self.stride = stride

    def forward(self, x: Tensor) -> Tensor:
        return self[1](conv2d_nhwc(x, self[0].weight, stride=self.stride))


class CifarBottleneck(nn.Module):
    """ref cifar10_resnet.py:17-42: 1x1, 3x3 (strided), 1x1, each with BN;
    the projection shortcut is Sequential(conv, bn)."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        cout = 4 * planes
        self.stride = stride
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = BatchNormInference(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNormInference(planes)
        self.conv3 = _conv(planes, cout, 1)
        self.bn3 = BatchNormInference(cout)
        if stride != 1 or cin != cout:
            self.shortcut = _Downsample(cin, cout, stride)

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(conv2d_nhwc(x, self.conv1.weight)))
        out = F.relu(self.bn2(conv2d_nhwc(out, self.conv2.weight, stride=self.stride)))
        out = self.bn3(conv2d_nhwc(out, self.conv3.weight))
        sc = self.shortcut(x) if hasattr(self, "shortcut") else x
        return F.relu(out + sc)


class CifarResNet50(nn.Module):
    """[0, 1] NHWC CIFAR images -> logits (ref cifar10_resnet.py:45-85)."""

    def __init__(self, num_blocks: Tuple[int, ...] = (3, 4, 6, 3), num_classes: int = 10):
        super().__init__()
        self.conv1 = _conv(3, 64, 3)
        self.bn1 = BatchNormInference(64)
        cin = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), num_blocks), start=1):
            blocks = []
            for bi in range(n):
                blocks.append(CifarBottleneck(cin, planes, (1 if li == 1 else 2) if bi == 0 else 1))
                cin = 4 * planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.linear = nn.Linear(cin, num_classes)

    def forward(self, x: Tensor) -> Tensor:
        x = normalize(x, CIFAR10_MEAN, CIFAR10_STD)
        out = F.relu(self.bn1(conv2d_nhwc(x, self.conv1.weight)))
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        out = F.avg_pool2d(out.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)
        return self.linear(out.reshape(out.shape[0], -1))


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
