"""The classifiers, plain PyTorch in NCHW, float32, eval mode.

- ``WideResNet``: the TRADES / robustbench WRN (``cifar10_resnet.py`` of
  DiffPure; Zagoruyko & Komodakis, 2016), pre-activation blocks, [0, 1]
  pixels in with no normalisation (robustbench's 'Standard' WRN-28-10).
  ``sub_block1`` is built because robustbench's checkpoints carry it; it
  never runs.
- ``ResNet``: torchvision's bottleneck ResNet (He et al., 2016), [0, 1]
  input normalised with the ImageNet mean and std first.

Module names are those of the published state dicts.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.layers import BatchNorm, conv, linear
from gpubench.reference.precision import Precision

Tensor = torch.Tensor

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.equal = cin == cout
        if not self.equal:
            self.convShortcut = nn.Conv2d(cin, cout, 1, stride, 0, bias=False)

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        pre = F.relu(self.bn1(x))
        out = F.relu(self.bn2(conv(self.conv1, pre, p)))
        out = conv(self.conv2, out, p)
        return (x if self.equal else conv(self.convShortcut, pre, p)) + out


class NetworkBlock(nn.Module):
    def __init__(self, n: int, cin: int, cout: int, stride: int):
        super().__init__()
        self.layer = nn.ModuleList([BasicBlock(cin if i == 0 else cout, cout,
                                               stride if i == 0 else 1) for i in range(n)])

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        for block in self.layer:
            x = block(x, p)
        return x


class WideResNet(nn.Module):
    def __init__(self, depth: int = 28, widen_factor: int = 10, num_classes: int = 10):
        super().__init__()
        n = (depth - 4) // 6
        w = [16, 16 * widen_factor, 32 * widen_factor, 64 * widen_factor]
        self.prec = Precision()
        self.conv1 = nn.Conv2d(3, w[0], 3, 1, 1, bias=False)
        self.block1 = NetworkBlock(n, w[0], w[1], 1)
        self.sub_block1 = NetworkBlock(n, w[0], w[1], 1)
        self.block2 = NetworkBlock(n, w[1], w[2], 2)
        self.block3 = NetworkBlock(n, w[2], w[3], 2)
        self.bn1 = BatchNorm(w[3])
        self.fc = nn.Linear(w[3], num_classes)

    def forward(self, x: Tensor) -> Tensor:
        p = self.prec
        out = conv(self.conv1, x, p)
        out = self.block3(self.block2(self.block1(out, p), p), p)
        out = F.relu(self.bn1(out))
        return linear(self.fc, out.mean(dim=(2, 3)), p)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, down: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = BatchNorm(4 * planes)
        if down:
            self.downsample = nn.Sequential(nn.Conv2d(cin, 4 * planes, 1, stride, bias=False),
                                            BatchNorm(4 * planes))

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        out = F.relu(self.bn1(conv(self.conv1, x, p)))
        out = F.relu(self.bn2(conv(self.conv2, out, p)))
        out = self.bn3(conv(self.conv3, out, p))
        if hasattr(self, "downsample"):
            x = self.downsample[1](conv(self.downsample[0], x, p))
        return F.relu(out + x)


class ResNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), num_classes: int = 1000):
        super().__init__()
        self.prec = Precision()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            blocks = []
            for bi in range(n):
                stride = 1 if (li == 1 or bi > 0) else 2
                blocks.append(Bottleneck(cin, planes, stride, bi == 0))
                cin = 4 * planes
            setattr(self, f"layer{li}", nn.ModuleList(blocks))
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: Tensor) -> Tensor:
        p = self.prec
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
        std = torch.tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
        out = F.relu(self.bn1(conv(self.conv1, (x - mean) / std, p)))
        out = F.max_pool2d(out, 3, 2, 1)
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                out = block(out, p)
        return linear(self.fc, out.mean(dim=(2, 3)), p)
