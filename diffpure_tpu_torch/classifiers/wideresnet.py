"""TRADES-style WideResNet over NHWC images (port of
diffpure_tpu/classifiers/wideresnet.py:73, as the robustbench 'Standard'
WRN-28-10 uses it: no internal input normalisation, eval mode).

Module names follow the PyTorch state dict (ref classifiers/
cifar10_resnet.py:95-193): ``block1.layer.0.bn1.running_mean`` ...
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.classifiers.common import BatchNormInference
from diffpure_tpu_torch.ops.conv import conv2d_nhwc

Tensor = torch.Tensor


class BasicBlock(nn.Module):
    """Pre-activation WRN block (ref cifar10_resnet.py:95-117)."""

    def __init__(self, in_planes: int, out_planes: int, stride: int):
        super().__init__()
        self.bn1 = BatchNormInference(in_planes)
        self.conv1 = nn.Conv2d(in_planes, out_planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNormInference(out_planes)
        self.conv2 = nn.Conv2d(out_planes, out_planes, 3, 1, 1, bias=False)
        self.equal_in_out = in_planes == out_planes
        self.stride = stride
        if not self.equal_in_out:
            self.convShortcut = nn.Conv2d(in_planes, out_planes, 1, stride, 0,
                                          bias=False)

    def forward(self, x: Tensor) -> Tensor:
        pre = F.relu(self.bn1(x))
        out = conv2d_nhwc(pre, self.conv1.weight, stride=self.stride)
        out = F.relu(self.bn2(out))
        out = conv2d_nhwc(out, self.conv2.weight)
        if self.equal_in_out:
            return x + out
        return conv2d_nhwc(pre, self.convShortcut.weight, stride=self.stride) + out


class NetworkBlock(nn.Module):
    """ref cifar10_resnet.py:120-132."""

    def __init__(self, nb_layers: int, in_planes: int, out_planes: int,
                 stride: int):
        super().__init__()
        self.layer = nn.Sequential(*[
            BasicBlock(in_planes if i == 0 else out_planes, out_planes,
                       stride if i == 0 else 1) for i in range(nb_layers)])

    def forward(self, x: Tensor) -> Tensor:
        return self.layer(x)


class WideResNet(nn.Module):
    """WRN-depth-widen_factor on [0, 1] NHWC images -> logits."""

    def __init__(self, depth: int = 28, widen_factor: int = 10,
                 num_classes: int = 10, sub_block1: bool = False):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"WRN depth must be 6n + 4, got {depth}")
        n = (depth - 4) // 6
        widths = [16, 16 * widen_factor, 32 * widen_factor, 64 * widen_factor]
        self.conv1 = nn.Conv2d(3, widths[0], 3, 1, 1, bias=False)
        self.block1 = NetworkBlock(n, widths[0], widths[1], 1)
        if sub_block1:
            # present in robustbench checkpoints, never run
            # (ref cifar10_resnet.py:152-155)
            self.sub_block1 = NetworkBlock(n, widths[0], widths[1], 1)
        self.block2 = NetworkBlock(n, widths[1], widths[2], 2)
        self.block3 = NetworkBlock(n, widths[2], widths[3], 2)
        self.bn1 = BatchNormInference(widths[3])
        self.fc = nn.Linear(widths[3], num_classes)

    def forward(self, x: Tensor) -> Tensor:
        out = conv2d_nhwc(x, self.conv1.weight)
        out = self.block3(self.block2(self.block1(out)))
        out = F.relu(self.bn1(out))
        # global spatial mean == the reference's 8x8 avg-pool at 32x32
        return self.fc(out.mean(dim=(1, 2)))
