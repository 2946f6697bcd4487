"""WideResNet classifiers over NHWC images, eval mode (port of
diffpure_tpu/classifiers/wideresnet.py):

  - ``WideResNet``: TRADES-style (ref classifiers/cifar10_resnet.py:95-193),
    :73. The robustbench 'Standard' WRN-28-10 runs it on [0, 1] pixels
    with no internal normalisation (the registry's WRN-28-10,
    diffpure_tpu/classifiers/registry.py:33-34); ``wrn_70_16_dropout`` (:111)
    normalises inside, as JAX's default ``normalize_input=True`` does.
  - ``DMWideResNet``: DeepMind's pre-activation variant with Swish and
    internal normalisation (robustbench dm_wide_resnet.py), :167; the
    robustbench AT checkpoints and the local wideresnet-70-16.

Module names follow the PyTorch state dicts: ``block1.layer.0.bn1.running_mean``
(TRADES), ``layer.0.block.0.batchnorm_0.weight`` (DeepMind), so their
checkpoints load strictly. Dropout acts only in training, which the port
does not run: in eval it is the identity, as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.classifiers.common import CIFAR10_MEAN, CIFAR10_STD, \
    BatchNormInference, normalize
from diffpure_tpu_torch.ops.conv import conv2d_nhwc

Tensor = torch.Tensor


def _groups(depth: int) -> int:
    if (depth - 4) % 6:
        raise ValueError(f"WRN depth must be 6n + 4, got {depth}")
    return (depth - 4) // 6


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
    """WRN-depth-widen_factor on [0, 1] NHWC images -> logits;
    ``normalize_input`` applies the CIFAR-10 normalisation first."""

    def __init__(self, depth: int = 28, widen_factor: int = 10,
                 num_classes: int = 10, sub_block1: bool = False,
                 normalize_input: bool = False):
        super().__init__()
        n = _groups(depth)
        widths = [16, 16 * widen_factor, 32 * widen_factor, 64 * widen_factor]
        self.normalize_input = normalize_input
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
        if self.normalize_input:
            x = normalize(x, CIFAR10_MEAN, CIFAR10_STD)
        out = conv2d_nhwc(x, self.conv1.weight)
        out = self.block3(self.block2(self.block1(out)))
        out = F.relu(self.bn1(out))
        # global spatial mean == the reference's 8x8 avg-pool at 32x32
        return self.fc(out.mean(dim=(1, 2)))


def wrn_70_16_dropout(**kw) -> WideResNet:
    """ref cifar10_resnet.py:197-198 (JAX wideresnet.py:111): internal
    normalisation, dropout 0.3 (inactive in eval)."""
    return WideResNet(depth=70, widen_factor=16, normalize_input=True, **kw)


class DMBlock(nn.Module):
    """Pre-activation Swish block (robustbench dm_wide_resnet._Block; JAX
    :121). A stride-2 ``conv_0`` pads (0, 1, 0, 1), bottom and right only,
    then runs VALID; symmetric padding would sample other pixels."""

    def __init__(self, in_planes: int, out_planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.batchnorm_0 = BatchNormInference(in_planes)
        self.conv_0 = nn.Conv2d(in_planes, out_planes, 3, stride, 0, bias=False)
        self.batchnorm_1 = BatchNormInference(out_planes)
        self.conv_1 = nn.Conv2d(out_planes, out_planes, 3, 1, 1, bias=False)
        self.has_shortcut = in_planes != out_planes
        if self.has_shortcut:
            self.shortcut = nn.Conv2d(in_planes, out_planes, 1, stride, 0, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        pre = F.silu(self.batchnorm_0(x))
        if self.has_shortcut:
            x = pre
        # NHWC: F.pad's pairs run from the last axis (C) back to H
        v = F.pad(pre, (0, 0, 1, 1, 1, 1) if self.stride == 1 else (0, 0, 0, 1, 0, 1))
        out = conv2d_nhwc(v, self.conv_0.weight, stride=self.stride, padding=0)
        out = F.silu(self.batchnorm_1(out))
        out = conv2d_nhwc(out, self.conv_1.weight)
        sc = conv2d_nhwc(x, self.shortcut.weight, stride=self.stride) \
            if self.has_shortcut else x
        return sc + out


class DMBlockGroup(nn.Module):
    """robustbench _BlockGroup (keys ``block.{i}``; JAX :152)."""

    def __init__(self, num_blocks: int, in_planes: int, out_planes: int, stride: int):
        super().__init__()
        self.block = nn.Sequential(*[
            DMBlock(in_planes if i == 0 else out_planes, out_planes,
                    stride if i == 0 else 1) for i in range(num_blocks)])

    def forward(self, x: Tensor) -> Tensor:
        return self.block(x)


class DMWideResNet(nn.Module):
    """DeepMind WRN on [0, 1] NHWC images -> logits (JAX :167-196): optional
    zero ``padding``, internal normalisation, ``init_conv``, three block
    groups ``layer.{0,1,2}``, ``batchnorm``, Swish, global mean, ``logits``."""

    def __init__(self, num_classes: int = 10, depth: int = 70, width: int = 16,
                 mean=CIFAR10_MEAN, std=CIFAR10_STD, padding: int = 0):
        super().__init__()
        n = _groups(depth)
        widths = [16, 16 * width, 32 * width, 64 * width]
        self.mean, self.std, self.padding = tuple(mean), tuple(std), padding
        self.init_conv = nn.Conv2d(3, widths[0], 3, 1, 1, bias=False)
        self.layer = nn.Sequential(
            DMBlockGroup(n, widths[0], widths[1], 1),
            DMBlockGroup(n, widths[1], widths[2], 2),
            DMBlockGroup(n, widths[2], widths[3], 2))
        self.batchnorm = BatchNormInference(widths[3])
        self.logits = nn.Linear(widths[3], num_classes)

    def forward(self, x: Tensor) -> Tensor:
        if self.padding:
            p = self.padding
            x = F.pad(x, (0, 0, p, p, p, p))
        x = normalize(x, self.mean, self.std)
        out = self.layer(conv2d_nhwc(x, self.init_conv.weight))
        out = F.silu(self.batchnorm(out))
        return self.logits(out.mean(dim=(1, 2)))
