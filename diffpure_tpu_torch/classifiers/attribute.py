"""The CelebA-HQ attribute classifier, a StyleGAN-discriminator-style net
over NHWC images (port of diffpure_tpu/classifiers/attribute.py; ref
classifiers/attribute_net.py and attribute_classifier.py).

DiffPure loads its checkpoints with fixed_size=True and use_mbstd=False
(ref attribute_classifier.py:55): only the ``fromrgb_lod0`` path and the
downscale pyramid run; the minibatch-stddev layer is kept for the API.
Module names are the reference's (``fromrgb_lod0.conv.conv.weight``,
``256x256.conv0.wscale.b``, ``4x4.dense1.linear.weight``), so a
``net_best.pth`` loads with ``load_state_dict`` after
``classifiers/convert.attribute_state_dict`` drops its constant buffers.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from diffpure_tpu_torch.ops.conv import conv2d_nhwc

Tensor = torch.Tensor


def lrelu(x: Tensor) -> Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


class _WScale(nn.Module):
    """The learned bias of a WScale layer (the reference's ``wscale.b``)."""

    def __init__(self, features: int):
        super().__init__()
        self.b = nn.Parameter(torch.zeros(features))


class WScaleConv(nn.Module):
    """Conv without bias, scaled by gain / sqrt(fan_in), plus a learned bias
    (ref attribute_net.py:17-52)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, padding: int = 0,
                 gain: float = math.sqrt(2)):
        super().__init__()
        self.padding = padding
        self.scale = gain / math.sqrt(in_ch * kernel_size ** 2)
        self.conv = nn.Conv2d(in_ch, features, kernel_size, padding=padding, bias=False)
        self.wscale = _WScale(features)

    def forward(self, x: Tensor) -> Tensor:
        h = conv2d_nhwc(x, self.conv.weight, None, padding=self.padding)
        return h * self.scale + self.wscale.b


class WScaleLinear(nn.Module):
    """ref attribute_net.py:55-64."""

    def __init__(self, in_features: int, features: int, gain: float = math.sqrt(2)):
        super().__init__()
        self.scale = gain / math.sqrt(in_features)
        self.linear = nn.Linear(in_features, features, bias=False)
        self.wscale = _WScale(features)

    def forward(self, x: Tensor) -> Tensor:
        return self.linear(x) * self.scale + self.wscale.b


class FromRGB(nn.Module):
    """1x1 WScale conv + leaky ReLU (ref attribute_net.py:67-76)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv = WScaleConv(in_ch, features, kernel_size=1)

    def forward(self, x: Tensor) -> Tensor:
        return lrelu(self.conv(x))


def downscale2d(x: Tensor, factor: int = 2) -> Tensor:
    N, H, W, C = x.shape
    return x.reshape(N, H // factor, factor, W // factor, factor, C).mean(dim=(2, 4))


class DownscaleConvBlock(nn.Module):
    """conv -> act -> conv -> downscale -> act, in that order (ref
    attribute_net.py:88-110)."""

    def __init__(self, in_ch: int, conv0_features: int, conv1_features: int):
        super().__init__()
        self.conv0 = WScaleConv(in_ch, conv0_features, 3, padding=1)
        self.conv1 = WScaleConv(conv0_features, conv1_features, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        x = lrelu(self.conv0(x))
        return lrelu(downscale2d(self.conv1(x)))


def minibatch_std(x: Tensor, group_size: int = 4) -> Tensor:
    """ref attribute_net.py:113-130 (NHWC)."""
    g = min(group_size, x.shape[0])
    N, H, W, C = x.shape
    y = x.reshape(g, -1, H, W, C)
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt((y * y).mean(dim=0) + 1e-8)
    y = y.mean(dim=(1, 2, 3), keepdim=True).repeat(g, H, W, 1)
    return torch.cat([x, y], dim=-1)


class PredictionBlock(nn.Module):
    """ref attribute_net.py:133-153."""

    def __init__(self, in_ch: int, dense0_features: int, dense1_features: int,
                 out_features: int, use_mbstd: bool = False):
        super().__init__()
        self.use_mbstd = use_mbstd
        self.conv = WScaleConv(in_ch + int(use_mbstd), dense0_features, 3, padding=1)
        self.dense0 = WScaleLinear(dense0_features * 16, dense1_features)
        self.dense1 = WScaleLinear(dense1_features, out_features, gain=1.0)

    def forward(self, x: Tensor) -> Tensor:
        if self.use_mbstd:
            x = minibatch_std(x)
        x = lrelu(self.conv(x))
        # flatten channel-major, as the reference's NCHW dense layout
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return self.dense1(lrelu(self.dense0(x)))


class AttributeD(nn.Module):
    """The discriminator on its fixed-size path (ref attribute_net.py:156-212,
    fixed_size=True): images in [-1, 1] (N, R, R, 3) -> one logit (N, 1)."""

    def __init__(self, resolution: int = 256, num_channels: int = 3, fmap_base: int = 8192,
                 fmap_decay: float = 1.0, fmap_max: int = 512, use_mbstd: bool = False):
        super().__init__()
        res_log2 = int(math.log2(resolution))
        assert 2 ** res_log2 == resolution and resolution >= 4
        self.resolution = resolution

        def nf(stage: int) -> int:
            return min(int(fmap_base / (2.0 ** (stage * fmap_decay))), fmap_max)

        self.fromrgb_lod0 = FromRGB(num_channels, nf(res_log2 - 1))
        ch = nf(res_log2 - 1)
        self._pyramid = []
        for res in range(res_log2, 2, -1):
            name = f"{2 ** res}x{2 ** res}"
            self.add_module(name, DownscaleConvBlock(ch, nf(res - 1), nf(res - 2)))
            self._pyramid.append(name)
            ch = nf(res - 2)
        self.add_module("4x4", PredictionBlock(ch, nf(1), nf(0), 1, use_mbstd))

    def forward(self, x: Tensor) -> Tensor:
        h = self.fromrgb_lod0(x)
        for name in self._pyramid:
            h = getattr(self, name)(h)
        return getattr(self, "4x4")(h)


def mean_pool_to(images: Tensor, size: int = 256) -> Tensor:
    """Mean-pool larger inputs down to ``size`` (ref
    attribute_classifier.py:15-27)."""
    H = images.shape[1]
    if H > size:
        factor = H // size
        assert factor * size == H
        N, _, W, C = images.shape
        return images.reshape(N, size, factor, W // factor, factor, C).mean(dim=(2, 4))
    assert images.shape[2] == size
    return images


def attribute_logits(model: AttributeD, ims01: Tensor, size: int = 256) -> Tensor:
    """[0, 1] images -> two-class logits [logit, -logit] (ref
    attribute_classifier.py:58-65)."""
    logit = model(mean_pool_to((ims01 - 0.5) / 0.5, size))
    return torch.cat([logit, -logit], dim=1)


class AttributeClassifier(AttributeD):
    """The registry's ``celebahq__<attribute>`` classifier: [0, 1] NHWC
    images -> [logit, -logit]; its state dict is the AttributeD's."""

    def forward(self, ims01: Tensor) -> Tensor:
        return attribute_logits(super().forward, ims01, self.resolution)
