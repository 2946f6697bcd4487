"""NCSNv1 / v2's RefineNet blocks over NHWC maps (port of
diffpure_tpu/models/legacy_layers.py; ref score_sde/models/layers.py:133-500).

The CRP, RCU, MSF and Refine blocks with their conditional forms, the
pre-activation ``ResidualBlock`` / ``ConditionalResidualBlock`` with
dilation or ``ConvMeanPool`` downsampling, and ``MeanPoolConv`` /
``UpsampleConv``. Module and parameter names are score_sde's
(``convs.0``, ``1_1_conv``, ``adapt_convs.0``, ``msf``, ``crp``,
``output_convs``, ``normalize1`` ...), so a score_sde state dict loads as
it is. Convs are ``nn.Conv2d`` (OIHW) run on channels-last views, plain
PyTorch on either device: the JAX package has no kernel here.

Where JAX departs from score_sde the port follows JAX: ``UpsampleConv``
repeats each pixel 2 x 2 (JAX's NHWC reshape; score_sde's PixelShuffle of
four copies mixes channels), and ``ConditionalResidualBlock`` with
dilation and no resampling always has a ``shortcut`` conv (score_sde uses
the identity when the widths agree).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.models.normalization import InstanceNorm2dPlus

Tensor = torch.Tensor
elu = F.elu


def ncsn_conv3x3(in_planes: int, out_planes: int, stride: int = 1, bias: bool = True,
                 dilation: int = 1) -> nn.Conv2d:
    """3x3 conv padded by its dilation (ref layers.py:109-116)."""
    return nn.Conv2d(in_planes, out_planes, 3, stride=stride, padding=dilation,
                     dilation=dilation, bias=bias)


def ncsn_conv1x1(in_planes: int, out_planes: int, stride: int = 1,
                 bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(in_planes, out_planes, 1, stride=stride, padding=0, bias=bias)


def conv_nhwc(conv: nn.Module, x: Tensor) -> Tensor:
    """An NCHW conv module on an NHWC map (a channels-last view each way)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _pool5(x: Tensor, maxpool: bool) -> Tensor:
    """5x5 pooling, stride 1, padding 2: max (the padding never wins) or
    mean over the full window (AvgPool2d's count_include_pad, JAX :43-45)."""
    x = x.permute(0, 3, 1, 2)
    if maxpool:
        y = F.max_pool2d(x, 5, stride=1, padding=2)
    else:
        y = F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def _mean_pool2(x: Tensor) -> Tensor:
    """The 2x2 mean, summed in score_sde's order."""
    return (x[:, ::2, ::2] + x[:, 1::2, ::2] + x[:, ::2, 1::2] + x[:, 1::2, 1::2]) / 4.0


def _resize_bilinear_align(x: Tensor, shape: Tuple[int, int]) -> Tensor:
    """``F.interpolate(mode='bilinear', align_corners=True)`` to ``shape``
    (JAX :127); the identity at the map's own size."""
    if tuple(shape) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(shape), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


class CRPBlock(nn.Module):
    """Chained residual pooling (ref layers.py:133-154)."""

    def __init__(self, features: int, n_stages: int = 2, act: Callable = F.relu,
                 maxpool: bool = True):
        super().__init__()
        self.convs = nn.ModuleList([ncsn_conv3x3(features, features, bias=False)
                                    for _ in range(n_stages)])
        self.act, self.maxpool = act, maxpool

    def forward(self, x: Tensor) -> Tensor:
        x = self.act(x)
        path = x
        for conv in self.convs:
            path = conv_nhwc(conv, _pool5(path, self.maxpool))
            x = path + x
        return x


class CondCRPBlock(nn.Module):
    """ref layers.py:157-180 (mean pooling)."""

    def __init__(self, features: int, n_stages: int, num_classes: int,
                 normalizer: Callable, act: Callable = F.relu):
        super().__init__()
        self.convs = nn.ModuleList([ncsn_conv3x3(features, features, bias=False)
                                    for _ in range(n_stages)])
        self.norms = nn.ModuleList([normalizer(features, num_classes, bias=True)
                                    for _ in range(n_stages)])
        self.act = act

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        x = self.act(x)
        path = x
        for norm, conv in zip(self.norms, self.convs):
            path = conv_nhwc(conv, _pool5(norm(path, y), maxpool=False))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv unit: ``{i}_{j}_conv`` (ref layers.py:183-205)."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, act: Callable = F.relu):
        super().__init__()
        for i in range(n_blocks):
            for j in range(n_stages):
                setattr(self, f"{i + 1}_{j + 1}_conv",
                        ncsn_conv3x3(features, features, bias=False))
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act

    def forward(self, x: Tensor) -> Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = conv_nhwc(getattr(self, f"{i + 1}_{j + 1}_conv"), self.act(x))
            x = x + residual
        return x


class CondRCUBlock(nn.Module):
    """ref layers.py:208-234: ``{i}_{j}_norm`` before each activation."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, num_classes: int,
                 normalizer: Callable, act: Callable = F.relu):
        super().__init__()
        for i in range(n_blocks):
            for j in range(n_stages):
                setattr(self, f"{i + 1}_{j + 1}_norm",
                        normalizer(features, num_classes, bias=True))
                setattr(self, f"{i + 1}_{j + 1}_conv",
                        ncsn_conv3x3(features, features, bias=False))
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_norm")(x, y)
                x = conv_nhwc(getattr(self, f"{i + 1}_{j + 1}_conv"), self.act(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    """Multi-scale fusion: each input's conv, resized (bilinear, corners
    aligned) to ``shape``, summed (ref layers.py:237-253)."""

    def __init__(self, in_planes: Sequence[int], features: int):
        super().__init__()
        self.convs = nn.ModuleList([ncsn_conv3x3(c, features, bias=True) for c in in_planes])

    def forward(self, xs: Sequence[Tensor], shape: Tuple[int, int]) -> Tensor:
        total = None
        for conv, x in zip(self.convs, xs):
            h = _resize_bilinear_align(conv_nhwc(conv, x), shape)
            total = h if total is None else total + h
        return total


class CondMSFBlock(nn.Module):
    """ref layers.py:256-277."""

    def __init__(self, in_planes: Sequence[int], features: int, num_classes: int,
                 normalizer: Callable):
        super().__init__()
        self.convs = nn.ModuleList([ncsn_conv3x3(c, features, bias=True) for c in in_planes])
        self.norms = nn.ModuleList([normalizer(c, num_classes, bias=True) for c in in_planes])

    def forward(self, xs: Sequence[Tensor], y: Tensor, shape: Tuple[int, int]) -> Tensor:
        total = None
        for norm, conv, x in zip(self.norms, self.convs, xs):
            h = _resize_bilinear_align(conv_nhwc(conv, norm(x, y)), shape)
            total = h if total is None else total + h
        return total


class RefineBlock(nn.Module):
    """RefineNet block: an RCU per input, MSF (more than one input), CRP,
    output RCUs (ref layers.py:280-313)."""

    def __init__(self, in_planes: Sequence[int], features: int, act: Callable = F.relu,
                 start: bool = False, end: bool = False, maxpool: bool = True):
        super().__init__()
        self.adapt_convs = nn.ModuleList([RCUBlock(c, 2, 2, act) for c in in_planes])
        self.output_convs = RCUBlock(features, 3 if end else 1, 2, act)
        if not start:
            self.msf = MSFBlock(in_planes, features)
        self.crp = CRPBlock(features, 2, act, maxpool=maxpool)

    def forward(self, xs: Sequence[Tensor], output_shape: Tuple[int, int]) -> Tensor:
        hs = [rcu(x) for rcu, x in zip(self.adapt_convs, xs)]
        h = self.msf(hs, output_shape) if len(xs) > 1 else hs[0]
        return self.output_convs(self.crp(h))


class CondRefineBlock(nn.Module):
    """ref layers.py:316-347."""

    def __init__(self, in_planes: Sequence[int], features: int, num_classes: int,
                 normalizer: Callable, act: Callable = F.relu, start: bool = False,
                 end: bool = False):
        super().__init__()
        self.adapt_convs = nn.ModuleList([CondRCUBlock(c, 2, 2, num_classes, normalizer, act)
                                          for c in in_planes])
        self.output_convs = CondRCUBlock(features, 3 if end else 1, 2, num_classes,
                                         normalizer, act)
        if not start:
            self.msf = CondMSFBlock(in_planes, features, num_classes, normalizer)
        self.crp = CondCRPBlock(features, 2, num_classes, normalizer, act)

    def forward(self, xs: Sequence[Tensor], y: Tensor,
                output_shape: Tuple[int, int]) -> Tensor:
        hs = [rcu(x, y) for rcu, x in zip(self.adapt_convs, xs)]
        h = self.msf(hs, y, output_shape) if len(xs) > 1 else hs[0]
        return self.output_convs(self.crp(h, y), y)


class ConvMeanPool(nn.Module):
    """Conv, then the 2x2 mean (ref layers.py:350-369); ``adjust_padding``
    pads the top and left by one first (``conv`` is then score_sde's
    ``Sequential(ZeroPad2d, Conv2d)``)."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
                 biases: bool = True, adjust_padding: bool = False):
        super().__init__()
        conv = nn.Conv2d(input_dim, output_dim, kernel_size, stride=1,
                         padding=kernel_size // 2, bias=biases)
        self.conv = nn.Sequential(nn.ZeroPad2d((1, 0, 1, 0)), conv) if adjust_padding else conv

    def forward(self, x: Tensor) -> Tensor:
        return _mean_pool2(conv_nhwc(self.conv, x))


class MeanPoolConv(nn.Module):
    """The 2x2 mean, then conv (ref layers.py:372-381)."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
                 biases: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(input_dim, output_dim, kernel_size, stride=1,
                              padding=kernel_size // 2, bias=biases)

    def forward(self, x: Tensor) -> Tensor:
        return conv_nhwc(self.conv, _mean_pool2(x))


class UpsampleConv(nn.Module):
    """Each pixel repeated 2 x 2, then conv (JAX :268-284)."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
                 biases: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(input_dim, output_dim, kernel_size, stride=1,
                              padding=kernel_size // 2, bias=biases)

    def forward(self, x: Tensor) -> Tensor:
        N, H, W, C = x.shape
        x = x.reshape(N, H, 1, W, 1, C).expand(N, H, 2, W, 2, C).reshape(N, 2 * H, 2 * W, C)
        return conv_nhwc(self.conv, x)


class ResidualBlock(nn.Module):
    """Pre-activation residual block, downsampling by ``ConvMeanPool`` or
    dilated (ref layers.py:455-500)."""

    def __init__(self, input_dim: int, output_dim: int, resample: Optional[str] = None,
                 act: Callable = elu, normalization: Callable = InstanceNorm2dPlus,
                 adjust_padding: bool = False, dilation: int = 1):
        super().__init__()
        self.act, self.resample = act, resample
        mid = input_dim if resample == "down" else output_dim
        self.conv1 = ncsn_conv3x3(input_dim, mid, dilation=dilation)
        self.normalize2 = normalization(mid)
        if resample == "down" and dilation == 1:
            self.conv2 = ConvMeanPool(mid, output_dim, 3, adjust_padding=adjust_padding)
            shortcut = ConvMeanPool(input_dim, output_dim, 1, adjust_padding=adjust_padding)
        else:
            self.conv2 = ncsn_conv3x3(mid, output_dim, dilation=dilation)
            shortcut = (ncsn_conv3x3(input_dim, output_dim, dilation=dilation) if dilation > 1
                        else ncsn_conv1x1(input_dim, output_dim))
        self.identity = output_dim == input_dim and resample is None
        if not self.identity:
            self.shortcut = shortcut
        self.normalize1 = normalization(input_dim)

    def forward(self, x: Tensor) -> Tensor:
        h = conv_nhwc(self.conv1, self.act(self.normalize1(x)))
        h = self.act(self.normalize2(h))
        h = self.conv2(h) if isinstance(self.conv2, ConvMeanPool) else conv_nhwc(self.conv2, h)
        if self.identity:
            return x + h
        s = self.shortcut
        return (s(x) if isinstance(s, ConvMeanPool) else conv_nhwc(s, x)) + h


class ConditionalResidualBlock(nn.Module):
    """The noise-level-conditioned residual block (ref layers.py:397-452;
    JAX :345): norms take (x, y)."""

    def __init__(self, input_dim: int, output_dim: int, num_classes: int,
                 resample: Optional[str] = None, act: Callable = elu,
                 normalization: Callable = None, adjust_padding: bool = False,
                 dilation: int = 1):
        super().__init__()
        self.act, self.resample = act, resample
        mid = input_dim if resample == "down" else output_dim
        self.conv1 = ncsn_conv3x3(input_dim, mid, dilation=dilation)
        self.normalize2 = normalization(mid, num_classes)
        if resample == "down" and dilation == 1:
            self.conv2 = ConvMeanPool(mid, output_dim, 3, adjust_padding=adjust_padding)
            shortcut = ConvMeanPool(input_dim, output_dim, 1, adjust_padding=adjust_padding)
        else:
            self.conv2 = ncsn_conv3x3(mid, output_dim, dilation=dilation)
            shortcut = (ncsn_conv3x3(input_dim, output_dim, dilation=dilation) if dilation > 1
                        else nn.Conv2d(input_dim, output_dim, 1))
        # JAX keeps the identity only without dilation (legacy_layers.py:380-397)
        self.identity = output_dim == input_dim and resample is None and dilation == 1
        if not self.identity:
            self.shortcut = shortcut
        self.normalize1 = normalization(input_dim, num_classes)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        h = conv_nhwc(self.conv1, self.act(self.normalize1(x, y)))
        h = self.act(self.normalize2(h, y))
        h = self.conv2(h) if isinstance(self.conv2, ConvMeanPool) else conv_nhwc(self.conv2, h)
        if self.identity:
            return x + h
        s = self.shortcut
        return (s(x) if isinstance(s, ConvMeanPool) else conv_nhwc(s, x)) + h
