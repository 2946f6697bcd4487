"""The NCSN family's normalisations over NHWC maps (port of
diffpure_tpu/models/normalization.py; ref
score_sde/models/normalization.py:22-215).

Unconditional instance, variance and no normalisation, NCSNv2's default
``InstanceNorm2dPlus`` (instance norm with the channel means put back,
scaled by ``alpha``), and the conditional forms that look their scales up
by the noise-level index ``y`` in ``embed`` (an ``nn.Embedding`` whose
weight rows are [gamma, alpha, beta], as score_sde's; flax keeps the same
table untransposed as ``embed/embedding``). Statistics as JAX takes them:
the spatial variance with ddof 0, the variance of the channel means with
ddof 1 (torch's unbiased ``var``, JAX :96), eps 1e-5.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn as nn

Tensor = torch.Tensor


def get_normalization(normalization: str, conditional: bool = False,
                      num_classes: int = 0) -> Callable[[int], nn.Module]:
    """A constructor ``norm(num_features)`` by name (ref
    normalization.py:22-40)."""
    if conditional:
        if normalization == "InstanceNorm++":
            return functools.partial(ConditionalInstanceNorm2dPlus, num_classes=num_classes)
        raise NotImplementedError(f"{normalization} has no conditional form")
    if normalization == "InstanceNorm":
        return InstanceNorm2d
    if normalization == "InstanceNorm++":
        return InstanceNorm2dPlus
    if normalization == "VarianceNorm":
        return VarianceNorm2d
    if normalization == "GroupNorm":
        from diffpure_tpu_torch.models.layers import GroupNormTorch
        return lambda c: GroupNormTorch(32, c, eps=1e-5)
    raise ValueError(f"unknown normalization: {normalization}")


def _instance_norm(x: Tensor, eps: float = 1e-5) -> Tensor:
    """Per (example, channel) spatial normalisation, no affine."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def _normalized_means(x: Tensor) -> Tensor:
    """The (N, C) channel means, normalised across channels (ddof 1)."""
    means = x.mean(dim=(1, 2))
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, keepdim=True, unbiased=True)
    return (means - m) * torch.rsqrt(v + 1e-5)


def _init_scale(c: int) -> nn.Parameter:
    return nn.Parameter(1.0 + 0.02 * torch.randn(c))


class InstanceNorm2d(nn.Module):
    """``nn.InstanceNorm2d(affine=True)`` over NHWC (``weight``, ``bias``)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        return _instance_norm(x, self.eps) * self.weight + self.bias


class VarianceNorm2d(nn.Module):
    """x / sqrt(var + 1e-5) scaled by ``alpha`` (ref normalization.py:110-123;
    the variance with ddof 0, as JAX takes it)."""

    def __init__(self, num_features: int, bias: bool = False):
        super().__init__()
        self.alpha = _init_scale(num_features)

    def forward(self, x: Tensor) -> Tensor:
        var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
        return self.alpha * (x * torch.rsqrt(var + 1e-5))


class NoneNorm2d(nn.Module):
    """The identity (ref normalization.py:149-154)."""

    def __init__(self, num_features: int = 0, bias: bool = True):
        super().__init__()

    def forward(self, x: Tensor) -> Tensor:
        return x


class InstanceNorm2dPlus(nn.Module):
    """Instance norm plus the normalised channel means times ``alpha``,
    then ``gamma`` (and ``beta``) (ref normalization.py:157-183)."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.alpha = _init_scale(num_features)
        self.gamma = _init_scale(num_features)
        self.beta = nn.Parameter(torch.zeros(num_features)) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        h = _instance_norm(x) + _normalized_means(x)[:, None, None, :] * self.alpha
        out = self.gamma * h
        return out + self.beta if self.beta is not None else out


class _Embed(nn.Embedding):
    """Per-class scales: rows 1 + 0.02 N, the last chunk (beta) zero."""

    def __init__(self, num_classes: int, chunks: int, features: int, zero_last: bool):
        super().__init__(num_classes, chunks * features)
        with torch.no_grad():
            self.weight.normal_(1.0, 0.02)
            if zero_last and chunks > 1:
                self.weight[:, (chunks - 1) * features:] = 0.0


class ConditionalInstanceNorm2dPlus(nn.Module):
    """``InstanceNorm2dPlus`` with gamma, alpha and beta looked up by the
    class ``y`` (ref normalization.py:186-215)."""

    def __init__(self, num_features: int, num_classes: int = 10, bias: bool = True):
        super().__init__()
        self.bias = bias
        self.embed = _Embed(num_classes, 3 if bias else 2, num_features, bias)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        emb = self.embed(y.long())
        if self.bias:
            gamma, alpha, beta = emb.chunk(3, dim=-1)
        else:
            (gamma, alpha), beta = emb.chunk(2, dim=-1), None
        h = _instance_norm(x) + _normalized_means(x)[:, None, None, :] * alpha[:, None, None, :]
        out = gamma[:, None, None, :] * h
        return out + beta[:, None, None, :] if beta is not None else out


class ConditionalVarianceNorm2d(nn.Module):
    """``VarianceNorm2d`` with its scale looked up by ``y`` (ref
    normalization.py:93-107)."""

    def __init__(self, num_features: int, num_classes: int = 10, bias: bool = False):
        super().__init__()
        self.embed = _Embed(num_classes, 1, num_features, False)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
        return self.embed(y.long())[:, None, None, :] * (x * torch.rsqrt(var + 1e-5))


class ConditionalNoneNorm2d(nn.Module):
    """gamma x (+ beta) looked up by ``y`` (ref normalization.py:126-146)."""

    def __init__(self, num_features: int, num_classes: int = 10, bias: bool = True):
        super().__init__()
        self.bias = bias
        self.embed = _Embed(num_classes, 2 if bias else 1, num_features, bias)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        emb = self.embed(y.long())
        if self.bias:
            gamma, beta = emb.chunk(2, dim=-1)
            return gamma[:, None, None, :] * x + beta[:, None, None, :]
        return emb[:, None, None, :] * x
