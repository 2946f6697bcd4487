"""The small classifiers of the defence demonstration (port of
diffpure_tpu/classifiers/small_cnn.py).

Deliberately standard (non-robust) models, trained with cross-entropy and
no augmentation: the kind of classifier DiffPure defends. Input: x01 NHWC
in [0, 1]. Parameter names are flax's module names (``Conv_0`` ...
``Dense_1``), so ``classifiers/convert.small_cnn_state_dict_from_flax``
maps one to one.

Two details carry flax's semantics: ``SAME`` padding of a stride-2 conv on
an even map pads (0, 1), not (1, 1) (``_same_pad``), and the flatten before
the first ``Dense`` runs over NHWC. Fresh weights are drawn as flax draws
them (``init_``: LeCun normal kernels, zero biases).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.models.init import lecun_normal_
from diffpure_tpu_torch.ops.conv import conv2d_nhwc
from diffpure_tpu_torch.training.losses import Adam, apply_updates
from diffpure_tpu_torch.utils.prng import generator as make_generator

Tensor = torch.Tensor


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax / XLA 'SAME': the total padding splits low = total // 2."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _init_(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)


class SmallCNN(nn.Module):
    """conv-conv(stride 2) twice, then a dense head."""

    def __init__(self, n_classes: int = 4, width: int = 32, size: int = 16,
                 channels: int = 3):
        super().__init__()
        w = width
        self.Conv_0 = nn.Conv2d(channels, w, 3)
        self.Conv_1 = nn.Conv2d(w, w, 3)
        self.Conv_2 = nn.Conv2d(w, 2 * w, 3)
        self.Conv_3 = nn.Conv2d(2 * w, 2 * w, 3)
        s = (size + 3) // 4  # two stride-2 SAME convs: ceil(size / 4)
        self.Dense_0 = nn.Linear(s * s * 2 * w, 4 * w)
        self.Dense_1 = nn.Linear(4 * w, n_classes)

    def init_(self, generator: torch.Generator) -> "SmallCNN":
        _init_(self, generator)
        return self

    def forward(self, x01: Tensor) -> Tensor:
        x = (x01 - 0.5) * 2.0
        for conv, stride in ((self.Conv_0, 1), (self.Conv_1, 2), (self.Conv_2, 1),
                             (self.Conv_3, 2)):
            (t, b), (l_, r) = _same_pad(x.shape[1], 3, stride), _same_pad(x.shape[2], 3, stride)
            x = F.pad(x, (0, 0, l_, r, t, b))  # NHWC: C, then W, then H
            x = F.relu(conv2d_nhwc(x, conv.weight, conv.bias, stride=stride, padding=0))
        x = x.reshape(x.shape[0], -1)
        return self.Dense_1(F.relu(self.Dense_0(x)))


class SmallMLP(nn.Module):
    """A flattened-input MLP: fast on the CPU, and canonically fragile."""

    def __init__(self, n_classes: int = 4, width: int = 128, size: int = 16,
                 channels: int = 3):
        super().__init__()
        self.Dense_0 = nn.Linear(size * size * channels, width)
        self.Dense_1 = nn.Linear(width, width // 2)
        self.Dense_2 = nn.Linear(width // 2, n_classes)

    def init_(self, generator: torch.Generator) -> "SmallMLP":
        _init_(self, generator)
        return self

    def forward(self, x01: Tensor) -> Tensor:
        x = ((x01 - 0.5) * 2.0).reshape(x01.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


def train_classifier(seed: int, sample_fn: Callable, *, n_classes: int = 4,
                     width: int = 32, steps: int = 1000, batch_size: int = 128,
                     lr: float = 1e-3, scan_chunk: int = 100, n_train: int = 0,
                     arch: str = "cnn", device="cuda", model: Optional[nn.Module] = None):
    """Train a SmallCNN (or SmallMLP); returns (model, final_loss).

    ``sample_fn(generator, n) -> (x in [-1, 1] NHWC, y)``. With n_train > 0
    a fixed training set of that size is drawn once (stream (seed,
    999983)) and each step's minibatch indices come from stream (seed, i):
    the finite-data regime in which a standard classifier turns fragile.
    With n_train == 0 step i draws a fresh batch from stream (seed, i).
    As in JAX, training runs in whole chunks of ``scan_chunk`` steps, at
    least one. ``model`` replaces the fresh flax-style init (drawn on the
    CPU from stream (seed, 999979)). It trains on ``device``, the card
    unless the caller asks for the CPU; with no card the default raises.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"train_classifier(device={device!r}): no CUDA device is "
                           f"available (pass device='cpu' to train on the CPU)")
    gen = lambda *path: make_generator(seed, *path, device=dev)  # noqa: E731
    if model is None:
        x0, _ = sample_fn(gen(), 2)
        size, channels = x0.shape[1], x0.shape[3]
        cls = SmallMLP if arch == "mlp" else SmallCNN
        model = cls(n_classes=n_classes, width=max(width, 64) if arch == "mlp" else width,
                    size=size, channels=channels)
        model.init_(make_generator(seed, 999_979))
    model = model.to(dev)
    params = list(model.parameters())
    opt = Adam(lr=lr)
    state = opt.init(params)
    if n_train > 0:
        xtr, ytr = sample_fn(gen(999_983), n_train)
    loss = None
    for i in range(max(steps // scan_chunk, 1) * scan_chunk):
        if n_train > 0:
            idx = torch.randint(0, n_train, (batch_size,), generator=gen(i), device=dev)
            x, y = xtr[idx], ytr[idx]
        else:
            x, y = sample_fn(gen(i), batch_size)
        loss = F.cross_entropy(model((x + 1.0) * 0.5), y.long())
        grads = torch.autograd.grad(loss, params)
        updates, state = opt.update(grads, state, params)
        apply_updates(params, updates)
    return model, float(loss.detach())
