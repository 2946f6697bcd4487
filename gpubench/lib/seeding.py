"""Everything a run draws comes from ``--seed``: weights, inputs, labels and
the defence's noise, each from its own stream, on the device.

A stream is named by the run's seed and a path of small integers and
seeds its own ``torch.Generator``. The same seed gives the same draws in
the program's call and in the reference's, which asks for them again.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn

Tensor = torch.Tensor

_MASK = (1 << 64) - 1

# stream ids (the first element of a path)
WEIGHTS, INPUTS, LABELS, FORWARD_EPS, BROWNIAN, T_OFFSET, SAMPLE = range(7)


def mix(seed: int, *path: int) -> int:
    """A 63-bit seed from ``seed`` (any integer) and ``path`` (splitmix64)."""
    z = int(seed) & _MASK
    for p in path:
        z = (z * 0x9E3779B97F4A7C15 + int(p) + 0x632BE59BD9B4E019) & _MASK
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        z ^= z >> 31
    return z >> 1


def fold_in(seed: int, data: int) -> int:
    """The defence's EOT seeds: sample i of a call seeded s runs with
    fold_in(s, i) (splitmix64's finaliser over s * golden + i)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) >> 1


def generator(device, seed: int, *path: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, *path))
    return g


class Noise:
    """The defence's noise for one call: the program's ``Noise`` protocol
    (``forward_eps``, ``brownian``, ``t_offset``), one stream per draw, so
    any draw can be made again from (seed, round, step) alone."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def t_offset(self, it: int, t_delta: int) -> int:
        g = generator("cpu", self.seed, T_OFFSET, it)
        return int(torch.randint(-t_delta, t_delta, (), generator=g))

    def forward_eps(self, it: int, shape, like: Tensor) -> Tensor:
        g = generator(like.device, self.seed, FORWARD_EPS, it)
        return torch.randn(tuple(shape), generator=g, device=like.device, dtype=like.dtype)

    def brownian(self, it: int, i: int, like: Tensor, dt: float) -> Tensor:
        g = generator(like.device, self.seed, BROWNIAN, it, i)
        return torch.randn(like.shape, generator=g, device=like.device,
                           dtype=like.dtype) * math.sqrt(abs(dt))


def images(seed: int, call: int, shape: Tuple[int, ...], device) -> Tensor:
    """A call's [0, 1] NHWC images."""
    return torch.rand(shape, generator=generator(device, seed, INPUTS, call), device=device)


def labels(seed: int, call: int, n: int, classes: int, device) -> Tensor:
    return torch.randint(0, classes, (n,), generator=generator(device, seed, LABELS, call),
                         device=device)


def state_dict(module: nn.Module, seed: int, device, fixed: Dict[str, Tensor] = None
               ) -> Dict[str, Tensor]:
    """Weights for ``module`` (built on the meta device), made on ``device``
    from one normal draw: N(0, 1) / sqrt(fan_in) for kernels and matrices
    (NIN ``W`` is (in, out)), 1 + 0.1 N for norm scales, 0.1 N for biases
    and running means, running variances uniform on [0.5, 1.5] (0.5 plus
    the normal CDF of the draw). ``fixed``: buffers given as they are. The
    tensors are views of one float32 buffer."""
    fixed = fixed or {}
    shapes = {k: tuple(t.shape) for k, t in module.state_dict().items()
              if k not in fixed and not k.endswith("num_batches_tracked")}
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(device, seed, WEIGHTS), device=device)
    out, off = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "running_var":
            v.copy_(torch.special.ndtr(v)).add_(0.5)
        elif leaf == "weight" and len(shape) == 1:
            v.mul_(0.1).add_(1.0)
        elif len(shape) == 1:
            v.mul_(0.1)
        else:
            v.mul_(1.0 / math.sqrt(shape[0] if leaf == "W" else math.prod(shape[1:])))
        out[key] = v
    for key in module.state_dict():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=torch.long, device=device)
    out.update({k: v.to(device) for k, v in fixed.items()})
    return out
