"""The procedural image distribution of the defence demonstration (port of
diffpure_tpu/data/synthetic.py).

Oriented gratings: class c fixes the orientation c * pi / n_classes; the
phase, a per-channel amplitude, a small per-channel DC shift and i.i.d.
pixel noise are nuisances. The class signal is low-frequency, so it
survives forward diffusion to t* (what makes purification work on real
image classes too). A Gaussian-mixture variant has a closed-form VP-SDE
score (``gmm_vp_eps_model``), which lets the whole attack protocol run
without training a score network.

Draws come from an explicit ``torch.Generator``; ``grating_batch`` and
``gmm_batch`` build a batch from given draws, which is how the tests feed
the port JAX's draws (torch cannot reproduce JAX's threefry bits).
Images are NHWC in [-1, 1], labels int64.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Optional, Tuple

import torch

from diffpure_tpu_torch.utils.prng import generator as make_generator

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    """Static description of the grating distribution."""

    size: int = 16
    n_classes: int = 4
    channels: int = 3
    freq: float = 2.0          # cycles per image side
    amp_range: Tuple[float, float] = (0.55, 0.95)
    dc_range: float = 0.1      # per-channel DC shift in [-dc, dc]
    noise_std: float = 0.04    # i.i.d. pixel noise (manifold thickness)

    def orientation(self, y: Tensor) -> Tensor:
        return y.float() * (math.pi / self.n_classes)


def _grid(spec: SyntheticSpec, device) -> Tuple[Tensor, Tensor]:
    coord = torch.arange(spec.size, dtype=torch.float32, device=device) \
        - (spec.size - 1) / 2.0
    return torch.meshgrid(coord, coord, indexing="ij")


def _waves(spec: SyntheticSpec, y: Tensor, phase) -> Tensor:
    """sin(2 pi freq / S * <(i, j), direction(y)> + phase), (n, S, S)."""
    ii, jj = _grid(spec, y.device)
    theta = spec.orientation(y)
    proj = torch.cos(theta)[:, None, None] * ii[None] + torch.sin(theta)[:, None, None] * jj[None]
    if torch.is_tensor(phase):
        phase = phase[:, None, None]
    return torch.sin(2 * math.pi * spec.freq / spec.size * proj + phase)


def grating_batch(spec: SyntheticSpec, y: Tensor, phase: Tensor, amp: Tensor,
                  dc: Tensor, noise: Tensor) -> Tuple[Tensor, Tensor]:
    """The batch from its draws: y (n,), phase (n,) in [0, 2 pi), amp and
    dc (n, 1, 1, C), noise (n, S, S, C) standard normal."""
    x = amp * _waves(spec, y, phase)[..., None] + dc
    x = x + spec.noise_std * noise
    return torch.clamp(x, -1.0, 1.0).float(), y.long()


def sample_batch(generator: Optional[torch.Generator], n: int,
                 spec: SyntheticSpec = SyntheticSpec()) -> Tuple[Tensor, Tensor]:
    """n labelled images, drawn on the generator's device."""
    dev = generator.device if generator is not None else None
    C, S = spec.channels, spec.size
    kw = dict(generator=generator, device=dev)
    y = torch.randint(0, spec.n_classes, (n,), **kw)
    phase = torch.rand(n, **kw) * (2 * math.pi)
    lo, hi = spec.amp_range
    amp = lo + (hi - lo) * torch.rand(n, 1, 1, C, **kw)
    dc = -spec.dc_range + 2 * spec.dc_range * torch.rand(n, 1, 1, C, **kw)
    noise = torch.randn(n, S, S, C, **kw)
    return grating_batch(spec, y, phase, amp, dc, noise)


def class_means(spec: SyntheticSpec, amp: float = 0.3, phase: float = 0.7,
                device="cuda") -> Tensor:
    """One fixed grating per class, no nuisances: the means of the
    Gaussian mixture. (n_classes, S, S, C), on ``device``: the card unless
    the caller asks for the CPU; with no card the default raises."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"class_means(device={device!r}): no CUDA device is available "
                           f"(pass device='cpu' to build them on the CPU)")
    y = torch.arange(spec.n_classes, device=device)
    wave = amp * _waves(spec, y, phase)
    return wave[..., None].expand(-1, -1, -1, spec.channels).contiguous()


def gmm_batch(spec: SyntheticSpec, y: Tensor, z: Tensor, amp: float = 0.3,
              noise_std: float = 0.08) -> Tuple[Tensor, Tensor]:
    """x = mean_y + noise_std z, clipped to [-1, 1]."""
    x = class_means(spec, amp, device=y.device)[y.long()] + noise_std * z
    return torch.clamp(x, -1.0, 1.0).float(), y.long()


def sample_gmm_batch(generator: Optional[torch.Generator], n: int, spec: SyntheticSpec,
                     amp: float = 0.3, noise_std: float = 0.08) -> Tuple[Tensor, Tensor]:
    """The Gaussian-mixture variant: x | y ~ N(mean_y, noise_std^2 I)."""
    dev = generator.device if generator is not None else None
    y = torch.randint(0, spec.n_classes, (n,), generator=generator, device=dev)
    z = torch.randn(n, spec.size, spec.size, spec.channels, generator=generator, device=dev)
    return gmm_batch(spec, y, z, amp, noise_std)


def gmm_vp_eps_model(spec: SyntheticSpec, amp: float = 0.3, noise_std: float = 0.08,
                     beta_min: float = 0.1, beta_max: float = 20.0
                     ) -> Callable[[Tensor, Tensor], Tensor]:
    """The exact epsilon model of the mixture under the VP-SDE, called as a
    score model is, ``model(x, t * 999)`` (eps = -score * std).

    x_t | y ~ N(a(t) mu_y, v(t) I) with a(t) = exp(-t^2 (bmax - bmin) / 4 -
    t bmin / 2) and v(t) = a^2 sigma0^2 + 1 - a^2; the mixture's score is
    the responsibility-weighted Gaussian score.
    """
    cache = {}

    def model_fn(x: Tensor, t_cond: Tensor) -> Tensor:
        if x.device not in cache:
            cache[x.device] = class_means(spec, amp, device=x.device).reshape(
                spec.n_classes, -1)
        mu_flat = cache[x.device]                                   # (K, D)
        t = t_cond.float() / 999.0
        log_a = -0.25 * t ** 2 * (beta_max - beta_min) - 0.5 * t * beta_min
        a = torch.exp(log_a)[:, None]                               # (B, 1)
        v = a ** 2 * noise_std ** 2 + (1.0 - a ** 2)
        xf = x.reshape(x.shape[0], -1)                              # (B, D)
        diff = xf[:, None, :] - a[:, None] * mu_flat[None]          # (B, K, D)
        logits = -0.5 * torch.sum(diff ** 2, dim=-1) / v            # (B, K)
        resp = torch.softmax(logits, dim=-1)
        score = -(xf - a * (resp @ mu_flat)) / v
        std = torch.sqrt(torch.clamp(1.0 - a ** 2, min=1e-12))
        return (-score * std).reshape(x.shape).to(x.dtype)

    return model_fn


def dataset_iterator(seed: int, batch_size: int, spec: SyntheticSpec = SyntheticSpec(),
                     device=None) -> Iterator[Tuple[Tensor, dict]]:
    """Infinite (x, model_kwargs) batches in TrainLoop's data contract;
    batch i from the stream (seed, i)."""
    i = 0
    while True:
        x, _ = sample_batch(make_generator(seed, i, device=device), batch_size, spec)
        yield x, {}
        i += 1
