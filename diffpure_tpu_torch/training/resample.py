"""Timestep samplers for diffusion training (port of
diffpure_tpu/training/resample.py; ref guided_diffusion/resample.py:1-162).

Uniform sampling, and importance sampling by the loss's second moment with
a per-timestep ring buffer of recent losses. Draws take an explicit
``torch.Generator``; ``sample`` also takes the timesteps themselves
(``t=``), which is how the tests hand it JAX's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def create_named_schedule_sampler(name: str, num_timesteps: int):
    """ref resample.py:12-24."""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler.create(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


def _device(generator, device):
    return generator.device if generator is not None and device is None else device


@dataclasses.dataclass(frozen=True)
class UniformSampler:
    """ref resample.py:63-72."""
    num_timesteps: int

    def sample(self, generator, batch_size: int, device=None,
               t: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        if t is None:
            t = torch.randint(0, self.num_timesteps, (batch_size,), generator=generator,
                              device=_device(generator, device))
        return t, torch.ones(batch_size, device=t.device)


@dataclasses.dataclass
class LossSecondMomentResampler:
    """Importance sampling ~ sqrt(E[loss^2]) with uniform mixing
    (ref resample.py:110-162). Its history lives on the CPU."""
    loss_history: Tensor  # (T, history)
    loss_counts: Tensor   # (T,)
    num_timesteps: int
    history_per_term: int = 10
    uniform_prob: float = 1e-3

    @staticmethod
    def create(num_timesteps: int, history_per_term: int = 10,
               uniform_prob: float = 1e-3) -> "LossSecondMomentResampler":
        return LossSecondMomentResampler(
            loss_history=torch.zeros(num_timesteps, history_per_term),
            loss_counts=torch.zeros(num_timesteps, dtype=torch.int32),
            num_timesteps=num_timesteps, history_per_term=history_per_term,
            uniform_prob=uniform_prob)

    def _warmed_up(self) -> bool:
        return bool(torch.all(self.loss_counts == self.history_per_term))

    def weights(self) -> Tensor:
        """ref resample.py:135-142."""
        if not self._warmed_up():
            return torch.ones(self.num_timesteps) / self.num_timesteps
        w = torch.sqrt(torch.mean(self.loss_history ** 2, dim=-1))
        w = w / torch.clamp(torch.sum(w), min=1e-12)
        return w * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps

    def sample(self, generator, batch_size: int, device=None,
               t: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """ref resample.py:42-60: t ~ p, weights = 1 / (T p(t))."""
        p = self.weights()
        if t is None:
            g_dev = generator.device if generator is not None else torch.device("cpu")
            t = torch.multinomial(p.to(g_dev), batch_size, replacement=True,
                                  generator=generator)
        dev = device if device is not None else t.device
        weights = 1.0 / (self.num_timesteps * p[t.cpu().long()])
        return t.to(dev), weights.to(dev)

    def update_with_losses(self, ts: Tensor, losses: Tensor) -> "LossSecondMomentResampler":
        """The ring-buffer update (ref resample.py:144-155): a full row
        shifts left and takes the loss last, else the loss is appended."""
        hist, counts = self.loss_history.clone(), self.loss_counts.clone()
        for t, loss in zip(ts.cpu().tolist(), losses.detach().float().cpu().tolist()):
            c = int(counts[t])
            if c == self.history_per_term:
                hist[t] = torch.roll(hist[t], -1)
                hist[t, -1] = loss
            else:
                hist[t, c] = loss
                counts[t] = c + 1
        return dataclasses.replace(self, loss_history=hist, loss_counts=counts)
