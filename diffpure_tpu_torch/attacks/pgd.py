"""Projected gradient descent (Madry et al.) with EOT (port of
diffpure_tpu/attacks/pgd.py): Linf or L2 steps, random init, signed or raw
gradient steps in Linf, keep-best by the loss or by a miss.

Randomness on integer seeds, JAX's key layout: with ``random_init`` the
seed splits in two, the start drawn with fold_in(seed, 0) and the loop
seeded with fold_in(seed, 1) (JAX's ``split``); without it the loop takes
the seed itself. Iteration i's EOT repetitions run with the seeds
``eot_average`` derives from k_i = fold_in(loop seed, i), and the
iteration's evaluation of its new iterate with fold_in(k_i, 777).
``model_fn(x01, seed) -> logits``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from diffpure_tpu_torch.attacks.eot import eot_average
from diffpure_tpu_torch.attacks.losses import ce_loss
from diffpure_tpu_torch.attacks.perturbations import clip
from diffpure_tpu_torch.utils.prng import fold_in, generator

Tensor = torch.Tensor
ModelFn = Callable[[Tensor, int], Tensor]


@dataclasses.dataclass(frozen=True)
class PGDConfig:
    norm: str = "Linf"  # 'Linf' | 'L2'
    eps: float = 8 / 255
    step_size: float = 2 / 255
    n_iter: int = 50
    eot_iter: int = 1
    random_init: bool = False
    signed: bool = True


def _l2(v: Tensor) -> Tensor:
    return torch.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(-1)).reshape(-1, 1, 1, 1)


def _project(x0: Tensor, z: Tensor, eps: float, norm: str) -> Tensor:
    if norm == "Linf":
        z = clip(z, x0 - eps, x0 + eps)
    else:
        d = z - x0
        n = _l2(d)
        z = x0 + d * torch.minimum(torch.ones_like(n), eps / torch.clamp(n, min=1e-12))
    return clip(z, 0.0, 1.0)


def pgd_attack(model_fn: ModelFn, x: Tensor, y: Tensor, seed: int, cfg: PGDConfig,
               loss_fn=None) -> Tuple[Tensor, Tensor]:
    """Maximise ``loss_fn(logits)`` (default per-example cross-entropy)
    within the eps-ball; returns (x_best, found)."""
    x, y = x.detach(), y.detach()
    if loss_fn is None:
        loss_fn = lambda logits: ce_loss(logits, y)  # noqa: E731
    B = x.shape[0]
    if cfg.random_init:
        g0 = generator(seed, 0, device=x.device)
        seed = fold_in(seed, 1)
        if cfg.norm == "Linf":
            u = torch.rand(x.shape, generator=g0, device=x.device, dtype=x.dtype)
            x_adv = x + cfg.eps * (2 * u - 1)
        else:
            d = torch.randn(x.shape, generator=g0, device=x.device, dtype=x.dtype)
            r = torch.rand((B, 1, 1, 1), generator=g0, device=x.device,
                           dtype=x.dtype) ** (1.0 / d[0].numel())
            x_adv = x + cfg.eps * r * d / torch.clamp(_l2(d), min=1e-12)
        x_adv = clip(x_adv, 0.0, 1.0)
    else:
        x_adv = x

    def grad_step(s: int):
        xx = x_adv.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss_fn(model_fn(xx, s)).sum(), xx)
        return (g,)

    x_best = x_adv
    loss_best = torch.full((B,), float("-inf"), device=x.device)
    found = torch.zeros(B, dtype=torch.bool, device=x.device)
    for i in range(cfg.n_iter):
        k_i = fold_in(seed, i)
        (g,) = eot_average(grad_step, k_i, cfg.eot_iter)
        if cfg.norm == "Linf":
            step = cfg.step_size * (torch.sign(g) if cfg.signed else g)
        else:
            step = cfg.step_size * g / torch.clamp(_l2(g), min=1e-12)
        x_adv = _project(x, x_adv + step, cfg.eps, cfg.norm)
        with torch.no_grad():
            logits = model_fn(x_adv, fold_in(k_i, 777))
            losses = loss_fn(logits)
        wrong = logits.argmax(-1) != y
        x_best = torch.where((losses > loss_best)[:, None, None, None] | wrong[:, None, None, None],
                             x_adv, x_best)
        loss_best = torch.maximum(losses, loss_best)
        found = found | wrong
    return x_best, found
