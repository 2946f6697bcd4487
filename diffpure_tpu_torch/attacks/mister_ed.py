"""Attacks over parameterized perturbations: mister_ed's (port of
diffpure_tpu/attacks/mister_ed.py; ref mister_ed/adversarial_attacks.py).

``perturbation_pgd`` is the PGD driver over any ``Perturbation`` (ref
:240-404): signed steps, or Adam; EOT-averaged gradients; a per-example
keep-best. ``fgsm`` is one signed cross-entropy step (ref :170-236),
``carlini_wagner`` the L2 attack in tanh space (ref :425+). The objective
is mister_ed's RegularizedLoss with the negate convention folded in
(loss_functions.py:33-100): CW-f6 plus a weighted perturbation norm,
minimised.

Adam is optax's arithmetic (``training.losses.Adam``, which PR-level
parity tests hold against optax; ``torch.optim.Adam`` rounds in another
order). Randomness, JAX's key layout on integer seeds, as the port's
other attacks: iteration i's EOT repetitions run with the seeds
``eot_average`` derives from fold_in(seed, i); the random init draws with
fold_in(seed, 999), the last classification with fold_in(seed, 123321);
Carlini-Wagner's per-iteration check with fold_in(fold_in(seed, i), 3).
``model_fn(x01, seed) -> logits``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from diffpure_tpu_torch.attacks.eot import eot_average
from diffpure_tpu_torch.attacks.losses import ce_loss, margin_loss
from diffpure_tpu_torch.attacks.perturbations import Perturbation, leaves, unflatten
from diffpure_tpu_torch.training.losses import Adam
from diffpure_tpu_torch.utils.prng import fold_in, generator

Tensor = torch.Tensor
ModelFn = Callable[[Tensor, int], Tensor]  # (x01, seed) -> logits


def cw_f6(logits: Tensor, y: Tensor, kappa: float = float("inf"),
          targeted: bool = False) -> Tensor:
    """The minimised CW f6 (ref loss_functions.py:214-244): the margin
    z_y - max_other (its negative when targeted), floored at -kappa."""
    m = margin_loss(logits, y)
    out = -m if targeted else m
    if kappa != float("inf"):
        out = torch.maximum(out, torch.full_like(out, -kappa))
    return out


@dataclasses.dataclass(frozen=True)
class MisterEdPGDConfig:
    num_iterations: int = 20
    step_size: float = 1.0 / 255.0
    optimizer_lr: Optional[float] = None  # set: Adam steps; unset: signed steps
    eot_iter: int = 1
    keep_best: bool = True
    random_init: bool = False
    perturbation_norm_weight: float = 0.0
    kappa: float = float("inf")


def _grads(fn: Callable[[list], Tensor], flat: list) -> Tuple[list, Tensor]:
    """(d sum(per_ex) / d flat, per_ex) for per_ex = fn(flat)."""
    flat = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        per_ex = fn(flat)
        grads = torch.autograd.grad(per_ex.sum(), flat)
    return list(grads), per_ex.detach()


def perturbation_pgd(model_fn: ModelFn, perturbation: Perturbation, x: Tensor, y: Tensor,
                     seed: int, cfg: MisterEdPGDConfig) -> Tuple[Tensor, Tensor]:
    """PGD over the perturbation's params; returns (x_adv, found).

    Minimises cw_f6 + weight * perturbation.norm at the projected params
    (ref PGD.attack:341-382). ``per_ex`` is the objective before the
    iteration's update; the kept params are those after it, as in JAX."""
    x, y = x.detach(), y.detach()
    params = perturbation.init_params(x)
    if cfg.random_init:
        params = perturbation.random_init(fold_in(seed, 999), params, x)
    flat = [p.detach() for p in leaves(params)]
    adam = Adam(lr=cfg.optimizer_lr) if cfg.optimizer_lr is not None else None
    opt_state = adam.init(flat) if adam is not None else None

    def objective(flat_p: list, s: int) -> Tensor:
        p = perturbation.project(unflatten(params, flat_p), x)
        per_ex = cw_f6(model_fn(perturbation.apply(p, x), s), y, cfg.kappa)
        if cfg.perturbation_norm_weight:
            per_ex = per_ex + cfg.perturbation_norm_weight * perturbation.norm(p, x)
        return per_ex

    def single(s: int):
        g, per_ex = _grads(lambda fp: objective(fp, s), flat)
        return (*g, per_ex)

    best, best_score = flat, torch.full((x.shape[0],), float("inf"), device=x.device)
    for i in range(cfg.num_iterations):
        *g, per_ex = eot_average(single, fold_in(seed, i), cfg.eot_iter)
        if adam is not None:
            updates, opt_state = adam.update(g, opt_state)
            flat = [p + u for p, u in zip(flat, updates)]
        else:
            flat = [p - cfg.step_size * torch.sign(gg) for p, gg in zip(flat, g)]
        if cfg.keep_best:
            improved = per_ex < best_score
            best = leaves(perturbation.merge(unflatten(params, flat), unflatten(params, best),
                                             improved))
            best_score = torch.minimum(per_ex, best_score)
        else:
            best, best_score = flat, per_ex

    with torch.no_grad():
        x_adv = perturbation.apply(perturbation.project(unflatten(params, best), x), x)
        logits = model_fn(x_adv, fold_in(seed, 123_321))
    return x_adv, logits.argmax(-1) != y


def fgsm(model_fn: ModelFn, x: Tensor, y: Tensor, seed: int, eps: float = 8 / 255) -> Tensor:
    """One signed cross-entropy step (ref adversarial_attacks.py:170-236);
    the model runs with ``seed`` itself."""
    (g,), _ = _grads(lambda fp: ce_loss(model_fn(fp[0], seed), y), [x.detach()])
    return torch.clamp(x.detach() + eps * torch.sign(g), 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class CarliniWagnerConfig:
    num_iterations: int = 100
    lr: float = 1e-2
    initial_const: float = 1e-1
    kappa: float = 0.0


def carlini_wagner(model_fn: ModelFn, x: Tensor, y: Tensor, seed: int,
                   cfg: CarliniWagnerConfig) -> Tuple[Tensor, Tensor]:
    """The L2 CW attack in tanh space (ref adversarial_attacks.py:425+):
    minimise ||x' - x||^2 + c f6(x') with Adam; returns (x_adv, found).
    An iterate is kept where it is misclassified and its distance (taken
    before the update, as in JAX) beats the kept one."""
    x, y = x.detach(), y.detach()
    x_c = torch.clamp(x, 1e-6, 1 - 1e-6)
    w = torch.atanh(2 * x_c - 1)
    adam = Adam(lr=cfg.lr)
    opt_state = adam.init([w])
    B = x.shape[0]
    dist = None

    def objective(fp: list, s: int) -> Tensor:
        nonlocal dist
        x_t = (torch.tanh(fp[0]) + 1) / 2
        d = ((x_t - x).reshape(B, -1) ** 2).sum(-1)
        m = margin_loss(model_fn(x_t, s), y)
        dist = d.detach()
        return d + cfg.initial_const * torch.maximum(m, torch.full_like(m, -cfg.kappa))

    best_x = x
    best_dist = torch.full((B,), float("inf"), device=x.device)
    found = torch.zeros(B, dtype=torch.bool, device=x.device)
    for i in range(cfg.num_iterations):
        k_i = fold_in(seed, i)
        g, _ = _grads(lambda fp: objective(fp, k_i), [w])
        updates, opt_state = adam.update(g, opt_state)
        w = w + updates[0]
        with torch.no_grad():
            x_t = (torch.tanh(w) + 1) / 2
            wrong = model_fn(x_t, fold_in(k_i, 3)).argmax(-1) != y
        improved = wrong & (dist < best_dist)
        best_x = torch.where(improved[:, None, None, None], x_t, best_x)
        best_dist = torch.where(improved, dist, best_dist)
        found = found | wrong
    return best_x, found


@dataclasses.dataclass
class AdversarialAttackParameters:
    """Attack orchestration (ref mister_ed/adversarial_training.py:35): an
    attack callable ``attack_fn(x, y, seed) -> (x_adv, found)`` and the
    proportion of each batch to attack."""

    attack_fn: Callable
    proportion_attacked: float = 1.0

    def attack(self, x: Tensor, y: Tensor, seed: int):
        """Attack a random ``proportion_attacked`` of the batch (the
        permutation drawn with fold_in(seed, 0), the attack run with
        fold_in(seed, 1)); returns (x_out, y, adv_mask)."""
        B = x.shape[0]
        n_attack = max(int(round(self.proportion_attacked * B)), 0)
        perm = torch.randperm(B, generator=generator(seed, 0)).to(x.device)
        mask = torch.zeros(B, dtype=torch.bool, device=x.device)
        mask[perm[:n_attack]] = True
        x_adv, _ = self.attack_fn(x, y, fold_in(seed, 1))
        return torch.where(mask[:, None, None, None], x_adv, x), y, mask
