"""Auto-PGD (APGD) with momentum, adaptive step halving and EOT (port of
diffpure_tpu/attacks/apgd.py).

The same control flow as the JAX attack, which reimplements AutoAttack's
APGD (the reference's torch-only dependency): Linf/L2 steps, momentum 0.75
after the first step, the checkpoint schedule p_{j+1} = p_j + max(p_j -
p_{j-1} - 0.03, 0.06) from (0, 0.22) fired after the k-th iteration since
the last check, step halving on oscillation (``t <= k * rho``, inclusive)
or on no improvement since the last check, a restart from the best point
on halving, and the CE / DLR / targeted-DLR losses. JAX's lax.scan over a
vectorised carry becomes a Python loop over batched tensors.

EOT (the Rand protocol): gradients are always EOT-averaged; ``eot_loss``
'last' keeps the last repetition's losses and logits for the best-point and
halving decisions (upstream's bookkeeping), 'mean' the EOT mean.

Randomness: keys become integer seeds (utils/prng.py). A run with seed s
draws its initial perturbation from fold_in(s, 0) and iteration i's EOT
repetitions from fold_in(fold_in(s, 1), i) (the initial gradient from
fold_in(fold_in(s, 1), 2**31 - 1)), the layout of JAX's split/fold_in.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from diffpure_tpu_torch.attacks.eot import eot_average, eot_seeds
from diffpure_tpu_torch.attacks.losses import ce_loss, dlr_loss, \
    dlr_loss_targeted
from diffpure_tpu_torch.utils.prng import fold_in, generator

Tensor = torch.Tensor
ModelFn = Callable[[Tensor, int], Tensor]  # (x01, seed) -> logits


@dataclasses.dataclass(frozen=True)
class APGDConfig:
    norm: str = "Linf"  # 'Linf' | 'L2'
    eps: float = 8 / 255
    n_iter: int = 100
    n_restarts: int = 1
    eot_iter: int = 1
    rho: float = 0.75
    eot_parallel: bool = False  # all EOT repetitions in one batched call
    loss: str = "ce"  # 'ce' | 'dlr' | 'dlr-targeted'
    eot_loss: str = "last"  # 'last' (upstream-exact) | 'mean' (extension)
    n_target_classes: int = 9  # for apgd-t
    seed: int = 0
    # Kept so that configs carry over from the JAX package, where it bounds
    # how many iterations one device dispatch runs. Eager PyTorch dispatches
    # every operation on its own, so it changes nothing here.
    iters_per_dispatch: int = 0


def _checkpoints(n_iter: int):
    """AutoAttack's decreasing checkpoint schedule: is_ckpt marks the
    iterations after which a check fires, window the interval it closes
    (JAX :58)."""
    n_iter_2 = max(int(0.22 * n_iter), 1)
    n_iter_min = max(int(0.06 * n_iter), 1)
    size_decr = max(int(0.03 * n_iter), 1)
    ckpts = [n_iter_2]
    interval = n_iter_2
    while ckpts[-1] < n_iter:
        interval = max(interval - size_decr, n_iter_min)
        ckpts.append(ckpts[-1] + interval)
    is_ckpt = np.zeros(n_iter, dtype=bool)
    window = np.zeros(n_iter, dtype=np.int32)
    prev = 0
    for c in ckpts:
        if c - 1 < n_iter:
            is_ckpt[c - 1] = True
            window[c - 1] = c - prev
            prev = c
    return is_ckpt, window


def _bcast(mask: Tensor) -> Tensor:
    return mask[:, None, None, None]


def _project(x0: Tensor, z: Tensor, eps: float, norm: str) -> Tensor:
    """Project z onto the eps-ball around x0 intersected with [0, 1]."""
    if norm == "Linf":
        z = torch.minimum(torch.maximum(z, x0 - eps), x0 + eps)
    else:  # L2
        d = z - x0
        nrm = d.reshape(d.shape[0], -1).square().sum(-1).sqrt().reshape(-1, 1, 1, 1)
        z = x0 + d * torch.clamp(eps / torch.clamp(nrm, min=1e-12), max=1.0)
    return torch.clamp(z, 0.0, 1.0)


def _loss_and_grad(model_fn: ModelFn, loss_fn, x: Tensor, seed: int,
                   eot_iter: int, eot_parallel: bool = False,
                   eot_loss: str = "last"):
    """(losses, grad, logits) with the gradient EOT-averaged (JAX :98-142).
    'last': losses and logits of the last repetition; 'mean': their mean."""
    if eot_loss not in ("last", "mean"):
        raise ValueError(eot_loss)
    B = x.shape[0]

    def single(s: int, reps: Optional[int] = None):
        r = reps or 1
        with torch.enable_grad():
            xx = x.detach().repeat(r, 1, 1, 1).requires_grad_(True)
            logits = model_fn(xx, s)
            losses = torch.cat([loss_fn(lg) for lg in logits.split(B)])
            (g,) = torch.autograd.grad(losses.sum(), xx)
        out = (losses.detach(), g, logits.detach())
        if reps is None:
            return out
        return tuple(v.reshape((r, B) + v.shape[1:]) for v in out)

    if eot_iter == 1 or eot_loss == "mean":
        return eot_average(single, seed, eot_iter, parallel=eot_parallel)
    if eot_parallel:
        losses, grads, logits = single(seed, reps=eot_iter)
        return losses[-1], grads.mean(dim=0), logits[-1]
    g_acc = None
    for s in eot_seeds(seed, eot_iter):
        losses, g, logits = single(s)
        g_acc = g if g_acc is None else g_acc + g
    return losses, g_acc / eot_iter, logits


def _init_perturbation(seed: int, x: Tensor, cfg: APGDConfig) -> Tensor:
    gen = generator(seed, device=x.device)
    B = x.shape[0]
    if cfg.norm == "Linf":
        t = 2 * torch.rand(x.shape, generator=gen, device=x.device) - 1
        tmax = t.reshape(B, -1).abs().max(-1).values.reshape(-1, 1, 1, 1)
        x_adv = x + cfg.eps * t / torch.clamp(tmax, min=1e-12)
    else:
        t = torch.randn(x.shape, generator=gen, device=x.device)
        tn = t.reshape(B, -1).square().sum(-1).sqrt().reshape(-1, 1, 1, 1)
        x_adv = x + cfg.eps * t / torch.clamp(tn, min=1e-12)
    return torch.clamp(x_adv, 0.0, 1.0)


def _apgd_single_run(model_fn: ModelFn, loss_fn, x: Tensor, y: Tensor,
                     seed: int, cfg: APGDConfig,
                     collect_trajectory: bool = False,
                     x_init: Optional[Tensor] = None):
    """One APGD run: (x_out, found, loss_best[, trajectory]). ``x_init``
    replaces the seeded initial point (parity tests inject JAX's)."""
    B = x.shape[0]
    k_loop = fold_in(seed, 1)
    x_adv = _init_perturbation(fold_in(seed, 0), x, cfg) if x_init is None \
        else x_init.to(x)
    losses, grad, logits = _loss_and_grad(
        model_fn, loss_fn, x_adv, fold_in(k_loop, 2 ** 31 - 1), cfg.eot_iter,
        cfg.eot_parallel, cfg.eot_loss)
    found = logits.argmax(-1) != y
    # AA uses 2*eps as the first step for both norms (L2's grad is normalised)
    step = torch.full((B, 1, 1, 1), 2.0 * cfg.eps, device=x.device)
    x_adv_old, x_best, x_best_adv = x_adv, x_adv, x_adv
    loss_best, grad_best = losses, grad
    n_improve = torch.zeros(B, dtype=torch.int32, device=x.device)
    # upstream's loss history starts zeroed: the first window's oldest
    # comparison is loss[0] > 0
    loss_prev = torch.zeros_like(losses)
    loss_best_last_check = losses
    reduced_last_check = torch.ones(B, dtype=torch.bool, device=x.device)
    is_ckpt, window = _checkpoints(cfg.n_iter)
    traj = dict(losses=[], loss_best=[], step_size=[])

    for i in range(cfg.n_iter):
        a = 0.75 if i > 0 else 1.0
        if cfg.norm == "Linf":
            z = x_adv + step * torch.sign(grad)
        else:
            gn = grad.reshape(B, -1).square().sum(-1).sqrt().reshape(-1, 1, 1, 1)
            z = x_adv + step * grad / torch.clamp(gn, min=1e-12)
        x1 = _project(x, z, cfg.eps, cfg.norm)
        x1 = _project(x, x_adv + (x1 - x_adv) * a + (x_adv - x_adv_old) * (1 - a),
                      cfg.eps, cfg.norm)

        losses, new_grad, logits = _loss_and_grad(
            model_fn, loss_fn, x1, fold_in(k_loop, i), cfg.eot_iter,
            cfg.eot_parallel, cfg.eot_loss)
        pred_wrong = logits.argmax(-1) != y
        found = found | pred_wrong
        x_best_adv = torch.where(_bcast(pred_wrong), x1, x_best_adv)
        improved = losses > loss_best
        x_best = torch.where(_bcast(improved), x1, x_best)
        grad_best = torch.where(_bcast(improved), new_grad, grad_best)
        loss_best = torch.maximum(losses, loss_best)
        n_improve = n_improve + (losses > loss_prev).int()
        x_adv_old, x_adv, grad, loss_prev = x_adv, x1, new_grad, losses

        if is_ckpt[i]:
            osc = n_improve.float() <= cfg.rho * float(window[i])
            halve = osc | (~reduced_last_check & (loss_best_last_check >= loss_best))
            step = torch.where(_bcast(halve), step / 2.0, step)
            x_adv = torch.where(_bcast(halve), x_best, x_adv)
            grad = torch.where(_bcast(halve), grad_best, grad)
            n_improve = torch.zeros_like(n_improve)
            loss_best_last_check = loss_best
            reduced_last_check = halve
        if collect_trajectory:
            traj["losses"].append(losses)
            traj["loss_best"].append(loss_best)
            traj["step_size"].append(step[:, 0, 0, 0])

    # flipped examples return their adversarial point, the rest the
    # best-loss point
    x_out = torch.where(_bcast(found), x_best_adv, x_best)
    out = (x_out, found, loss_best)
    if collect_trajectory:
        out = out + ({k: torch.stack(v) for k, v in traj.items()},)
    return out


def apgd_attack(model_fn: ModelFn, x: Tensor, y: Tensor, seed: int,
                cfg: APGDConfig) -> Tuple[Tensor, Tensor]:
    """Run APGD; returns (x_adv, found_mask).

    For loss='dlr-targeted' the n_target_classes most probable wrong
    classes are attacked in turn (APGD-T). Restarts keep the first
    successful example; run r uses seed fold_in(seed, r).
    """
    if cfg.loss not in ("ce", "dlr", "dlr-targeted"):
        raise ValueError(cfg.loss)
    if cfg.loss == "dlr-targeted":
        with torch.no_grad():
            order = torch.argsort(model_fn(x, fold_in(seed, 991)), dim=-1)
    runs = cfg.n_target_classes if cfg.loss == "dlr-targeted" else cfg.n_restarts
    x_adv_final, found_final = x, torch.zeros(x.shape[0], dtype=torch.bool,
                                              device=x.device)
    for run in range(runs):
        if cfg.loss == "ce":
            loss_fn = lambda logits: ce_loss(logits, y)  # noqa: E731
        elif cfg.loss == "dlr":
            loss_fn = lambda logits: dlr_loss(logits, y)  # noqa: E731
        else:
            # target = the (run + 2)-th most probable class
            y_t = order[:, -(run + 2)]
            loss_fn = lambda logits, y_t=y_t: dlr_loss_targeted(logits, y, y_t)  # noqa: E731
        x_adv, found, _ = _apgd_single_run(model_fn, loss_fn, x, y,
                                           fold_in(seed, run), cfg)
        if run == 0:  # unfound slots carry the best-loss point of run 0
            x_adv_final, found_final = x_adv, found
        else:
            take = found & ~found_final
            x_adv_final = torch.where(_bcast(take), x_adv, x_adv_final)
            found_final = found_final | found
    return x_adv_final, found_final
