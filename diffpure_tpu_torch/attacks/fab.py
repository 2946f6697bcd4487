"""FAB-T: the targeted Fast Adaptive Boundary attack (Croce & Hein, 2020) of
AutoAttack's 'standard' suite (port of diffpure_tpu/attacks/fab.py).

Each iteration linearises the boundary between the true and the target
class at the iterate and takes the combined projection step toward it
(overshoot ``eta``, mixing ``alpha`` capped at ``alpha_max``), a step back
toward the original point (``beta``) on success, and keeps the smallest
adversarial found. The box-constrained hyperplane projections
min ||z - x||_p s.t. w.z = b, 0 <= z <= 1 are solved as JAX solves them: by
bisection with fixed iteration counts in float32 (30 on the Linf radius
and then 30 on the corner mix, 40 on the L2 multiplier).

Randomness: the clean logits run with fold_in(seed, 17), target t_idx's
restart r with k_r = fold_in(seed, t_idx * 131 + r) (its random start
from a generator seeded by k_r), iteration i's gradient with
k_i = fold_in(k_r, i) and the forward after the step with fold_in(k_i, 3):
JAX's key layout (:137-183). The gradient is the input gradient of
sum(f_y - f_t) through ``model_fn``: through a defence, its purifier's
gradient mode.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from diffpure_tpu_torch.utils.prng import fold_in, generator

Tensor = torch.Tensor
ModelFn = Callable[[Tensor, int], Tensor]  # (x01, seed) -> logits


@dataclasses.dataclass(frozen=True)
class FABConfig:
    norm: str = "Linf"
    eps: float = 8 / 255
    n_iter: int = 100
    n_target_classes: int = 9
    n_restarts: int = 1
    alpha_max: float = 0.1
    eta: float = 1.05
    beta: float = 0.9
    seed: int = 0
    # kept so that configs carry over from the JAX package; changes nothing
    # in eager PyTorch (see APGDConfig.iters_per_dispatch)
    iters_per_dispatch: int = 0


def _flat(v: Tensor) -> Tensor:
    return v.reshape(v.shape[0], -1)


def _bcast(v: Tensor) -> Tensor:
    return v.reshape(-1, 1, 1, 1)


def _proj_hyperplane_box_linf(x: Tensor, w: Tensor, b: Tensor, n_bisect: int = 30) -> Tensor:
    """min ||z - x||_inf s.t. w.z = b, 0 <= z <= 1 (JAX :46): bisect the
    smallest radius t whose box-clipped ball reaches b, then bisect the mix
    m of its w.z-minimising and -maximising corners, z = z_min + m (z_max -
    z_min)."""
    xf, wf = _flat(x), _flat(w)
    pos = wf >= 0

    def corners(t: Tensor):
        lo = torch.clamp(xf - t[:, None], 0.0, 1.0)
        hi = torch.clamp(xf + t[:, None], 0.0, 1.0)
        return torch.where(pos, lo, hi), torch.where(pos, hi, lo)  # (z_min, z_max)

    t_lo = torch.zeros(x.shape[0], device=x.device)
    t_hi = torch.ones(x.shape[0], device=x.device)
    for _ in range(n_bisect):
        t_mid = 0.5 * (t_lo + t_hi)
        z_min, z_max = corners(t_mid)
        ok = ((wf * z_min).sum(-1) <= b) & (b <= (wf * z_max).sum(-1))
        t_lo, t_hi = torch.where(ok, t_lo, t_mid), torch.where(ok, t_mid, t_hi)
    z_min, z_max = corners(t_hi)
    m_lo = torch.zeros(x.shape[0], device=x.device)
    m_hi = torch.ones(x.shape[0], device=x.device)
    for _ in range(n_bisect):
        m = 0.5 * (m_lo + m_hi)
        go_up = (wf * (z_min + m[:, None] * (z_max - z_min))).sum(-1) < b
        m_lo, m_hi = torch.where(go_up, m, m_lo), torch.where(go_up, m_hi, m)
    z = z_min + (0.5 * (m_lo + m_hi))[:, None] * (z_max - z_min)
    return z.reshape(x.shape)


def _proj_hyperplane_box_l2(x: Tensor, w: Tensor, b: Tensor, n_bisect: int = 40) -> Tensor:
    """min ||z - x||_2 s.t. w.z = b, 0 <= z <= 1 (JAX :101):
    z = clip(x - mu w, 0, 1), mu bisected (w.z(mu) decreases in mu)."""
    xf, wf = _flat(x), _flat(w)
    wnorm = wf.square().sum(-1).sqrt() + 1e-12
    span = 2.0 / wnorm * torch.sqrt(torch.tensor(float(xf.shape[-1]), device=x.device))
    lo, hi = -span, span
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        gt = (wf * torch.clamp(xf - mid[:, None] * wf, 0.0, 1.0)).sum(-1) > b
        lo, hi = torch.where(gt, mid, lo), torch.where(gt, hi, mid)
    return torch.clamp(xf - (0.5 * (lo + hi))[:, None] * wf, 0.0, 1.0).reshape(x.shape)


def _norms(v: Tensor, norm: str) -> Tensor:
    vf = _flat(v)
    if norm == "Linf":
        return vf.abs().max(-1).values
    return vf.square().sum(-1).sqrt()


def _margin_grad(model_fn: ModelFn, x: Tensor, y: Tensor, y_t: Tensor, seed: int):
    """(f_y - f_t per example, its input gradient)."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        lg = model_fn(xx, seed)
        diff = lg.gather(-1, y[:, None])[:, 0] - lg.gather(-1, y_t[:, None])[:, 0]
        (w,) = torch.autograd.grad(diff.sum(), xx)
    return diff.detach(), w


def fab_attack(model_fn: ModelFn, x: Tensor, y: Tensor, seed: int,
               cfg: FABConfig) -> Tuple[Tensor, Tensor]:
    """Returns (x_adv, found_mask): the smallest adversarials found, where
    within eps; x elsewhere. Targets: the 2nd to (n_target_classes + 1)-th
    most probable classes of the clean logits."""
    proj = _proj_hyperplane_box_linf if cfg.norm == "Linf" else _proj_hyperplane_box_l2
    y = y.long()
    B = x.shape[0]
    with torch.no_grad():
        order = torch.argsort(model_fn(x, fold_in(seed, 17)), dim=-1)
    best_norm = torch.full((B,), float("inf"), device=x.device)
    x_best = x
    found = torch.zeros(B, dtype=torch.bool, device=x.device)

    for t_idx in range(cfg.n_target_classes):
        y_t = order[:, -(t_idx + 2)]
        for restart in range(cfg.n_restarts):
            k_r = fold_in(seed, t_idx * 131 + restart)
            x_i = x
            if restart > 0:
                u = (torch.rand(x.shape, generator=generator(k_r, device=x.device),
                                device=x.device) - 0.5) * 2
                r = _bcast(torch.clamp(best_norm, max=cfg.eps))
                step = 0.5 * r * u
                if cfg.norm != "Linf":
                    step = step / _bcast(torch.clamp(_norms(u, "L2"), min=1e-12))
                x_i = torch.clamp(x + step, 0.0, 1.0)
            for i in range(cfg.n_iter):
                k_i = fold_in(k_r, i)
                fval, w = _margin_grad(model_fn, x_i, y, y_t, k_i)
                # the hyperplane w.z = b through the boundary's linearisation
                b_i = (_flat(w) * _flat(x_i)).sum(-1) - fval
                d1 = proj(x_i, w, b_i) - x_i
                d2 = proj(x, w, b_i) - x
                n1, n2 = _norms(d1, cfg.norm), _norms(d2, cfg.norm)
                alpha = _bcast(torch.clamp(n1 / torch.clamp(n1 + n2, min=1e-12), 0.0,
                                           cfg.alpha_max))
                x_new = torch.clamp((1 - alpha) * (x_i + cfg.eta * d1)
                                    + alpha * (x + cfg.eta * d2), 0.0, 1.0)
                with torch.no_grad():
                    is_adv = model_fn(x_new, fold_in(k_i, 3)).argmax(-1) != y
                dist = _norms(x_new - x, cfg.norm)
                improve = is_adv & (dist < best_norm)
                x_best = torch.where(_bcast(improve), x_new, x_best)
                best_norm = torch.where(improve, dist, best_norm)
                found = found | (is_adv & (dist <= cfg.eps))
                # the step back toward the original on success
                x_i = torch.where(_bcast(is_adv), torch.clamp(
                    (1 - cfg.beta) * x + cfg.beta * x_new, 0.0, 1.0), x_new)

    ok = found & (best_norm <= cfg.eps)
    return torch.where(_bcast(ok), x_best, x), ok
