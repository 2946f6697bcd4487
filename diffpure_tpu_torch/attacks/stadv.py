"""StAdv: spatially transformed adversarial examples with EOT (port of
diffpure_tpu/attacks/stadv.py; ref stadv_eot/attacks.py:123-136 and
recoloradv/mister_ed).

The perturbation is a full sampling grid (mister_ed's FullSpatial),
optimised with Adam (lr 0.01) on

    minimize  CW-f6(logits, y; kappa) + (0.0025 / bound) * stAdv-TV(flow)

with EOT-averaged gradients, a per-example keep-best by that objective, and
the grid clipped to [-1, 1] and to within ``bound`` (Linf) of the identity
grid at every forward. DiffPure runs 100 iterations with eot_iter 20 (ref
eval_sde_adv.py:175,195).

Adam is optax's arithmetic (``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias correction 1 - b**count in float32), written
out in optax's order so that 100 iterations of keep-best decisions follow
JAX's; ``torch.optim.Adam`` rounds in another order.

Keep-best as JAX has it (:117-129): ``per_ex`` is the objective at the
grid before the iteration's update, and ``best_grid`` takes the grid after
it. Randomness, JAX's key layout on integer seeds: iteration i's EOT
repetitions run with the seeds ``eot_average`` derives from
fold_in(seed, i), the last classification with fold_in(seed, 123456).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from diffpure_tpu_torch.attacks.eot import eot_average
from diffpure_tpu_torch.ops.grid_sample import grid_sample, identity_grid
from diffpure_tpu_torch.utils.prng import fold_in

Tensor = torch.Tensor
ModelFn = Callable[[Tensor, int], Tensor]  # (x01, seed) -> logits

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class StAdvConfig:
    bound: float = 0.05
    n_iter: int = 100
    lr: float = 0.01
    eot_iter: int = 1
    kappa: float = float("inf")
    # Kept so that configs carry over from the JAX package, where it bounds
    # how many iterations one device dispatch runs. Eager PyTorch dispatches
    # every operation on its own, so it changes nothing here.
    iters_per_dispatch: int = 0

    @property
    def flow_loss_coef(self) -> float:
        return 0.0025 / self.bound  # ref attacks.py:133


def stadv_tv_norm(delta: Tensor) -> Tensor:
    """Flow smoothness: the sum over pixels and their four neighbours of
    sqrt(|d - d_nbr|^2 + 1e-10). delta (B, H, W, 2), the grid's offset from
    the identity. A neighbour beyond the edge is the edge pixel itself (the
    reference's boundary-adjusted permutation matrices, ref
    spatial_transformers.py:147-213)."""
    d = delta
    total = torch.zeros(d.shape[0], dtype=d.dtype, device=d.device)
    for axis in (1, 2):
        n = d.shape[axis]
        first, last = d.narrow(axis, 0, 1), d.narrow(axis, n - 1, 1)
        # roll by +1 with the first slice kept, and by -1 with the last kept
        for nbr in (torch.cat([first, d.narrow(axis, 0, n - 1)], dim=axis),
                    torch.cat([d.narrow(axis, 1, n - 1), last], dim=axis)):
            diff2 = ((d - nbr) ** 2).sum(dim=-1)
            total = total + torch.sqrt(diff2 + 1e-10).sum(dim=(1, 2))
    return total


def _cw_f6(logits: Tensor, y: Tensor, kappa: float) -> Tensor:
    """clamp(z_y - max_other, min=-kappa) (ref loss_functions.py:214-244)."""
    z_y = logits.gather(-1, y[:, None].long())[:, 0]
    onehot = F.one_hot(y.long(), logits.shape[-1]).bool()
    max_other = torch.where(onehot, torch.full_like(logits, float("-inf")),
                            logits).max(dim=-1).values
    out = z_y - max_other
    if kappa != float("inf"):
        out = torch.maximum(out, torch.full_like(out, -kappa))
    return out


def _constrain(grid: Tensor, ident: Tensor, bound: float) -> Tensor:
    """Clip to [-1, 1], then Linf-project to within ``bound`` of the
    identity (ref spatial_transformers.py:231-243,260-285); written as
    jnp.clip's maximum then minimum, whose gradient at a tie is split in
    half in both packages."""
    one = torch.ones_like(grid)
    g = torch.minimum(one, torch.maximum(-one, grid))
    return torch.minimum(ident + bound, torch.maximum(ident - bound, g))


def stadv_attack(model_fn: ModelFn, x: Tensor, y: Tensor, seed: int,
                 cfg: StAdvConfig) -> Tuple[Tensor, Tensor]:
    """Returns (x_adv, found): x (B, H, W, C) in [0, 1], found True where
    the final classification misses y."""
    B, H, W, C = x.shape
    x, y = x.detach(), y.detach()
    ident = identity_grid(B, H, W, device=x.device)
    grid = ident.clone()  # FullSpatial starts at the identity
    mu = torch.zeros_like(grid)
    nu = torch.zeros_like(grid)
    b1 = torch.tensor(ADAM_B1, dtype=torch.float32, device=x.device)
    b2 = torch.tensor(ADAM_B2, dtype=torch.float32, device=x.device)
    coef = cfg.flow_loss_coef

    def single(s: int) -> Tuple[Tensor, Tensor]:
        g = grid.detach().requires_grad_(True)
        with torch.enable_grad():
            gc = _constrain(g, ident, cfg.bound)
            logits = model_fn(grid_sample(x, gc), s)
            per_ex = _cw_f6(logits, y, cfg.kappa) + coef * stadv_tv_norm(gc - ident)
            (grad,) = torch.autograd.grad(per_ex.sum(), g)
        return grad, per_ex.detach()

    best_grid = grid
    best_score = torch.full((B,), float("inf"), device=x.device)
    for i in range(cfg.n_iter):
        g, per_ex = eot_average(single, fold_in(seed, i), cfg.eot_iter)
        # optax.adam: scale_by_adam, then scale by -lr, then p + u
        mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * (g ** 2) + ADAM_B2 * nu
        count = float(i + 1)
        mu_hat = mu / (1 - b1 ** count)
        nu_hat = nu / (1 - b2 ** count)
        update = mu_hat / (torch.sqrt(nu_hat + 0.0) + ADAM_EPS)
        grid = grid + update * (-cfg.lr)

        # keep-best by the minimised objective (ref PGD keep_best)
        improved = per_ex < best_score
        best_grid = torch.where(improved[:, None, None, None], grid, best_grid)
        best_score = torch.minimum(per_ex, best_score)

    with torch.no_grad():
        x_adv = grid_sample(x, _constrain(best_grid, ident, cfg.bound))
        logits = model_fn(x_adv, fold_in(seed, 123_456))
    return x_adv, logits.argmax(-1) != y
