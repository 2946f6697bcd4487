"""Score-matching losses, the optimizer and the train-step factory (port of
diffpure_tpu/training/losses.py; ref score_sde/losses.py:26-210).

``get_optimizer`` is optax's chain ``clip_by_global_norm`` -> ``adam`` /
``adamw`` with a linear warmup, written out so that its numbers are
optax's, not ``torch.optim``'s:
- the learning rate of update k is the schedule at the count *before*
  the increment, so the first update of a warmup has a learning rate of 0;
- clipping scales by max_norm / norm when the norm is not below max_norm,
  and leaves the gradient alone otherwise (no 1e-6 in the denominator);
- AdamW adds wd * p to the Adam direction of every parameter, biases
  included, before the learning rate scales it.
Its state is a dict (count, mu, nu); ``update`` works in place on it.

The step's state is a dict of params (the module itself), opt_state, ema
and step, as in JAX. Every draw of a loss (t or the labels, and z) comes
from an explicit ``torch.Generator``; a caller can inject the draws instead
(``draws``), which is how the tests hand JAX's draws to the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from diffpure_tpu_torch.diffusion.score import get_score_fn
from diffpure_tpu_torch.diffusion.sde import VESDE, VPSDE, batch_mul

Tensor = torch.Tensor
Schedule = Union[float, Callable[[int], float]]

_F32 = np.float32


def linear_schedule(init_value: float, end_value: float, transition_steps: int
                    ) -> Callable[[int], float]:
    """optax.linear_schedule, in float32 as JAX evaluates it."""
    def schedule(count: int) -> float:
        c = _F32(min(max(count, 0), transition_steps))
        frac = _F32(1.0) - c / _F32(transition_steps)
        return float(_F32(init_value - end_value) * frac + _F32(end_value))
    return schedule


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), from
    the per-tensor norms."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.sqrt(torch.sum(torch.stack(norms) ** 2))


def clip_by_global_norm(grads: Sequence[Tensor], max_norm: float) -> list:
    """optax.clip_by_global_norm: the gradients unchanged when their global
    norm is below ``max_norm``, else each t / norm * max_norm. The branch is
    taken on the device, without waiting for it: below the limit each t is
    divided and multiplied by exactly 1."""
    grads = list(grads)
    norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    out = torch._foreach_div(grads, torch.where(keep, one, norm).to(grads[0].dtype))
    torch._foreach_mul_(out, torch.where(keep, one, one * max_norm).to(grads[0].dtype))
    return out


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.chain([clip_by_global_norm(grad_clip)], adam or adamw(lr)).

    ``lr`` is a float or a schedule of the update count; ``grad_clip < 0``
    leaves out the clip, ``weight_decay > 0`` makes it AdamW."""

    lr: Schedule = 2e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = -1.0

    def learning_rate(self, count: int) -> float:
        return float(_F32(self.lr(count) if callable(self.lr) else self.lr))

    def init(self, params: Sequence[Tensor]) -> dict:
        return dict(count=0, mu=[torch.zeros_like(p) for p in params],
                    nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: Sequence[Tensor], state: dict,
               params: Optional[Sequence[Tensor]] = None):
        """(updates, state): the updates to add to ``params``; ``state``'s
        moments are updated in place."""
        grads = [g.detach() for g in grads]
        if self.grad_clip >= 0:
            grads = clip_by_global_norm(grads, self.grad_clip)
        mu, nu, count = state["mu"], state["nu"], state["count"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        # bias corrections in float32 from the incremented count, as optax
        bc1 = float(_F32(1.0) - _F32(self.b1) ** _F32(count + 1))
        bc2 = float(_F32(1.0) - _F32(self.b2) ** _F32(count + 1))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, bc1)
        torch._foreach_div_(updates, denom)
        if self.weight_decay > 0:
            if params is None:
                raise ValueError("AdamW needs the parameters")
            torch._foreach_add_(updates, [p.detach() for p in params],
                                alpha=self.weight_decay)
        torch._foreach_mul_(updates, -self.learning_rate(count))
        return updates, dict(state, count=count + 1)


@torch.no_grad()
def apply_updates(params: Sequence[Tensor], updates: Sequence[Tensor]) -> None:
    """p += u in place (optax.apply_updates). In-place adds bump each
    parameter's version counter, which the blocks' kernel packs track."""
    torch._foreach_add_(list(params), list(updates))


def get_optimizer(lr: float = 2e-4, beta1: float = 0.9, eps: float = 1e-8,
                  weight_decay: float = 0.0, warmup: int = 5000,
                  grad_clip: float = 1.0) -> Adam:
    """Adam with a linear warmup and global-norm clipping, the reference's
    optimizer and optimization_manager in one (ref losses.py:26-52)."""
    schedule = linear_schedule(0.0, lr, warmup) if warmup > 0 else lr
    return Adam(lr=schedule, b1=beta1, eps=eps, weight_decay=weight_decay,
                grad_clip=grad_clip)


@dataclasses.dataclass(frozen=True)
class OptimizationManager:
    """The warmup / clip transform alone (ref losses.py:38-52): clip by the
    global norm, then scale by min(count / warmup, 1)."""

    warmup: int = 5000
    grad_clip: float = 1.0

    def init(self, params=None) -> dict:
        return dict(count=0)

    @torch.no_grad()
    def update(self, grads: Sequence[Tensor], state: dict, params=None):
        grads = [g.detach() for g in grads]
        if self.grad_clip >= 0:
            grads = clip_by_global_norm(grads, self.grad_clip)
        count = state["count"]
        if self.warmup > 0:
            scale = float(min(_F32(count) / _F32(self.warmup), _F32(1.0)))
            grads = [g * scale for g in grads]
        return grads, dict(state, count=count + 1)


def optimization_manager(lr: float = 2e-4, warmup: int = 5000,
                         grad_clip: float = 1.0) -> OptimizationManager:
    """For callers composing their own optimizer; ``lr`` is unused, as in
    the reference's signature."""
    return OptimizationManager(warmup=warmup, grad_clip=grad_clip)


def _reduce(reduce_mean: bool):
    if reduce_mean:
        return lambda x: torch.mean(x.reshape(x.shape[0], -1), dim=-1)
    return lambda x: 0.5 * torch.sum(x.reshape(x.shape[0], -1), dim=-1)


def _uniform(generator, n: int, like: Tensor) -> Tensor:
    dev = generator.device if generator is not None else like.device
    return torch.rand(n, generator=generator, device=dev).to(like.device)


def _normal(generator, like: Tensor) -> Tensor:
    dev = generator.device if generator is not None else like.device
    return torch.randn(like.shape, generator=generator, device=dev).to(like.device,
                                                                          like.dtype)


def _labels(generator, n: int, high: int, like: Tensor) -> Tensor:
    dev = generator.device if generator is not None else like.device
    return torch.randint(0, high, (n,), generator=generator, device=dev).to(like.device)


def get_sde_loss_fn(sde, train: bool, reduce_mean: bool = True,
                    continuous: bool = True, likelihood_weighting: bool = False,
                    eps: float = 1e-5):
    """Continuous-time denoising score matching (ref losses.py:55-98).
    ``draws``: dict(t (B,), z like the batch)."""
    reduce_op = _reduce(reduce_mean)

    def loss_fn(generator, model_fn, batch: Tensor, draws: Optional[dict] = None) -> Tensor:
        score_fn = get_score_fn(sde, model_fn, continuous=continuous)
        if draws is None:
            t = _uniform(generator, batch.shape[0], batch) * (sde.T - eps) + eps
            z = _normal(generator, batch)
        else:
            t, z = draws["t"].to(batch.device), draws["z"].to(batch.device, batch.dtype)
        mean, std = sde.marginal_prob(batch, t)
        perturbed = mean + batch_mul(std, z)
        score = score_fn(perturbed, t)
        if not likelihood_weighting:
            losses = reduce_op((batch_mul(std, score) + z) ** 2)
        else:
            g2 = sde.sde(torch.zeros_like(batch), t)[1] ** 2
            losses = reduce_op((score + batch_mul(1.0 / std, z)) ** 2) * g2
        return torch.mean(losses)

    return loss_fn


def get_smld_loss_fn(vesde: VESDE, train: bool, reduce_mean: bool = False):
    """The legacy SMLD (NCSN) loss over the discrete sigmas (ref
    losses.py:101-125). ``draws``: dict(labels (B,) in [0, N), z)."""
    sigma_array = torch.from_numpy(vesde.discrete_sigmas[::-1].astype(np.float32))
    reduce_op = _reduce(reduce_mean)

    def loss_fn(generator, model_fn, batch: Tensor, draws: Optional[dict] = None) -> Tensor:
        if draws is None:
            labels = _labels(generator, batch.shape[0], vesde.N, batch)
            z = _normal(generator, batch)
        else:
            labels, z = draws["labels"].to(batch.device), draws["z"].to(batch.device)
        sigmas = sigma_array.to(batch.device)[labels.long()]
        noise = batch_mul(sigmas, z)
        score = model_fn(batch + noise, labels)
        target = batch_mul(-1.0 / sigmas ** 2, noise)
        losses = reduce_op((score - target) ** 2) * sigmas ** 2
        return torch.mean(losses)

    return loss_fn


def get_ddpm_loss_fn(vpsde: VPSDE, train: bool, reduce_mean: bool = True):
    """The legacy discrete DDPM epsilon loss (ref losses.py:128-148). The
    tables are float32 arithmetic on the float32 alpha-bars, as JAX's and
    the reference's are. ``draws``: dict(labels, z)."""
    ac = vpsde.alphas_cumprod.astype(np.float32)
    sqrt_a = torch.from_numpy(np.sqrt(ac))
    sqrt_1ma = torch.from_numpy(np.sqrt(np.float32(1.0) - ac))
    reduce_op = _reduce(reduce_mean)

    def loss_fn(generator, model_fn, batch: Tensor, draws: Optional[dict] = None) -> Tensor:
        if draws is None:
            labels = _labels(generator, batch.shape[0], vpsde.N, batch)
            noise = _normal(generator, batch)
        else:
            labels = draws["labels"].to(batch.device)
            noise = draws["z"].to(batch.device, batch.dtype)
        idx = labels.long()
        perturbed = (batch_mul(sqrt_a.to(batch.device)[idx], batch)
                     + batch_mul(sqrt_1ma.to(batch.device)[idx], noise))
        score = model_fn(perturbed, labels)
        return torch.mean(reduce_op((score - noise) ** 2))

    return loss_fn


def get_step_fn(sde, train: bool, optimizer: Optional[Adam] = None,
                reduce_mean: bool = True, continuous: bool = True,
                likelihood_weighting: bool = False, data_axis: Optional[str] = None):
    """The train / eval step (ref losses.py:151-210).

    ``step_fn(state, batch, generator=None, *, draws=None) -> (state,
    loss)``, state = dict(params: the module, opt_state, ema, step); the
    model is called as ``module(x, labels)``. A training step
    differentiates the loss with respect to every parameter, updates them
    in place, then the EMA.
    ``data_axis`` (JAX's pmean over a mesh axis) waits for ROADMAP item 20.
    """
    if data_axis is not None:
        raise NotImplementedError("data-parallel training (data_axis) is not ported "
                                  "yet: ROADMAP item 20")
    if continuous:
        loss_fn = get_sde_loss_fn(sde, train, reduce_mean, continuous,
                                  likelihood_weighting)
    elif isinstance(sde, VESDE):
        loss_fn = get_smld_loss_fn(sde, train, reduce_mean)
    elif isinstance(sde, VPSDE):
        loss_fn = get_ddpm_loss_fn(sde, train, reduce_mean)
    else:
        raise ValueError("discrete training only for VE/VP SDEs")

    def step_fn(state: dict, batch: Tensor, generator=None, *,
                draws: Optional[dict] = None):
        model = state["params"]
        if not train:
            with torch.no_grad():
                return state, loss_fn(generator, model, batch, draws)
        params = list(model.parameters())
        loss = loss_fn(generator, model, batch, draws)
        grads = torch.autograd.grad(loss, params)
        updates, opt_state = optimizer.update(grads, state["opt_state"], params)
        apply_updates(params, updates)
        new_state = dict(state, opt_state=opt_state, step=state["step"] + 1)
        if state.get("ema") is not None:
            state["ema"].update(model)
        return new_state, loss.detach()

    return step_fn
