"""Parameterized perturbations: mister_ed's surface (port of
diffpure_tpu/attacks/perturbations.py; ref stadv_eot/recoloradv/mister_ed/
adversarial_perturbations.py:42-720).

A ``Perturbation`` bundles init / apply / project / norm / random init /
merge over its parameters, a tensor or a tuple of them (one per layer of a
``SequentialPerturbation``), instead of mister_ed's stateful module.
``ThreatModel`` is the factory (ref :390-430). Randomness takes an integer
seed, as the port's attacks do: a draw comes from
``utils.prng.generator(seed)`` on x's device, and a sequence's layer i
draws with ``fold_in(seed, i)``.

Clipping is written as ``jnp.clip`` is, a maximum then a minimum, so that
the gradient at a bound is split in half as in JAX (the objective of
``perturbation_pgd`` differentiates through ``project``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from diffpure_tpu_torch.utils.prng import fold_in, generator

Tensor = torch.Tensor


def clip(x: Tensor, lo, hi) -> Tensor:
    """jnp.clip: maximum with ``lo``, then minimum with ``hi`` (numbers or
    tensors that broadcast against x)."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def batchwise_norm(v: Tensor, lp) -> Tensor:
    """Per-example lp norm, ``lp`` 'inf' or a number (ref
    mister_ed/utils/pytorch_utils.py)."""
    vf = v.reshape(v.shape[0], -1)
    if lp == "inf":
        return vf.abs().amax(dim=-1)
    return (vf.abs() ** lp).sum(dim=-1) ** (1.0 / lp)


def _per_example(v: Tensor, ndim: int) -> Tensor:
    return v.reshape((-1,) + (1,) * (ndim - 1))


def lp_ball(d: Tensor, lp, bound: float) -> Tensor:
    """d scaled into the per-example lp ball of radius ``bound``."""
    n = _per_example(batchwise_norm(d, lp), d.ndim)
    return d * torch.minimum(torch.ones_like(n), bound / torch.clamp(n, min=1e-12))


def tree_map(fn, *trees):
    """fn over the leaves of tensors or (nested) tuples of them."""
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in leaves(t)]
    return [tree]


def unflatten(tree, flat):
    """A tree of ``tree``'s structure with the tensors of ``flat`` in order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


class Perturbation:
    """Base interface (ref adversarial_perturbations.py:42-230)."""

    def init_params(self, x: Tensor):
        raise NotImplementedError

    def apply(self, params, x: Tensor) -> Tensor:
        raise NotImplementedError

    def project(self, params, x: Tensor):
        """Constrain params to the threat model (constrain_params +
        make_valid_image)."""
        return params

    def norm(self, params, x: Tensor, lp=2) -> Tensor:
        raise NotImplementedError

    def random_init(self, seed: int, params, x: Tensor):
        return params

    def merge(self, params_a, params_b, mask: Tensor):
        """Per-example select: a where mask, else b (ref merge_perturbation)."""
        return tree_map(lambda a, b: torch.where(_per_example(mask.bool(), a.ndim), a, b),
                        params_a, params_b)


@dataclasses.dataclass(frozen=True)
class ThreatModel:
    """Factory binding a perturbation class to its kwargs (ref :390-430)."""
    perturbation_class: type
    kwargs: Tuple[Tuple[str, Any], ...] = ()

    @staticmethod
    def create(cls, **kwargs) -> "ThreatModel":
        return ThreatModel(cls, tuple(sorted(kwargs.items())))

    def __call__(self) -> Perturbation:
        return self.perturbation_class(**dict(self.kwargs))


@dataclasses.dataclass(frozen=True)
class DeltaAddition(Perturbation):
    """Additive perturbation x + delta in an lp ball (ref :431-538)."""
    lp_style: Any = "inf"  # 'inf' or a number
    lp_bound: float = 8 / 255

    def init_params(self, x):
        return torch.zeros_like(x)

    def apply(self, delta, x):
        return clip(x + delta, 0.0, 1.0)

    def project(self, delta, x):
        if self.lp_style == "inf":
            delta = clip(delta, -self.lp_bound, self.lp_bound)
        else:
            delta = lp_ball(delta, self.lp_style, self.lp_bound)
        # keep x + delta a valid image (make_valid_image, ref :505-517)
        return clip(x + delta, 0.0, 1.0) - x

    def norm(self, delta, x, lp=2):
        return batchwise_norm(delta, lp)

    def random_init(self, seed, delta, x):
        g = generator(seed, device=x.device)
        if self.lp_style == "inf":
            u = torch.rand(x.shape, generator=g, device=x.device, dtype=x.dtype)
            d = -self.lp_bound + 2 * self.lp_bound * u
        else:
            d = torch.randn(x.shape, generator=g, device=x.device, dtype=x.dtype)
            n = _per_example(batchwise_norm(d, self.lp_style), d.ndim)
            d = d * self.lp_bound / torch.clamp(n, min=1e-12)
        return self.project(d, x)


@dataclasses.dataclass(frozen=True)
class ParameterizedXformAdv(Perturbation):
    """Perturbation by a parameterized spatial or color transformation
    (ref :541-636); ``xform`` gives identity_params / apply / norm /
    project (attacks/spatial.py)."""
    xform: Any = None
    lp_style: Any = "inf"
    lp_bound: float = 0.05
    use_stadv: bool = False

    def init_params(self, x):
        return self.xform.identity_params(x)

    def apply(self, params, x):
        return self.xform.apply(params, x)

    def project(self, params, x):
        return self.xform.project(params, x, self.lp_style, self.lp_bound)

    def norm(self, params, x, lp=2):
        if self.use_stadv:
            return self.xform.stadv_norm(params, x)
        return self.xform.norm(params, x, lp)

    def random_init(self, seed, params, x):
        ident = self.xform.identity_params(x)
        u = torch.rand(ident.shape, generator=generator(seed, device=x.device),
                       device=x.device, dtype=ident.dtype)
        return self.project(ident - self.lp_bound + 2 * self.lp_bound * u, x)


@dataclasses.dataclass(frozen=True)
class SequentialPerturbation(Perturbation):
    """Composition of perturbation layers (ref :641-720): each layer acts on
    the previous layers' output; params are a tuple, one per layer."""
    layers: Tuple[Perturbation, ...] = ()

    def _walk(self, fn, params, x):
        out, cur = [], x
        for i, (layer, p) in enumerate(zip(self.layers, params)):
            p = fn(i, layer, p, cur)
            out.append(p)
            cur = layer.apply(p, cur)
        return tuple(out)

    def init_params(self, x):
        return self._walk(lambda i, layer, p, cur: layer.init_params(cur),
                          (None,) * len(self.layers), x)

    def apply(self, params, x):
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x

    def project(self, params, x):
        return self._walk(lambda i, layer, p, cur: layer.project(p, cur), params, x)

    def norm(self, params, x, lp=2):
        total, cur = None, x
        for layer, p in zip(self.layers, params):
            n = layer.norm(p, cur, lp)
            total = n if total is None else total + n
            cur = layer.apply(p, cur)
        return total

    def random_init(self, seed, params, x):
        return self._walk(lambda i, layer, p, cur: layer.random_init(fold_in(seed, i), p, cur),
                          params, x)
