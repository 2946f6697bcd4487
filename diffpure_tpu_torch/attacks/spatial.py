"""Parameterized spatial transformations for the perturbation framework
(port of diffpure_tpu/attacks/spatial.py; ref mister_ed/
spatial_transformers.py): ``FullSpatial`` (the StAdv grid, ref :107-291),
``Affine`` (ref :296+), ``Rotation`` and ``Translation`` (restricted
affine). Each gives identity_params / apply / norm / stadv_norm / project.
They sample with ``ops.grid_sample`` (JAX's four gathers and a lerp), as
StAdv does.
"""
from __future__ import annotations

import dataclasses

import torch

from diffpure_tpu_torch.attacks.perturbations import batchwise_norm, clip, lp_ball
from diffpure_tpu_torch.attacks.stadv import stadv_tv_norm
from diffpure_tpu_torch.ops.grid_sample import grid_sample, identity_grid

Tensor = torch.Tensor


def _project_around(params: Tensor, ident: Tensor, lp, lp_bound: float) -> Tensor:
    """params within ``lp_bound`` of ``ident`` (Linf: clipped; else the lp
    ball of the offset)."""
    if lp == "inf":
        return clip(params, ident - lp_bound, ident + lp_bound)
    return ident + lp_ball(params - ident, lp, lp_bound)


@dataclasses.dataclass(frozen=True)
class FullSpatial:
    """Params are the full sampling grid (N, H, W, 2) (ref :107-144)."""

    def identity_params(self, x: Tensor) -> Tensor:
        N, H, W, _ = x.shape
        return identity_grid(N, H, W, device=x.device)

    def apply(self, grid: Tensor, x: Tensor) -> Tensor:
        return grid_sample(x, grid)

    def norm(self, grid: Tensor, x: Tensor, lp=2) -> Tensor:
        return batchwise_norm(grid - self.identity_params(x), lp)

    def stadv_norm(self, grid: Tensor, x: Tensor) -> Tensor:
        return stadv_tv_norm(grid - self.identity_params(x))

    def project(self, grid: Tensor, x: Tensor, lp, lp_bound: float) -> Tensor:
        """Clip to [-1, 1], then into the lp ball around the identity
        (ref :231-285)."""
        return _project_around(clip(grid, -1.0, 1.0), self.identity_params(x), lp, lp_bound)


class _AffineBase:
    """The affine family: params -> a 2 x 3 matrix theta per example."""

    def _grid_from_theta(self, theta: Tensor, x: Tensor) -> Tensor:
        """The affine grid (align_corners=False): theta @ [gx, gy, 1]."""
        N, H, W, _ = x.shape
        base = identity_grid(N, H, W, device=x.device)
        hom = torch.cat([base, torch.ones_like(base[..., :1])], dim=-1)  # (N, H, W, 3)
        return torch.einsum("nhwk,njk->nhwj", hom, theta)

    def apply(self, params, x):
        return grid_sample(x, self._grid_from_theta(self._theta(params, x), x))

    def project(self, params, x, lp, lp_bound):
        return _project_around(params, self.identity_params(x), lp, lp_bound)

    def norm(self, params, x, lp=2):
        return batchwise_norm(params - self.identity_params(x), lp)


def _eye23(N: int, device) -> Tensor:
    theta = torch.zeros(N, 2, 3, device=device)
    theta[:, 0, 0] = 1.0
    theta[:, 1, 1] = 1.0
    return theta


@dataclasses.dataclass(frozen=True)
class Affine(_AffineBase):
    """Full 2 x 3 affine params (ref AffineTransform)."""

    def identity_params(self, x: Tensor) -> Tensor:
        return _eye23(x.shape[0], x.device)

    def _theta(self, params, x):
        return params


@dataclasses.dataclass(frozen=True)
class Rotation(_AffineBase):
    """One angle per example (ref RotationTransform)."""

    def identity_params(self, x: Tensor) -> Tensor:
        return torch.zeros(x.shape[0], device=x.device)

    def _theta(self, angle, x):
        c, s = torch.cos(angle), torch.sin(angle)
        zeros = torch.zeros_like(angle)
        return torch.stack([torch.stack([c, -s, zeros], -1),
                            torch.stack([s, c, zeros], -1)], dim=1)


@dataclasses.dataclass(frozen=True)
class Translation(_AffineBase):
    """(tx, ty) per example (ref TranslationTransform)."""

    def identity_params(self, x: Tensor) -> Tensor:
        return torch.zeros(x.shape[0], 2, device=x.device)

    def _theta(self, txy, x):
        eye = _eye23(txy.shape[0], txy.device)
        shift = torch.zeros_like(eye)
        shift[:, :, 2] = 1.0
        return eye + shift * txy[:, :, None]
