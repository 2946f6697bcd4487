"""ReColorAdv: color-space perturbations (port of
diffpure_tpu/attacks/recoloradv.py; ref stadv_eot/recoloradv/
{color_spaces.py, color_transformers.py, perturbations.py:129, norms.py:51}).

Every pixel is re-colored by a smooth function of its own color: an affine
color map, or a 3D lattice of colors (LUT) looked up trilinearly, under a
smoothness norm and an Linf bound per lattice color, optionally in YPbPr.
Images are NHWC in [0, 1].

The LUT lookup is eight gathers weighted by the fractional position, as
JAX writes it; autograd of the gathers is their adjoint, a scatter-add
into the LUT. The lattice is float32 ``jnp.linspace(0, 1, R)`` as XLA
computes it (``diffusion.schedules.linspace_f32``, the samplers' time
grid).
"""
from __future__ import annotations

import dataclasses

import torch

from diffpure_tpu_torch.attacks.perturbations import Perturbation, batchwise_norm, clip
from diffpure_tpu_torch.diffusion.schedules import linspace_f32

Tensor = torch.Tensor


class RGBColorSpace:
    """The identity (ref color_spaces.py RGBColorSpace)."""

    def from_rgb(self, x: Tensor) -> Tensor:
        return x

    def to_rgb(self, x: Tensor) -> Tensor:
        return clip(x, 0.0, 1.0)


class YPbPrColorSpace:
    """ITU-R BT.601 YPbPr, shifted to [0, 1]^3 (ref color_spaces.py
    YPbPrColorSpace)."""

    KR, KG, KB = 0.299, 0.587, 0.114

    def from_rgb(self, x: Tensor) -> Tensor:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = self.KR * r + self.KG * g + self.KB * b
        pb = (b - y) / (2 * (1 - self.KB))
        pr = (r - y) / (2 * (1 - self.KR))
        return torch.stack([y, pb + 0.5, pr + 0.5], dim=-1)

    def to_rgb(self, x: Tensor) -> Tensor:
        y, pb, pr = x[..., 0], x[..., 1] - 0.5, x[..., 2] - 0.5
        b = pb * 2 * (1 - self.KB) + y
        r = pr * 2 * (1 - self.KR) + y
        g = (y - self.KR * r - self.KB * b) / self.KG
        return clip(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class AffineColorTransform:
    """c' = A c + b per example, params (N, 3, 4) (ref color_transformers.py
    AffineTransform)."""

    def identity_params(self, x: Tensor) -> Tensor:
        theta = torch.zeros(x.shape[0], 3, 4, device=x.device)
        theta[:, :, :3] = torch.eye(3, device=x.device)
        return theta

    def apply(self, theta: Tensor, x: Tensor) -> Tensor:
        return torch.einsum("nij,nhwj->nhwi", theta[:, :, :3], x) \
            + theta[:, None, None, :, 3]

    def smoothness_norm(self, theta: Tensor) -> Tensor:
        return batchwise_norm(theta - self.identity_params(theta), 2)


@dataclasses.dataclass(frozen=True)
class FullSpatialColorTransform:
    """The 3D color lattice (LUT) with trilinear lookup (ref
    color_transformers.py FullSpatial). Params (N, R, R, R, 3): the output
    color at each lattice point; the identity is the lattice itself."""
    resolution: int = 8

    def identity_params(self, x: Tensor) -> Tensor:
        R = self.resolution
        g = torch.from_numpy(linspace_f32(0.0, 1.0, R)).to(x.device)
        lattice = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1)
        return lattice[None].expand(x.shape[0], R, R, R, 3)

    def apply(self, lut: Tensor, x: Tensor) -> Tensor:
        """The trilinear lookup of each pixel's color; ``lo`` is clipped to
        R - 2, so a color of 1 takes the last cell at fraction 1."""
        R = self.resolution
        pos = clip(x, 0.0, 1.0) * (R - 1)
        lo = torch.clamp(torch.floor(pos).detach(), 0, R - 2)
        frac = pos - lo
        lo = lo.long()
        batch = torch.arange(x.shape[0], device=x.device).view(-1, 1, 1)
        out = 0.0
        for dr in (0, 1):
            wr = frac[..., 0:1] if dr else 1 - frac[..., 0:1]
            for dg in (0, 1):
                wg = frac[..., 1:2] if dg else 1 - frac[..., 1:2]
                for db in (0, 1):
                    wb = frac[..., 2:3] if db else 1 - frac[..., 2:3]
                    corner = lut[batch, lo[..., 0] + dr, lo[..., 1] + dg, lo[..., 2] + db]
                    out = out + corner * (wr * wg * wb)
        return out

    def smoothness_norm(self, lut: Tensor) -> Tensor:
        """TV over lattice neighbours (ref norms.py smoothness)."""
        d = lut - self.identity_params(lut)
        total = torch.zeros(lut.shape[0], device=lut.device)
        for axis in (1, 2, 3):
            diff = torch.diff(d, dim=axis)
            total = total + torch.sqrt((diff.reshape(diff.shape[0], -1) ** 2).sum(-1) + 1e-10)
        return total


@dataclasses.dataclass(frozen=True)
class ReColorAdv(Perturbation):
    """Color perturbation in a color space with an Linf bound on each
    lattice color's displacement (ref perturbations.py:129-220)."""
    xform: object = dataclasses.field(default_factory=FullSpatialColorTransform)
    color_space: object = dataclasses.field(default_factory=RGBColorSpace)
    lp_bound: float = 0.06

    def init_params(self, x):
        return self.xform.identity_params(self.color_space.from_rgb(x))

    def apply(self, params, x):
        return self.color_space.to_rgb(self.xform.apply(params, self.color_space.from_rgb(x)))

    def project(self, params, x):
        ident = self.xform.identity_params(self.color_space.from_rgb(x))
        return clip(params, ident - self.lp_bound, ident + self.lp_bound)

    def norm(self, params, x, lp=2):
        return self.xform.smoothness_norm(params)
