"""Bilinear grid sampling with torch ``F.grid_sample`` semantics over NHWC
images (port of diffpure_tpu/ops/grid_sample.py; used by the StAdv
flow-field attack, ref recoloradv/mister_ed/spatial_transformers.py:289-291).

Semantics: align_corners=False, zeros padding, input (N, H, W, C), grid
(N, Hg, Wg, 2) in normalised [-1, 1] coordinates, grid[..., 0] = x (width)
and grid[..., 1] = y (height).

Written as JAX writes it, four gathers and a lerp, not as a call of
``F.grid_sample``. At the identity grid every sample point falls exactly
on a pixel, so ``floor`` of the unnormalised coordinate decides which
neighbour the gradient with respect to the grid reads; ``F.grid_sample``'s
CPU kernel unnormalises as ``g * (W / 2) + (W / 2 - 0.5)``, which can land
an ulp below the pixel where JAX's ``((g + 1) W - 1) / 2`` lands on it, and
so reads the other neighbour at the attack's first step. Autograd of the
four gathers is JAX's autodiff of them: floor, clip and the validity mask
carry no gradient, the weights carry it to the grid, the gathers' adjoint
(a scatter-add) to the image.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def identity_grid(N: int, H: int, W: int, device=None) -> Tensor:
    """The identity sampling grid (what ``F.affine_grid(align_corners=False)``
    gives), with JAX's float32 formula (2 j + 1) / W - 1."""
    xs = (2.0 * torch.arange(W, dtype=torch.float32, device=device) + 1.0) / W - 1.0
    ys = (2.0 * torch.arange(H, dtype=torch.float32, device=device) + 1.0) / H - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    grid = torch.stack([gx, gy], dim=-1)  # (H, W, 2)
    return grid[None].expand(N, H, W, 2)


def grid_sample(x: Tensor, grid: Tensor) -> Tensor:
    """Bilinear sample of x (N, H, W, C) at grid (N, Hg, Wg, 2); zeros
    outside the image."""
    N, H, W, C = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    # unnormalise (align_corners=False)
    ix = ((gx + 1.0) * W - 1.0) / 2.0
    iy = ((gy + 1.0) * H - 1.0) / 2.0

    ix0 = torch.floor(ix).detach()
    iy0 = torch.floor(iy).detach()
    ix1 = ix0 + 1
    iy1 = iy0 + 1
    wx1 = ix - ix0
    wy1 = iy - iy0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    batch = torch.arange(N, device=x.device).view(N, 1, 1).expand(gx.shape)

    def gather(iy_: Tensor, ix_: Tensor) -> Tensor:
        valid = (ix_ >= 0) & (ix_ <= W - 1) & (iy_ >= 0) & (iy_ <= H - 1)
        ixc = ix_.clamp(0, W - 1).long()
        iyc = iy_.clamp(0, H - 1).long()
        return x[batch, iyc, ixc] * valid[..., None].to(x.dtype)

    return (gather(iy0, ix0) * (wy0 * wx0)[..., None]
            + gather(iy0, ix1) * (wy0 * wx1)[..., None]
            + gather(iy1, ix0) * (wy1 * wx0)[..., None]
            + gather(iy1, ix1) * (wy1 * wx1)[..., None])
