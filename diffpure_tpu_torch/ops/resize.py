"""Bilinear resize of NHWC images (jax.image.resize(..., "bilinear")'s
upsampling)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def bilinear_resize(x: Tensor, size: int) -> Tensor:
    """NHWC images to size x size, as jax.image.resize(..., 'bilinear')
    upsamples (half-pixel centres; its antialiasing acts only when
    downsampling)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                         align_corners=False, antialias=False).permute(0, 2, 3, 1).contiguous()
