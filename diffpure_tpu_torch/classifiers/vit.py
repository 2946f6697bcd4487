"""Vision Transformer (DeiT-S) over NHWC images, with timm's state-dict keys
(port of diffpure_tpu/classifiers/vit.py:19-103).

The reference evaluates ImageNet with deit_small_patch16_224 from timm
(ref utils.py:171-174). Keys are timm's: ``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1, attn.qkv, attn.proj,
norm2, mlp.fc1, mlp.fc2}``, ``norm``, ``head``, so its checkpoints load
strictly. The ImageNet purifier hands the classifier its 256-px output
(ref eval_sde_adv.py:75-89 never resizes back), so, as in JAX, an input
grid other than the trained one resamples the position embeddings'
grid bicubically, by ``jax.image.resize``'s Keys cubic (``cubic_resize``).
``input_norm`` = (mean, std) normalises [0, 1] input first: the
registry's ImageNet shim (ref utils.py:144-155).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.classifiers.common import normalize
from diffpure_tpu_torch.ops.conv import conv2d_nhwc

Tensor = torch.Tensor


def _keys_cubic(x: Tensor) -> Tensor:
    """The Keys cubic kernel with a = -0.5 (jax.image's)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(n_in: int, n_out: int, device=None) -> Tensor:
    """(n_in, n_out) float32 weights of jax.image.resize(..., 'bicubic',
    antialias=True) along one axis (jax/_src/image/scale.py
    compute_weight_mat): half-pixel centres, the kernel widened when
    downsampling, each column normalised to sum 1."""
    inv_scale = torch.tensor(n_in / n_out if n_out else 1.0, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
         ).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def cubic_resize(grid: Tensor, size: int) -> Tensor:
    """(B, g, g, C) -> (B, size, size, C), as jax.image.resize's 'bicubic'."""
    wh = cubic_weights(grid.shape[1], size, grid.device).to(grid.dtype)
    ww = cubic_weights(grid.shape[2], size, grid.device).to(grid.dtype)
    return torch.einsum("bhwc,hi,wj->bijc", grid, wh, ww)


class Attention(nn.Module):
    """timm's attention: one qkv Linear, per-head softmax, proj."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: Tensor) -> Tensor:
        B, T, C = x.shape
        hd = C // self.num_heads
        q, k, v = self.qkv(x).reshape(B, T, 3, self.num_heads, hd).unbind(2)
        w = torch.einsum("bthd,bshd->bhts", q * hd ** -0.5, k).softmax(dim=-1)
        return self.proj(torch.einsum("bhts,bshd->bthd", w, v).reshape(B, T, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)

    def forward(self, x: Tensor) -> Tensor:
        """(B, H, W, 3) -> (B, H W / patch^2, dim)."""
        y = conv2d_nhwc(x, self.proj.weight, self.proj.bias, stride=self.patch_size,
                        padding=0)
        return y.reshape(y.shape[0], -1, y.shape[-1])


class ViT(nn.Module):
    """DeiT / ViT with a cls token and learned position embeddings:
    [0, 1] (with ``input_norm``) or normalised NHWC images -> logits."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 num_classes: int = 1000,
                 input_norm: Optional[Tuple[tuple, tuple]] = None):
        super().__init__()
        self.input_norm = input_norm
        self.grid = image_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid ** 2 + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.head = nn.Linear(embed_dim, num_classes)

    def forward(self, x: Tensor) -> Tensor:
        if self.input_norm is not None:
            x = normalize(x, *self.input_norm)
        grid_in = x.shape[1] // self.patch_embed.patch_size
        x = self.patch_embed(x)
        pos = self.pos_embed
        if grid_in != self.grid:
            D = pos.shape[-1]
            grid_pos = cubic_resize(pos[:, 1:].reshape(1, self.grid, self.grid, D), grid_in)
            pos = torch.cat([pos[:, :1], grid_pos.reshape(1, grid_in ** 2, D)], dim=1)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + pos
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.norm(x)[:, 0])


def deit_small_config() -> dict:
    """deit_small_patch16_224 (ref utils.py:171-174; JAX vit.py:100)."""
    return dict(image_size=224, patch_size=16, embed_dim=384, depth=12, num_heads=6,
                mlp_ratio=4.0, num_classes=1000)
