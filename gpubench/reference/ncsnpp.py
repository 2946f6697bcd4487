"""NCSN++ (score_sde's DDPM++ "biggan" variant, the VP model of DiffPure's
CIFAR-10 config), plain PyTorch in NCHW, float32.

Written from score_sde's ``models/ncsnpp.py`` and ``layerspp.py``
(Song et al., 2021) for the options that config sets: BigGAN residual
blocks with naive (nearest / mean-pool) resampling, attention at the listed
resolutions, the positional time embedding of labels t * 999, a
conditional model, ``skip_rescale``, centred input, no progressive
branches. Other options raise. Module names are score_sde's
(``all_modules.{i}.GroupNorm_0.weight``, NIN ``W`` of shape (in, out)), so
one state dict loads into this model and the program's.

Departures: dropout is left out (eval mode); the products' operands pass
through ``Precision.q`` (the identity in float32).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.layers import conv, downsample, group_norm, linear, matmul, \
    upsample
from gpubench.reference.precision import Precision

Tensor = torch.Tensor


def num_groups(channels: int) -> int:
    return min(channels // 4, 32)


def timestep_embedding(t: Tensor, dim: int, max_positions: int = 10000) -> Tensor:
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * -(math.log(max_positions) / (half - 1)))
    emb = t.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)


class NIN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.W = nn.Parameter(torch.empty(cin, cout))
        self.b = nn.Parameter(torch.empty(cout))

    def forward(self, x: Tensor, prec: Precision) -> Tensor:
        y = matmul(x.permute(0, 2, 3, 1), self.W, prec) + self.b
        return y.permute(0, 3, 1, 2)


class AttnBlockpp(nn.Module):
    def __init__(self, channels: int, skip_rescale: bool):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(num_groups(channels), channels, eps=1e-6)
        for i in range(4):
            setattr(self, f"NIN_{i}", NIN(channels, channels))
        self.skip_rescale = skip_rescale

    def forward(self, x: Tensor, prec: Precision) -> Tensor:
        B, C, H, W = x.shape
        h = group_norm(self.GroupNorm_0, x)
        q, k, v = (getattr(self, f"NIN_{i}")(h, prec) for i in range(3))
        q = q.reshape(B, C, H * W).transpose(1, 2)
        k = k.reshape(B, C, H * W)
        w = torch.softmax(matmul(q, k, prec) * (int(C) ** -0.5), dim=-1)
        h = matmul(w, v.reshape(B, C, H * W).transpose(1, 2), prec)
        h = self.NIN_3(h.transpose(1, 2).reshape(B, C, H, W), prec)
        return (x + h) / math.sqrt(2.0) if self.skip_rescale else x + h


class ResnetBlockBigGANpp(nn.Module):
    def __init__(self, cin: int, cout: Optional[int], temb_dim: int, up: bool = False,
                 down: bool = False, skip_rescale: bool = True):
        super().__init__()
        cout = cout or cin
        self.GroupNorm_0 = nn.GroupNorm(num_groups(cin), cin, eps=1e-6)
        self.Conv_0 = nn.Conv2d(cin, cout, 3, padding=1)
        self.Dense_0 = nn.Linear(temb_dim, cout)
        self.GroupNorm_1 = nn.GroupNorm(num_groups(cout), cout, eps=1e-6)
        self.Conv_1 = nn.Conv2d(cout, cout, 3, padding=1)
        self.proj = cin != cout or up or down
        if self.proj:
            self.Conv_2 = nn.Conv2d(cin, cout, 1)
        self.up, self.down, self.skip_rescale = up, down, skip_rescale

    def forward(self, x: Tensor, temb: Tensor, prec: Precision) -> Tensor:
        h = F.silu(group_norm(self.GroupNorm_0, x))
        if self.up:
            h, x = upsample(h), upsample(x)
        elif self.down:
            h, x = downsample(h), downsample(x)
        h = conv(self.Conv_0, h, prec)
        h = h + linear(self.Dense_0, F.silu(temb), prec)[:, :, None, None]
        h = F.silu(group_norm(self.GroupNorm_1, h))
        h = conv(self.Conv_1, h, prec)
        if self.proj:
            x = conv(self.Conv_2, x, prec)
        return (x + h) / math.sqrt(2.0) if self.skip_rescale else x + h


class NCSNpp(nn.Module):
    """forward(x NCHW in [-1, 1], labels (N,) = t * 999) -> epsilon NCHW."""

    def __init__(self, image_size: int = 32, num_channels: int = 3, nf: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 2, 2), num_res_blocks: int = 8,
                 attn_resolutions: Sequence[int] = (16,), resamp_with_conv: bool = True,
                 conditional: bool = True, fir: bool = False, skip_rescale: bool = True,
                 resblock_type: str = "biggan", progressive: str = "none",
                 progressive_input: str = "none", embedding_type: str = "positional",
                 scale_by_sigma: bool = False, centered: bool = True,
                 sigma_min: float = 0.01, sigma_max: float = 50.0, num_scales: int = 1000,
                 **unused):
        super().__init__()
        wanted = dict(resamp_with_conv=True, conditional=True, fir=False,
                      resblock_type="biggan", progressive="none", progressive_input="none",
                      embedding_type="positional", scale_by_sigma=False, centered=True)
        given = dict(resamp_with_conv=resamp_with_conv, conditional=conditional, fir=fir,
                     resblock_type=resblock_type, progressive=progressive,
                     progressive_input=progressive_input, embedding_type=embedding_type,
                     scale_by_sigma=scale_by_sigma, centered=centered)
        if given != wanted:
            raise NotImplementedError(f"reference NCSN++ covers {wanted}, not {given}")
        self.prec = Precision()
        self.nf, self.num_res_blocks = nf, num_res_blocks
        self.resolutions = [image_size // 2 ** i for i in range(len(ch_mult))]
        self.attn_resolutions = tuple(attn_resolutions)
        # the values come with the weights (models/ncsnpp.fixed): a float64
        # linspace on the meta device would import torch._dynamo, seconds of
        # every run's set-up
        self.register_buffer("sigmas", torch.empty(num_scales))
        temb = 4 * nf
        m = [nn.Linear(nf, temb), nn.Linear(temb, temb), nn.Conv2d(num_channels, nf, 3, padding=1)]
        hs_c, ch = [nf], nf
        for level, res in enumerate(self.resolutions):
            for _ in range(num_res_blocks):
                m.append(ResnetBlockBigGANpp(ch, nf * ch_mult[level], temb,
                                             skip_rescale=skip_rescale))
                ch = nf * ch_mult[level]
                if res in self.attn_resolutions:
                    m.append(AttnBlockpp(ch, skip_rescale))
                hs_c.append(ch)
            if level != len(ch_mult) - 1:
                m.append(ResnetBlockBigGANpp(ch, ch, temb, down=True, skip_rescale=skip_rescale))
                hs_c.append(ch)
        m += [ResnetBlockBigGANpp(ch, ch, temb, skip_rescale=skip_rescale),
              AttnBlockpp(ch, skip_rescale),
              ResnetBlockBigGANpp(ch, ch, temb, skip_rescale=skip_rescale)]
        for level in reversed(range(len(ch_mult))):
            for _ in range(num_res_blocks + 1):
                m.append(ResnetBlockBigGANpp(ch + hs_c.pop(), nf * ch_mult[level], temb,
                                             skip_rescale=skip_rescale))
                ch = nf * ch_mult[level]
            if self.resolutions[level] in self.attn_resolutions:
                m.append(AttnBlockpp(ch, skip_rescale))
            if level != 0:
                m.append(ResnetBlockBigGANpp(ch, ch, temb, up=True, skip_rescale=skip_rescale))
        m += [nn.GroupNorm(num_groups(ch), ch, eps=1e-6), nn.Conv2d(ch, num_channels, 3, padding=1)]
        self.all_modules = nn.ModuleList(m)

    def forward(self, x: Tensor, labels: Tensor) -> Tensor:
        p = self.prec
        mods = iter(self.all_modules)
        temb = linear(next(mods), timestep_embedding(labels, self.nf), p)
        temb = linear(next(mods), F.silu(temb), p)
        hs = [conv(next(mods), x, p)]
        for level, res in enumerate(self.resolutions):
            for _ in range(self.num_res_blocks):
                h = next(mods)(hs[-1], temb, p)
                if res in self.attn_resolutions:
                    h = next(mods)(h, p)
                hs.append(h)
            if level != len(self.resolutions) - 1:
                hs.append(next(mods)(hs[-1], temb, p))
        h = next(mods)(hs[-1], temb, p)
        h = next(mods)(h, p)
        h = next(mods)(h, temb, p)
        for level in reversed(range(len(self.resolutions))):
            for _ in range(self.num_res_blocks + 1):
                h = next(mods)(torch.cat([h, hs.pop()], dim=1), temb, p)
            if self.resolutions[level] in self.attn_resolutions:
                h = next(mods)(h, p)
            if level != 0:
                h = next(mods)(h, temb, p)
        h = F.silu(group_norm(next(mods), h))
        return conv(next(mods), h, p)
