"""The ADM UNet (guided-diffusion's ``unet.py``, Dhariwal & Nichol, 2021),
plain PyTorch in NCHW, float32: the unconditional 256x256 model of DiffPure's
ImageNet config (scale-shift norm, residual up/down blocks, legacy-order
attention in heads of ``num_head_channels``).

Module names are guided-diffusion's (``input_blocks.{i}.{j}``,
``in_layers.0``, ``emb_layers.1``, ``out_layers.3``, ``skip_connection``,
``qkv`` / ``proj_out`` conv1d weights (out, in, 1)), so one state dict
loads into this model and the program's.

Departures: everything computes in float32 (the checkpoint's fp16 torso
is the program's business; this is the reference it is held to); dropout is
left out (eval mode); products' operands pass through ``Precision.q``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.layers import conv, conv1d, downsample, group_norm, linear, \
    matmul, upsample
from gpubench.reference.precision import Precision

Tensor = torch.Tensor


def gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-5)


def timestep_embedding(t: Tensor, dim: int, max_period: int = 10000) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, ch: int, emb: int, out: int, up: bool = False, down: bool = False):
        super().__init__()
        self.in_layers = nn.Sequential(gn(ch), nn.SiLU(), nn.Conv2d(ch, out, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb, 2 * out))
        self.out_layers = nn.Sequential(gn(out), nn.SiLU(), nn.Dropout(0.0),
                                        nn.Conv2d(out, out, 3, padding=1))
        self.skip_connection = nn.Identity() if out == ch else nn.Conv2d(ch, out, 1)
        self.up, self.down = up, down

    def forward(self, x: Tensor, emb: Tensor, prec: Precision) -> Tensor:
        h = F.silu(group_norm(self.in_layers[0], x))
        if self.up:
            h, x = upsample(h), upsample(x)
        elif self.down:
            h, x = downsample(h), downsample(x)
        h = conv(self.in_layers[2], h, prec)
        scale, shift = linear(self.emb_layers[1], F.silu(emb), prec)[:, :, None, None].chunk(2, 1)
        h = F.silu(group_norm(self.out_layers[0], h) * (1 + scale) + shift)
        h = conv(self.out_layers[3], h, prec)
        skip = x if isinstance(self.skip_connection, nn.Identity) \
            else conv(self.skip_connection, x, prec)
        return skip + h


class AttentionBlock(nn.Module):
    def __init__(self, ch: int, head_channels: int):
        super().__init__()
        self.heads = ch // head_channels
        self.norm = gn(ch)
        self.qkv = nn.Conv1d(ch, 3 * ch, 1)
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, x: Tensor, prec: Precision) -> Tensor:
        b, c, H, W = x.shape
        x = x.reshape(b, c, H * W)
        qkv = conv1d(self.qkv, group_norm(self.norm, x), prec)
        ch = c // self.heads
        q, k, v = qkv.reshape(b * self.heads, 3 * ch, H * W).split(ch, dim=1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        w = torch.softmax(matmul((q * scale).transpose(1, 2), k * scale, prec), dim=-1)
        a = matmul(v, w.transpose(1, 2), prec).reshape(b, c, H * W)
        return (x + conv1d(self.proj_out, a, prec)).reshape(b, c, H, W)


class ADMUNet(nn.Module):
    """forward(x NCHW in [-1, 1], integer timesteps (N,)) -> NCHW with
    ``out_channels`` (epsilon, then the variance's channels)."""

    def __init__(self, image_size: int = 256, in_channels: int = 3, model_channels: int = 256,
                 out_channels: int = 6, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (8, 16, 32),
                 channel_mult: Sequence[float] = (1, 1, 2, 2, 4, 4),
                 num_head_channels: int = 64, use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True, use_new_attention_order: bool = False,
                 num_classes: Optional[int] = None, **unused):
        super().__init__()
        if not (use_scale_shift_norm and resblock_updown) or use_new_attention_order \
                or num_classes is not None:
            raise NotImplementedError("reference ADM: unconditional, scale-shift norm, "
                                      "residual up/down, legacy attention order only")
        self.prec = Precision()
        self.model_channels = model_channels
        emb = 4 * model_channels
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb), nn.SiLU(),
                                        nn.Linear(emb, emb))
        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([nn.ModuleList([nn.Conv2d(in_channels, ch, 3, padding=1)])])
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, emb, int(mult * model_channels))]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, num_head_channels))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([ResBlock(ch, emb, ch, down=True)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, emb, ch),
                                           AttentionBlock(ch, num_head_channels),
                                           ResBlock(ch, emb, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), emb, int(model_channels * mult))]
                ch = int(model_channels * mult)
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, num_head_channels))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, emb, ch, up=True))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(gn(ch), nn.SiLU(), nn.Conv2d(ch, out_channels, 3, padding=1))

    def _run(self, layers, h: Tensor, emb: Tensor) -> Tensor:
        for layer in layers:
            if isinstance(layer, ResBlock):
                h = layer(h, emb, self.prec)
            elif isinstance(layer, AttentionBlock):
                h = layer(h, self.prec)
            else:
                h = conv(layer, h, self.prec)
        return h

    def forward(self, x: Tensor, timesteps: Tensor) -> Tensor:
        p = self.prec
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = linear(self.time_embed[2], F.silu(linear(self.time_embed[0], emb, p)), p)
        hs, h = [], x
        for layers in self.input_blocks:
            h = self._run(layers, h, emb)
            hs.append(h)
        h = self._run(self.middle_block, h, emb)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), emb)
        h = F.silu(group_norm(self.out[0], h))
        return conv(self.out[2], h, p)
