"""The SDEdit DDPM UNet of the CelebA-HQ defence over NHWC maps (port of
diffpure_tpu/models/ddpm_unet.py; ref ddpm/unet_ddpm.py:200-345),
registered as ``"ddpm_sdedit"``.

Module and parameter names are the reference's own (``down.0.block.1.
norm1.weight``, ``temb.dense.0``, ``mid.attn_1.q``, ``up.3.upsample.conv``),
so ``celeba_hq.ckpt`` loads with ``load_state_dict(strict=True)``
(models/convert.py ``load_sdedit_checkpoint``). CelebA-HQ's configuration
(configs/celeba.yml) is the default: ch 128, ch_mult (1, 1, 2, 2, 4, 4), 2
residual blocks, attention at 16 x 16, 256 px; 113,673,219 parameters.

Mixed precision as in JAX: parameters fp32; with ``dtype=torch.bfloat16``
the torso (convs, ``temb_proj``, the attention's 1x1 convs) runs in bf16,
the timestep embedding, ``norm_out`` and ``conv_out`` in fp32. GroupNorm
(32 groups, eps 1e-6) is plain everywhere but on the halo route; SiLU is
written x * sigmoid(x), as JAX's ``nn.swish``, so that bf16 rounds where
JAX rounds.

The halo route (JAX ``_halo_eligible``, :53-74, read as JAX reads it off
the TPU: no 128-lane condition): a residual block whose input and output
maps pass the tiled-GN size gate (``adm_unet.use_tiled_gn``: H W C * 4 >=
2 MiB, H even) and whose 3x3 weights take 9 cin cout esize <= 6 MiB runs
its two stages as ``gn_silu_conv_block`` (kernels #6 and #8 on a CUDA
tensor, their plain versions on a CPU one); the second stage folds
``temb_proj(swish(temb))`` into the GroupNorm affine as ``pre_shift`` and
takes the skip through the ``nin_shortcut``'s weight, or the identity.
At 256 px that is every block at 256^2, 128^2 and 64^2. ``halo_census``
lists the stages of one evaluation. Eval mode only: the reference's
dropout (0.0 in configs/celeba.yml) is not built.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple
from unittest import mock

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.models.adm_unet import _conv, _hwio, _pack_halo, use_tiled_gn
from diffpure_tpu_torch.models.layers import _cast, _cast_cached, _Derived, \
    get_timestep_embedding
from diffpure_tpu_torch.models.registry import register_model
from diffpure_tpu_torch.ops.attention import spatial_attention
from diffpure_tpu_torch.ops.conv import conv2d_nhwc
from diffpure_tpu_torch.ops.groupnorm import group_norm
from diffpure_tpu_torch.ops.halo_conv import gn_silu_conv_block
from diffpure_tpu_torch.ops.upfirdn2d import naive_upsample_2d

Tensor = torch.Tensor

GN_GROUPS, GN_EPS = 32, 1e-6
# the halo route's bound on one stage's 3x3 weights (JAX :73)
HALO_WEIGHT_BYTES = 6 * 1024 * 1024


def _swish(x: Tensor) -> Tensor:
    return x * torch.sigmoid(x)


def _normalize(channels: int) -> nn.GroupNorm:
    """GroupNorm(32, eps 1e-6) (ref unet_ddpm.py:40-41)."""
    return nn.GroupNorm(GN_GROUPS, channels, eps=GN_EPS)


def _gn_swish(gn: nn.GroupNorm, x: Tensor) -> Tensor:
    return _swish(group_norm(x, gn.weight, gn.bias, GN_GROUPS, GN_EPS))


def halo_eligible(x_shape, in_ch: int, out_ch: int, dtype: Optional[torch.dtype]) -> bool:
    """Whether a residual block of this input takes the halo route."""
    if not (use_tiled_gn(x_shape) and use_tiled_gn(tuple(x_shape[:3]) + (out_ch,))):
        return False
    esize = 2 if dtype == torch.bfloat16 else 4
    return 9 * in_ch * out_ch * esize <= HALO_WEIGHT_BYTES


class ResnetBlock(nn.Module):
    """ref unet_ddpm.py:85-142 (the 1x1 ``nin_shortcut`` where the channels
    change; the model never builds the 3x3 ``conv_shortcut``)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.norm1 = _normalize(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.temb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = _normalize(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)
        self._temb = _Derived(_cast)
        self._halo_in = _Derived(_pack_halo)
        self._halo_out = _Derived(_pack_halo)

    def _temb_row(self, temb: Tensor, dtype: torch.dtype) -> Tensor:
        w, b = _cast_cached(self._temb, (self.temb_proj.weight, self.temb_proj.bias), dtype,
                            temb.device)
        return F.linear(_swish(temb).to(dtype), w, b)

    def forward(self, x: Tensor, temb: Tensor) -> Tensor:
        """x (N, H, W, in) in the torso's dtype; temb (N, temb_channels) fp32."""
        temb_row = self._temb_row(temb, x.dtype)
        proj = getattr(self, "nin_shortcut", None)
        if halo_eligible(x.shape, self.in_channels, self.out_channels, x.dtype):
            on_card = x.device.type == "cuda"
            if proj is not None:
                w_proj = proj.weight[:, :, 0, 0].t()
                b_out = self.conv2.bias + proj.bias  # the projection's bias folded in
            else:
                w_proj, b_out = None, self.conv2.bias
            h = gn_silu_conv_block(
                x, self.norm1.weight, self.norm1.bias, None, None, _hwio(self.conv1),
                self.conv1.bias, None, None, None, GN_GROUPS, GN_EPS,
                packed=self._halo_in.get((self.conv1.weight, None), x.dtype, x.device)
                if on_card else None)
            return gn_silu_conv_block(
                h, self.norm2.weight, self.norm2.bias, None, None, _hwio(self.conv2), b_out,
                x, w_proj, temb_row, GN_GROUPS, GN_EPS,
                packed=self._halo_out.get(
                    (self.conv2.weight, None if proj is None else proj.weight),
                    x.dtype, x.device) if on_card else None)

        h = _conv(self.conv1, _gn_swish(self.norm1, x))
        h = h + temb_row[:, None, None, :]
        h = _conv(self.conv2, _gn_swish(self.norm2, h))
        if proj is not None:
            x = _conv(proj, x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial attention through 1x1 convs (ref
    unet_ddpm.py:144-196)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _normalize(channels)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(channels, channels, 1)
                                                 for _ in range(4))

    def forward(self, x: Tensor) -> Tensor:
        h = group_norm(x, self.norm.weight, self.norm.bias, GN_GROUPS, GN_EPS)
        h = spatial_attention(_conv(self.q, h), _conv(self.k, h), _conv(self.v, h))
        return x + _conv(self.proj_out, h)


class Downsample(nn.Module):
    """Pad one row and column at the end, then a stride-2 3x3 conv (SDEdit's
    padding, ref unet_ddpm.py:64-82), or a 2x2 mean-pool."""

    def __init__(self, channels: int, with_conv: bool):
        super().__init__()
        if with_conv:
            self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: Tensor) -> Tensor:
        if not hasattr(self, "conv"):
            N, H, W, C = x.shape
            return x.reshape(N, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))
        x = F.pad(x, (0, 0, 0, 1, 0, 1))
        w = self.conv.weight.to(x.dtype)
        return conv2d_nhwc(x, w, self.conv.bias.to(x.dtype), stride=2, padding=0)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv (ref unet_ddpm.py:44-61)."""

    def __init__(self, channels: int, with_conv: bool):
        super().__init__()
        if with_conv:
            self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        x = naive_upsample_2d(x)
        return _conv(self.conv, x) if hasattr(self, "conv") else x


class _Level(nn.Module):
    """One resolution's blocks, attention blocks and resampler."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class _Temb(nn.Module):
    def __init__(self, ch: int, temb_ch: int):
        super().__init__()
        self.dense = nn.ModuleList([nn.Linear(ch, temb_ch), nn.Linear(temb_ch, temb_ch)])


@register_model(name="ddpm_sdedit")
class DDPMUNet(nn.Module):
    """ref unet_ddpm.py:200-345. forward(x NHWC, integer steps (N,)) ->
    epsilon (N, H, W, out_ch) in x's dtype."""

    def __init__(self, resolution: int = 256, in_channels: int = 3, out_ch: int = 3,
                 ch: int = 128, ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Tuple[int, ...] = (16,),
                 resamp_with_conv: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.resolution, self.ch = resolution, ch
        self.num_res_blocks = num_res_blocks
        self.dtype = dtype
        temb_ch = ch * 4
        self.temb = _Temb(ch, temb_ch)
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)

        curr_res = resolution
        in_ch_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        block_in = ch
        for i_level, mult in enumerate(ch_mult):
            level = _Level()
            block_in, block_out = ch * in_ch_mult[i_level], ch * mult
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, temb_ch))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample(block_in, resamp_with_conv)
                curr_res //= 2
            self.down.append(level)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, temb_ch)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, temb_ch)

        ups = []
        for i_level in reversed(range(len(ch_mult))):
            level = _Level()
            block_out = skip_in = ch * ch_mult[i_level]
            for i_block in range(num_res_blocks + 1):
                if i_block == num_res_blocks:
                    skip_in = ch * in_ch_mult[i_level]
                level.block.append(ResnetBlock(block_in + skip_in, block_out, temb_ch))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != 0:
                level.upsample = Upsample(block_in, resamp_with_conv)
                curr_res *= 2
            ups.insert(0, level)
        self.up = nn.ModuleList(ups)

        self.norm_out = _normalize(block_in)
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, x: Tensor, t: Tensor) -> Tensor:
        if not (x.shape[1] == x.shape[2] == self.resolution):
            raise ValueError(f"the model takes {self.resolution}^2 images, not "
                             f"{tuple(x.shape[1:3])}")
        temb = get_timestep_embedding(t, self.ch)
        temb = self.temb.dense[0](temb)
        temb = self.temb.dense[1](_swish(temb))

        input_dtype = x.dtype
        h = x.to(self.dtype or x.dtype)
        hs = [_conv(self.conv_in, h)]
        for level in self.down:
            for i_block, block in enumerate(level.block):
                h = block(hs[-1], temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))

        h = self.mid.block_1(hs[-1], temb)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h, temb)

        for level in reversed(self.up):
            for i_block, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=-1), temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        assert not hs

        h = _gn_swish(self.norm_out, h.to(input_dtype))
        return conv2d_nhwc(h, self.conv_out.weight, self.conv_out.bias)


def halo_census(batch: int = 1, dtype: Optional[torch.dtype] = None, **config) -> Counter:
    """The halo stages of one ``DDPMUNet(dtype=dtype, **config)`` evaluation
    at ``batch``, walked on the meta device: (x shape (N, H, W, cin), cout,
    skip channels (0: none), projected skip, pre_shift) -> calls. Each
    stage is one #6 (GroupNorm stats) and one #8 (halo conv) launch on the
    card."""
    calls = Counter()

    def record(x, gn_scale, gn_bias, film_scale, film_shift, w, bias, skip, w_proj,
               pre_shift, num_groups, eps, packed=None):
        calls[(tuple(x.shape), w.shape[-1], 0 if skip is None else skip.shape[-1],
               w_proj is not None, pre_shift is not None)] += 1
        return torch.empty(tuple(x.shape[:3]) + (w.shape[-1],), dtype=x.dtype,
                           device=x.device)

    with torch.device("meta"):
        model = DDPMUNet(dtype=dtype, **config)
    res = model.resolution
    with mock.patch(f"{__name__}.gn_silu_conv_block", record):
        model(torch.empty(batch, res, res, 3, device="meta"),
              torch.zeros(batch, dtype=torch.int32, device="meta"))
    return calls
