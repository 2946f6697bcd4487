"""NCSN++ score UNet (port of diffpure_tpu/models/ncsnpp.py:48).

Same construction walk as the reference (ref score_sde/models/ncsnpp.py):
``all_modules[i]`` here is ``m{i}`` in the flax model, so the two load the
same weights (models/convert.py). Input, output and activations are NHWC.

Ported: ``resblock_type='biggan'`` and ``'ddpm'`` (DDPM++ blocks with the
standalone up/down layers), ``progressive='none'``,
``progressive_input='none'``, positional embedding, conditional, naive
resampling, centered data, no sigma scaling; eval mode and, with
``forward(..., train=True)``, training mode (at a dropout rate above 0
the residual blocks on their plain version with dropout, as JAX's
``train=True``; at rate 0 the same function as eval mode, on the kernels). ``init_`` draws fresh
weights as JAX's initialisers do (``ddpm_init``, models/init.py). With
``dtype=torch.bfloat16`` the torso runs in bf16 (parameters stay fp32;
GroupNorm statistics and softmax stay fp32 inside the ops) and the output
head in fp32, as ``NCSNpp(dtype=jnp.bfloat16)`` does. In the ``'ddpm'``
variant the up/down layers' convs take no dtype, so, as in JAX, they
promote a bf16 map to fp32 and the residual stream after the first
downsample is fp32 (the blocks' convs stay bf16).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.models.init import ddpm_init_
from diffpure_tpu_torch.models.layers import NIN, AttnBlockpp, DownsampleLayer, \
    ResnetBlockBigGANpp, ResnetBlockDDPMpp, UpsampleLayer, get_timestep_embedding
from diffpure_tpu_torch.models.registry import register_model
from diffpure_tpu_torch.ops.conv import conv2d_nhwc
from diffpure_tpu_torch.ops.groupnorm import group_norm_silu, ncsn_num_groups

Tensor = torch.Tensor


def get_sigmas(sigma_min: float, sigma_max: float, num_scales: int) -> np.ndarray:
    """Geometric noise scales, descending (ref score_sde/models/utils.py:50-60)."""
    return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), num_scales))


_NOT_PORTED = "not ported yet: ROADMAP Slice 1 item 5 (NCSN++ building blocks)"


@register_model(name="ncsnpp")
class NCSNpp(nn.Module):
    """NCSN++ / DDPM++ score network, CIFAR-10 family (configs/cifar10.yml)."""

    def __init__(self, image_size: int = 32, num_channels: int = 3,
                 nf: int = 128, ch_mult: Tuple[int, ...] = (1, 2, 2, 2),
                 num_res_blocks: int = 8,
                 attn_resolutions: Tuple[int, ...] = (16,),
                 dropout: float = 0.1, resamp_with_conv: bool = True,
                 conditional: bool = True, fir: bool = False,
                 fir_kernel: Tuple[int, ...] = (1, 3, 3, 1),
                 skip_rescale: bool = True, resblock_type: str = "biggan",
                 progressive: str = "none", progressive_input: str = "none",
                 progressive_combine: str = "sum",
                 embedding_type: str = "positional",
                 fourier_scale: float = 16.0, init_scale: float = 0.0,
                 scale_by_sigma: bool = False, centered: bool = True,
                 sigma_min: float = 0.01, sigma_max: float = 50.0,
                 num_scales: int = 1000,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        # fir_kernel, progressive_combine and fourier_scale do not change
        # this configuration's forward.
        if resblock_type not in ("biggan", "ddpm"):
            raise ValueError(f"resblock_type {resblock_type!r}")
        for name, value, want in (
                ("progressive", progressive, "none"),
                ("progressive_input", progressive_input, "none"),
                ("embedding_type", embedding_type, "positional"),
                ("conditional", conditional, True), ("fir", fir, False),
                ("scale_by_sigma", scale_by_sigma, False),
                ("centered", centered, True)):
            if value != want:
                raise NotImplementedError(f"NCSNpp {name}={value!r} is {_NOT_PORTED}")
        self.nf = nf
        self.num_res_blocks = num_res_blocks
        self.all_resolutions = [image_size // (2 ** i) for i in range(len(ch_mult))]
        self.attn_resolutions = tuple(attn_resolutions)
        self.ch_mult = tuple(ch_mult)
        self.dtype = dtype
        self.resblock_type = resblock_type
        self.init_scale = init_scale
        self.register_buffer("sigmas", torch.tensor(
            get_sigmas(sigma_min, sigma_max, num_scales), dtype=torch.float32))

        temb_dim = nf * 4
        ddpm = resblock_type == "ddpm"

        def block(i, o=None):
            cls = ResnetBlockDDPMpp if ddpm else ResnetBlockBigGANpp
            return cls(i, o, temb_dim=temb_dim, skip_rescale=skip_rescale,
                       dropout=dropout)

        def resample(ch, up):
            if ddpm:
                layer = UpsampleLayer if up else DownsampleLayer
                return layer(ch, with_conv=resamp_with_conv)
            return ResnetBlockBigGANpp(ch, temb_dim=temb_dim, up=up, down=not up,
                                       skip_rescale=skip_rescale, dropout=dropout)

        modules = [nn.Linear(nf, temb_dim), nn.Linear(temb_dim, temb_dim),
                   nn.Conv2d(num_channels, nf, 3, padding=1)]
        hs_c = [nf]
        in_ch = nf
        for i_level, res in enumerate(self.all_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * ch_mult[i_level]
                modules.append(block(in_ch, out_ch))
                in_ch = out_ch
                if res in self.attn_resolutions:
                    modules.append(AttnBlockpp(in_ch, skip_rescale))
                hs_c.append(in_ch)
            if i_level != len(ch_mult) - 1:
                modules.append(resample(in_ch, up=False))
                hs_c.append(in_ch)
        modules += [block(in_ch), AttnBlockpp(in_ch, skip_rescale), block(in_ch)]
        for i_level in reversed(range(len(ch_mult))):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[i_level]
                modules.append(block(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if self.all_resolutions[i_level] in self.attn_resolutions:
                modules.append(AttnBlockpp(in_ch, skip_rescale))
            if i_level != 0:
                modules.append(resample(in_ch, up=True))
        assert not hs_c
        modules += [nn.GroupNorm(ncsn_num_groups(in_ch), in_ch, eps=1e-6),
                    nn.Conv2d(in_ch, num_channels, 3, padding=1)]
        self.all_modules = nn.ModuleList(modules)

    def init_(self, generator: torch.Generator) -> "NCSNpp":
        """Fresh weights as the flax model's initialisers draw them:
        ``ddpm_init`` (variance scaling over fan_avg, uniform) of scale 1
        for every conv and dense kernel, 0.1 for the NIN kernels, and
        ``init_scale`` (0 taken as 1e-10) for each residual block's
        ``Conv_1``, each attention block's ``NIN_3`` and the output conv;
        zero biases, unit GroupNorm scales."""
        s = self.init_scale
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, (nn.Conv2d, nn.Linear)):
                    ddpm_init_(m.weight, generator)
                    m.bias.zero_()
                elif isinstance(m, NIN):
                    ddpm_init_(m.W, generator, 0.1, w_in_out=True)
                    m.b.zero_()
            for m in self.modules():
                if isinstance(m, (ResnetBlockBigGANpp, ResnetBlockDDPMpp)):
                    ddpm_init_(m.Conv_1.weight, generator, s)
                elif isinstance(m, AttnBlockpp):
                    ddpm_init_(m.NIN_3.W, generator, s, w_in_out=True)
            ddpm_init_(self.all_modules[-1].weight, generator, s)
        return self

    def forward(self, x: Tensor, time_cond: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """x: (N, H, W, C) images in [-1, 1]; time_cond: (N,) labels t*999.
        ``train``: the residual blocks' dropout, drawn from ``generator``."""
        kw = dict(train=True, generator=generator) if train else {}
        modules = iter(self.all_modules)
        temb = get_timestep_embedding(time_cond, self.nf)
        temb = next(modules)(temb)
        temb = next(modules)(F.silu(temb))

        input_dtype = x.dtype
        if self.dtype is not None:
            x = x.to(self.dtype)
            temb = temb.to(self.dtype)
        cdt = x.dtype
        # the DDPM++ variant's up/down layers take no temb
        resample = (lambda m, h: m(h)) if self.resblock_type == "ddpm" \
            else (lambda m, h: m(h, temb, **kw))
        stem = next(modules)
        hs = [conv2d_nhwc(x, stem.weight.to(cdt), stem.bias.to(cdt))]
        for i_level, res in enumerate(self.all_resolutions):
            for _ in range(self.num_res_blocks):
                h = next(modules)(hs[-1], temb, **kw)
                if res in self.attn_resolutions:
                    h = next(modules)(h)
                hs.append(h)
            if i_level != len(self.all_resolutions) - 1:
                hs.append(resample(next(modules), hs[-1]))

        h = next(modules)(hs[-1], temb, **kw)
        h = next(modules)(h)
        h = next(modules)(h, temb, **kw)

        for i_level in reversed(range(len(self.all_resolutions))):
            for _ in range(self.num_res_blocks + 1):
                h = next(modules)((h, hs.pop()), temb, **kw)
            if self.all_resolutions[i_level] in self.attn_resolutions:
                h = next(modules)(h)
            if i_level != 0:
                h = resample(next(modules), h)
        assert not hs

        h = h.to(input_dtype)
        gn = next(modules)
        h = group_norm_silu(h, gn.weight, gn.bias, gn.num_groups, gn.eps)
        head = next(modules)
        return conv2d_nhwc(h, head.weight.to(h.dtype), head.bias.to(h.dtype))
