"""NCSN++ score UNet (port of diffpure_tpu/models/ncsnpp.py:48).

Same construction walk as the reference (ref score_sde/models/ncsnpp.py):
``all_modules[i]`` here is ``m{i}`` in the flax model, so the two load the
same weights (models/convert.py). Input, output and activations are NHWC.

Every option of JAX's NCSN++: ``resblock_type`` 'biggan' or 'ddpm' (DDPM++
blocks with the standalone up/down layers); naive or FIR resampling
(``fir``, ``fir_kernel``); ``progressive`` 'none', 'output_skip' or
'residual' and ``progressive_input`` 'none', 'input_skip' or 'residual'
(the image pyramids, combined by ``progressive_combine`` 'sum' or 'cat');
``embedding_type`` 'positional' (labels t*999) or 'fourier' (the noise
scale sigma as the label, embedded by log sigma); ``conditional``;
``scale_by_sigma``; ``centered`` (else x in [0, 1] is mapped to 2x - 1).
The BigGAN blocks that resample with the FIR filter, and every BigGAN
block of an unconditional model, run JAX's unfused graph in plain PyTorch
(models/layers.py); the others take the block kernels on the card. Eval
mode and, with ``forward(..., train=True)``, training mode (at a dropout
rate above 0 the residual blocks on their plain version with dropout, as
JAX's ``train=True``; at rate 0 the same function as eval mode, on the
kernels). ``init_`` draws fresh weights as JAX's initialisers do
(``ddpm_init``, models/init.py). With ``dtype=torch.bfloat16`` the torso
runs in bf16 (parameters stay fp32; GroupNorm statistics and softmax stay
fp32 inside the ops) and the output head in fp32, as
``NCSNpp(dtype=jnp.bfloat16)`` does; the convs that JAX builds without a
dtype (the up/down layers' of the ``'ddpm'`` variant, the pyramids',
``Combine``'s) promote a bf16 map to fp32 as JAX's do, and the FIR convs
compute in their input's dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.models.init import ddpm_init_
from diffpure_tpu_torch.models.layers import NIN, AttnBlockpp, Combine, DownsampleLayer, \
    FIRConv2d, GaussianFourierProjection, ResnetBlockBigGANpp, ResnetBlockDDPMpp, \
    UpsampleLayer, _conv_promoted, _rescale, conv_then_bias, \
    get_timestep_embedding
from diffpure_tpu_torch.models.registry import register_model
from diffpure_tpu_torch.ops.groupnorm import group_norm_silu, ncsn_num_groups
from diffpure_tpu_torch.ops.upfirdn2d import downsample_2d, naive_downsample_2d, \
    naive_upsample_2d, upsample_2d

Tensor = torch.Tensor


def get_sigmas(sigma_min: float, sigma_max: float, num_scales: int) -> np.ndarray:
    """Geometric noise scales, descending (ref score_sde/models/utils.py:50-60)."""
    return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), num_scales))


def _gn_silu(gn: nn.GroupNorm, h: Tensor) -> Tensor:
    """act(GroupNormTorch(h)): the scale and bias in h's dtype first."""
    return group_norm_silu(h, gn.weight.to(h.dtype), gn.bias.to(h.dtype), gn.num_groups,
                           gn.eps)


@register_model(name="ncsnpp")
class NCSNpp(nn.Module):
    """NCSN++ / DDPM++ score network (configs/cifar10.yml, the VP DDPM++;
    configs/cifar10_ve.yml, score_sde's VE NCSN++)."""

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
        for name, value, allowed in (
                ("resblock_type", resblock_type, ("biggan", "ddpm")),
                ("progressive", progressive, ("none", "output_skip", "residual")),
                ("progressive_input", progressive_input, ("none", "input_skip", "residual")),
                ("progressive_combine", progressive_combine.lower(), ("sum", "cat")),
                ("embedding_type", embedding_type, ("positional", "fourier"))):
            if value not in allowed:
                raise ValueError(f"NCSNpp {name}={value!r}: one of {allowed}")
        self.nf = nf
        self.num_res_blocks = num_res_blocks
        self.all_resolutions = [image_size // (2 ** i) for i in range(len(ch_mult))]
        self.attn_resolutions = tuple(attn_resolutions)
        self.ch_mult = tuple(ch_mult)
        self.dtype = dtype
        self.resblock_type = resblock_type
        self.init_scale = init_scale
        self.conditional = conditional
        self.fir, self.fir_kernel = fir, tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.progressive, self.progressive_input = progressive, progressive_input
        self.embedding_type = embedding_type
        self.scale_by_sigma, self.centered = scale_by_sigma, centered
        self.register_buffer("sigmas", torch.tensor(
            get_sigmas(sigma_min, sigma_max, num_scales), dtype=torch.float32))

        temb_dim = nf * 4 if conditional else None
        ddpm = resblock_type == "ddpm"
        resample_kw = dict(fir=fir, fir_kernel=fir_kernel)

        def block(i, o=None):
            if ddpm:
                return ResnetBlockDDPMpp(i, o, temb_dim=temb_dim, skip_rescale=skip_rescale,
                                         dropout=dropout)
            return ResnetBlockBigGANpp(i, o, temb_dim=temb_dim, skip_rescale=skip_rescale,
                                       dropout=dropout, **resample_kw)

        def resample(ch, up):
            if ddpm:
                layer = UpsampleLayer if up else DownsampleLayer
                return layer(ch, with_conv=resamp_with_conv, **resample_kw)
            return ResnetBlockBigGANpp(ch, temb_dim=temb_dim, up=up, down=not up,
                                       skip_rescale=skip_rescale, dropout=dropout,
                                       **resample_kw)

        def head(ch, out, scaled):
            """A pyramid or output head: GroupNorm, then a 3x3 conv; the
            convs to the image's channels take ``init_scale``."""
            if scaled:
                self._scaled_heads.append(len(modules) + 1)
            return [nn.GroupNorm(ncsn_num_groups(ch), ch, eps=1e-6),
                    nn.Conv2d(ch, out, 3, padding=1)]

        self._scaled_heads = []
        modules = []
        if embedding_type == "fourier":
            modules.append(GaussianFourierProjection(nf, fourier_scale))
        if conditional:
            embed = 2 * nf if embedding_type == "fourier" else nf
            modules += [nn.Linear(embed, nf * 4), nn.Linear(nf * 4, nf * 4)]
        modules.append(nn.Conv2d(num_channels, nf, 3, padding=1))
        pyramid_in = num_channels
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
                if progressive_input == "input_skip":
                    modules.append(Combine(pyramid_in, in_ch, progressive_combine.lower()))
                    if progressive_combine.lower() == "cat":
                        in_ch *= 2
                elif progressive_input == "residual":
                    modules.append(DownsampleLayer(pyramid_in, in_ch, with_conv=True,
                                                   **resample_kw))
                    pyramid_in = in_ch
                hs_c.append(in_ch)
        modules += [block(in_ch), AttnBlockpp(in_ch, skip_rescale), block(in_ch)]
        pyramid_ch = None
        for i_level in reversed(range(len(ch_mult))):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[i_level]
                modules.append(block(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if self.all_resolutions[i_level] in self.attn_resolutions:
                modules.append(AttnBlockpp(in_ch, skip_rescale))
            if progressive == "output_skip":
                modules += head(in_ch, num_channels, scaled=True)
            elif progressive == "residual" and i_level == len(ch_mult) - 1:
                modules += head(in_ch, in_ch, scaled=False)
                pyramid_ch = in_ch
            elif progressive == "residual":
                modules.append(UpsampleLayer(pyramid_ch, in_ch, with_conv=True, **resample_kw))
                pyramid_ch = in_ch
            if i_level != 0:
                modules.append(resample(in_ch, up=True))
        assert not hs_c
        if progressive != "output_skip":
            modules += head(in_ch, num_channels, scaled=True)
        self.all_modules = nn.ModuleList(modules)

    def init_(self, generator: torch.Generator) -> "NCSNpp":
        """Fresh weights as the flax model's initialisers draw them:
        ``ddpm_init`` (variance scaling over fan_avg, uniform) of scale 1
        for every conv and dense kernel, 0.1 for the NIN kernels, and
        ``init_scale`` (0 taken as 1e-10) for each residual block's
        ``Conv_1``, each attention block's ``NIN_3`` and each conv to the
        image's channels (the output head's, output_skip's pyramid heads');
        zero biases, unit GroupNorm scales; the Fourier projection N(0,
        fourier_scale^2)."""
        s = self.init_scale
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, (nn.Conv2d, nn.Linear, FIRConv2d)):
                    ddpm_init_(m.weight, generator)
                    m.bias.zero_()
                elif isinstance(m, NIN):
                    ddpm_init_(m.W, generator, 0.1, w_in_out=True)
                    m.b.zero_()
                elif isinstance(m, GaussianFourierProjection):
                    m.W.normal_(generator=generator).mul_(m.scale)
            for m in self.modules():
                if isinstance(m, (ResnetBlockBigGANpp, ResnetBlockDDPMpp)):
                    ddpm_init_(m.Conv_1.weight, generator, s)
                elif isinstance(m, AttnBlockpp):
                    ddpm_init_(m.NIN_3.W, generator, s, w_in_out=True)
            for i in self._scaled_heads:
                ddpm_init_(self.all_modules[i].weight, generator, s)
        return self

    def forward(self, x: Tensor, time_cond: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """x: (N, H, W, C) images, in [-1, 1] (``centered``) or [0, 1];
        time_cond: (N,) labels t*999 (positional) or noise scales sigma
        (fourier). ``train``: the residual blocks' dropout, drawn from
        ``generator``."""
        kw = dict(train=True, generator=generator) if train else {}
        modules = iter(self.all_modules)
        if self.embedding_type == "fourier":
            used_sigmas = time_cond
            temb = next(modules)(torch.log(used_sigmas))
        else:
            if self.scale_by_sigma:
                used_sigmas = self.sigmas[time_cond.to(torch.int32).long()]
            temb = get_timestep_embedding(time_cond, self.nf)
        if self.conditional:
            temb = next(modules)(temb)
            temb = next(modules)(F.silu(temb))
        else:
            temb = None
        if not self.centered:
            x = 2 * x - 1.0

        input_dtype = x.dtype
        if self.dtype is not None:
            x = x.to(self.dtype)
            if temb is not None:
                temb = temb.to(self.dtype)
        cdt = x.dtype
        # the DDPM++ variant's up/down layers take no temb
        resample = (lambda m, h: m(h)) if self.resblock_type == "ddpm" \
            else (lambda m, h: m(h, temb, **kw))

        def join(pyramid, h):
            return _rescale(pyramid + h) if self.skip_rescale else pyramid + h

        input_pyramid = x
        stem = next(modules)
        hs = [conv_then_bias(x, stem.weight.to(cdt), stem.bias.to(cdt))]
        for i_level, res in enumerate(self.all_resolutions):
            for _ in range(self.num_res_blocks):
                h = next(modules)(hs[-1], temb, **kw)
                if res in self.attn_resolutions:
                    h = next(modules)(h)
                hs.append(h)
            if i_level != len(self.all_resolutions) - 1:
                h = resample(next(modules), hs[-1])
                if self.progressive_input == "input_skip":
                    input_pyramid = (downsample_2d(input_pyramid, self.fir_kernel)
                                     if self.fir else naive_downsample_2d(input_pyramid))
                    h = next(modules)(input_pyramid, h)
                elif self.progressive_input == "residual":
                    input_pyramid = join(next(modules)(input_pyramid), h)
                    h = input_pyramid
                hs.append(h)

        h = next(modules)(hs[-1], temb, **kw)
        h = next(modules)(h)
        h = next(modules)(h, temb, **kw)

        pyramid = None
        for i_level in reversed(range(len(self.all_resolutions))):
            for _ in range(self.num_res_blocks + 1):
                h = next(modules)((h, hs.pop()), temb, **kw)
            if self.all_resolutions[i_level] in self.attn_resolutions:
                h = next(modules)(h)
            if self.progressive == "output_skip":
                gn, conv = next(modules), next(modules)
                out = _conv_promoted(conv, _gn_silu(gn, h))
                if pyramid is None:
                    pyramid = out
                else:
                    pyramid = (upsample_2d(pyramid, self.fir_kernel) if self.fir
                               else naive_upsample_2d(pyramid)) + out
            elif self.progressive == "residual":
                if pyramid is None:
                    gn, conv = next(modules), next(modules)
                    pyramid = _conv_promoted(conv, _gn_silu(gn, h))
                else:
                    pyramid = join(next(modules)(pyramid), h)
                    h = pyramid
            if i_level != 0:
                h = resample(next(modules), h)
        assert not hs

        if self.progressive == "output_skip":
            h = pyramid
        else:
            h = h.to(input_dtype)
            gn, conv = next(modules), next(modules)
            h = _conv_promoted(conv, _gn_silu(gn, h))
        h = h.to(input_dtype)
        if self.scale_by_sigma:
            h = h / used_sigmas.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return h
