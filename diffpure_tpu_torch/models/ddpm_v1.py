"""The score_sde DDPM score model (port of diffpure_tpu/models/ddpm_v1.py:26;
ref score_sde/models/ddpm.py:39-181), registered as ``"ddpm"``.

The classic DDPM UNet of DDPM++ residual blocks, built by the same
``all_modules`` walk as NCSN++: ``all_modules[i]`` here is ``m{i}`` in the
flax model, so the two load the same weights (models/convert.py
``ddpm_state_dict_from_flax``). Input and output are NHWC and fp32, as the
JAX model has no compute dtype. The CIFAR-10 widths are the defaults
(score_sde's configs/vp/ddpm/cifar10_continuous.py): 35,218,947 parameters.
``forward(..., train=True)`` is JAX's training mode: the residual blocks'
dropout after their second GroupNorm+SiLU, drawn from the caller's
generator (``layers.dropout``), as NCSN++'s training mode; at rate 0 it is
eval mode's function on eval mode's route (#10 and #3 on the card either
way).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.models.layers import AttnBlockpp, DownsampleLayer, \
    GroupNormTorch, ResnetBlockDDPMpp, UpsampleLayer, get_timestep_embedding
from diffpure_tpu_torch.models.ncsnpp import get_sigmas
from diffpure_tpu_torch.models.registry import register_model
from diffpure_tpu_torch.ops.conv import conv2d_nhwc

Tensor = torch.Tensor


@register_model(name="ddpm")
class DDPM(nn.Module):
    """ref score_sde/models/ddpm.py:39-181."""

    def __init__(self, image_size: int = 32, num_channels: int = 3, nf: int = 128,
                 ch_mult: Tuple[int, ...] = (1, 2, 2, 2), num_res_blocks: int = 2,
                 attn_resolutions: Tuple[int, ...] = (16,), dropout: float = 0.1,
                 resamp_with_conv: bool = True, conditional: bool = True,
                 centered: bool = True, scale_by_sigma: bool = False,
                 sigma_min: float = 0.01, sigma_max: float = 50.0,
                 num_scales: int = 1000):
        super().__init__()
        self.nf = nf
        self.num_res_blocks = num_res_blocks
        self.all_resolutions = [image_size // (2 ** i) for i in range(len(ch_mult))]
        self.attn_resolutions = tuple(attn_resolutions)
        self.conditional = conditional
        self.centered = centered
        self.scale_by_sigma = scale_by_sigma
        if scale_by_sigma:
            self.register_buffer("sigmas", torch.tensor(
                get_sigmas(sigma_min, sigma_max, num_scales), dtype=torch.float32))

        temb_dim = nf * 4 if conditional else None
        block = lambda i, o=None: ResnetBlockDDPMpp(i, o, temb_dim=temb_dim,  # noqa: E731
                                                    dropout=dropout)
        modules = [nn.Linear(nf, temb_dim), nn.Linear(temb_dim, temb_dim)] \
            if conditional else []
        modules.append(nn.Conv2d(num_channels, nf, 3, padding=1))
        hs_c = [nf]
        in_ch = nf
        for i_level, res in enumerate(self.all_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * ch_mult[i_level]
                modules.append(block(in_ch, out_ch))
                in_ch = out_ch
                if res in self.attn_resolutions:
                    modules.append(AttnBlockpp(in_ch, skip_rescale=False))
                hs_c.append(in_ch)
            if i_level != len(ch_mult) - 1:
                modules.append(DownsampleLayer(in_ch, with_conv=resamp_with_conv))
                hs_c.append(in_ch)
        modules += [block(in_ch), AttnBlockpp(in_ch, skip_rescale=False), block(in_ch)]
        for i_level in reversed(range(len(ch_mult))):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[i_level]
                modules.append(block(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if self.all_resolutions[i_level] in self.attn_resolutions:
                modules.append(AttnBlockpp(in_ch, skip_rescale=False))
            if i_level != 0:
                modules.append(UpsampleLayer(in_ch, with_conv=resamp_with_conv))
        assert not hs_c
        modules += [GroupNormTorch(32, in_ch, eps=1e-6),
                    nn.Conv2d(in_ch, num_channels, 3, padding=1)]
        self.all_modules = nn.ModuleList(modules)

    def forward(self, x: Tensor, labels: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """x: (N, H, W, C) images ([-1, 1] when centered, else [0, 1]);
        labels: (N,) t*999. ``train``: the residual blocks' dropout, drawn
        from ``generator``."""
        kw = dict(train=True, generator=generator) if train else {}
        modules = iter(self.all_modules)
        temb = None
        if self.conditional:
            temb = next(modules)(get_timestep_embedding(labels, self.nf))
            temb = next(modules)(F.silu(temb))
        h = x if self.centered else 2 * x - 1.0
        stem = next(modules)
        hs = [conv2d_nhwc(h, stem.weight, stem.bias)]
        for i_level, res in enumerate(self.all_resolutions):
            for _ in range(self.num_res_blocks):
                h = next(modules)(hs[-1], temb, **kw)
                if res in self.attn_resolutions:
                    h = next(modules)(h)
                hs.append(h)
            if i_level != len(self.all_resolutions) - 1:
                hs.append(next(modules)(hs[-1]))

        h = next(modules)(hs[-1], temb, **kw)
        h = next(modules)(h)
        h = next(modules)(h, temb, **kw)

        for i_level in reversed(range(len(self.all_resolutions))):
            for _ in range(self.num_res_blocks + 1):
                h = next(modules)((h, hs.pop()), temb, **kw)
            if self.all_resolutions[i_level] in self.attn_resolutions:
                h = next(modules)(h)
            if i_level != 0:
                h = next(modules)(h)
        assert not hs

        h = F.silu(next(modules)(h))
        head = next(modules)
        h = conv2d_nhwc(h, head.weight, head.bias)
        if self.scale_by_sigma:
            h = h / self.sigmas[labels.long()].reshape(-1, 1, 1, 1)
        return h
