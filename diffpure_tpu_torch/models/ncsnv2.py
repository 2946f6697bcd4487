"""NCSNv2 and NCSN, the RefineNet score networks (port of
diffpure_tpu/models/ncsnv2.py; ref score_sde/models/ncsnv2.py:43-415).

``NCSNv2`` (registered ``ncsnv2_64``: 4 residual stages, 4 refine blocks,
for images under 96 px), the class-conditional NCSNv1 ``NCSN`` (``ncsn``),
``NCSNv2_128`` and ``NCSNv2_256`` (5 and 6 stages), and ``get_network``'s
image-size dispatch. Input and output are NHWC and fp32; ``labels`` are the
noise-level indices (the VE SDE's discrete labels, diffusion/score.py),
and with ``scale_by_sigma`` the output is divided by sigma at the label.
Module names are score_sde's, with its ``sigmas`` buffer, so a score_sde
state dict loads as it is (models/convert.translate_ncsnv2). Plain
PyTorch on either device: no kernel of the JAX package is on this path.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.models.legacy_layers import CondRefineBlock, \
    ConditionalResidualBlock, RefineBlock, ResidualBlock, conv_nhwc, ncsn_conv3x3
from diffpure_tpu_torch.models.ncsnpp import get_sigmas
from diffpure_tpu_torch.models.normalization import ConditionalInstanceNorm2dPlus, \
    InstanceNorm2dPlus
from diffpure_tpu_torch.models.registry import register_model

Tensor = torch.Tensor


def get_network(image_size: int) -> type:
    """The NCSNv2 class for an image size (ref ncsnv2.py:30-40)."""
    if image_size < 96:
        return NCSNv2
    if 96 <= image_size <= 128:
        return NCSNv2_128
    if 128 < image_size <= 256:
        return NCSNv2_256
    raise NotImplementedError(f"no NCSNv2 for {image_size} px images")


class _NCSNv2Base(nn.Module):
    """The stem conv, the residual pyramid (``stages``: (width multiple,
    resample, dilation) pairs of blocks), the refine cascade and the head
    shared by the four networks."""

    conditional = False

    def __init__(self, stages, refine, image_size: int = 64, channels: int = 3,
                 nf: int = 128, centered: bool = False, scale_by_sigma: bool = True,
                 sigma_min: float = 0.01, sigma_max: float = 50.0, num_scales: int = 1000,
                 act: Callable = F.elu):
        super().__init__()
        self.centered, self.scale_by_sigma, self.act = centered, scale_by_sigma, act
        self.register_buffer("sigmas", torch.tensor(
            get_sigmas(sigma_min, sigma_max, num_scales), dtype=torch.float32))
        # the blocks pass num_classes to a conditional norm themselves
        norm = ConditionalInstanceNorm2dPlus if self.conditional else InstanceNorm2dPlus
        self.begin_conv = ncsn_conv3x3(channels, nf)
        self.normalizer = norm(nf, num_scales) if self.conditional else norm(nf)
        self.end_conv = ncsn_conv3x3(nf, channels)
        self.stage_names = [name for name, *_ in stages]
        in_ch = nf
        for name, mult, resample, dilation in stages:
            out = mult * nf
            adjust = name == "res4" and image_size == 28
            kw = dict(act=act, normalization=norm, dilation=dilation)
            if self.conditional:
                first = ConditionalResidualBlock(in_ch, out, num_scales, resample=resample,
                                                 adjust_padding=adjust, **kw)
                second = ConditionalResidualBlock(out, out, num_scales, **kw)
            else:
                first = ResidualBlock(in_ch, out, resample=resample, adjust_padding=adjust,
                                      **kw)
                second = ResidualBlock(out, out, **kw)
            setattr(self, name, nn.ModuleList([first, second]))
            in_ch = out
        self.refine_names = [name for name, *_ in refine]
        for name, in_mults, mult, start, end in refine:
            planes = [m * nf for m in in_mults]
            if self.conditional:
                block = CondRefineBlock(planes, mult * nf, num_scales, norm, act=act,
                                        start=start, end=end)
            else:
                block = RefineBlock(planes, mult * nf, act=act, start=start, end=end)
            setattr(self, name, block)

    def forward(self, x: Tensor, labels: Tensor) -> Tensor:
        y = (labels.long(),) if self.conditional else ()
        h = x if self.centered else 2 * x - 1.0
        h = conv_nhwc(self.begin_conv, h)
        levels = []
        for name in self.stage_names:
            for block in getattr(self, name):
                h = block(h, *y)
            levels.append(h)
        # the cascade runs from the deepest level up: refine1 takes it
        # alone, each later block the next level up and the block before
        out = None
        for name, level in zip(self.refine_names, reversed(levels)):
            xs = [level] if out is None else [level, out]
            out = getattr(self, name)(xs, *y, tuple(level.shape[1:3]))
        out = conv_nhwc(self.end_conv, self.act(self.normalizer(out, *y)))
        if self.scale_by_sigma:
            out = out / self.sigmas[labels.long()].reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return out.contiguous()


# (name, width multiple, resample, dilation) per stage; (name, input width
# multiples, width multiple, start, end) per refine block
_STAGES_64 = (("res1", 1, None, 1), ("res2", 2, "down", 1), ("res3", 2, "down", 2),
              ("res4", 2, "down", 4))
_REFINE_64 = (("refine1", (2,), 2, True, False), ("refine2", (2, 2), 2, False, False),
              ("refine3", (2, 2), 1, False, False), ("refine4", (1, 1), 1, False, True))


@register_model(name="ncsnv2_64")
class NCSNv2(_NCSNv2Base):
    """ref ncsnv2.py:43-132 (JAX :68)."""

    def __init__(self, **kw):
        super().__init__(_STAGES_64, _REFINE_64, **kw)


@register_model(name="ncsn")
class NCSN(_NCSNv2Base):
    """The conditional NCSNv1 (ref ncsnv2.py:135-218, JAX :108): every norm
    looks its scales up by the noise-level index."""

    conditional = True

    def __init__(self, **kw):
        super().__init__(_STAGES_64, _REFINE_64, **kw)


@register_model(name="ncsnv2_128")
class NCSNv2_128(_NCSNv2Base):
    """ref ncsnv2.py:221-312 (JAX :151): 5 stages."""

    def __init__(self, **kw):
        super().__init__(
            (("res1", 1, None, 1), ("res2", 2, "down", 1), ("res3", 2, "down", 1),
             ("res4", 4, "down", 2), ("res5", 4, "down", 4)),
            (("refine1", (4,), 4, True, False), ("refine2", (4, 4), 2, False, False),
             ("refine3", (2, 2), 2, False, False), ("refine4", (2, 2), 1, False, False),
             ("refine5", (1, 1), 1, False, True)), **kw)


@register_model(name="ncsnv2_256")
class NCSNv2_256(_NCSNv2Base):
    """ref ncsnv2.py:315-415 (JAX :193): 6 stages."""

    def __init__(self, **kw):
        super().__init__(
            (("res1", 1, None, 1), ("res2", 2, "down", 1), ("res3", 2, "down", 1),
             ("res31", 2, "down", 1), ("res4", 4, "down", 2), ("res5", 4, "down", 4)),
            (("refine1", (4,), 4, True, False), ("refine2", (4, 4), 2, False, False),
             ("refine31", (2, 2), 2, False, False), ("refine3", (2, 2), 2, False, False),
             ("refine4", (2, 2), 1, False, False), ("refine5", (1, 1), 1, False, True)),
            **kw)
