"""Model construction (port of diffpure_tpu/models/factories.py:21-98, the
model half of :233-257 and :259 ncsnpp_from_config).

``adm_from_config`` is the model half of JAX's
``create_model_and_diffusion``: the ADM from the defaults merged with a
YAML ``model:`` section. The Gaussian diffusion it also returns
(``diffusion/discrete.py``) waits for ROADMAP item 15; JAX's CLI discards
it (diffpure_tpu/cli.py:58), so the port's CLI needs the model only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from diffpure_tpu_torch.models.adm_unet import ADMUNet
from diffpure_tpu_torch.models.ncsnpp import NCSNpp


def ncsnpp_from_config(config, dtype=None) -> NCSNpp:
    """NCSNpp from a reference-style config namespace (``config.model`` /
    ``config.data``); unknown names fall back to the NCSNpp defaults."""
    m = config.model
    d = config.data
    g = lambda ns, k, default: getattr(ns, k, default)  # noqa: E731
    return NCSNpp(
        image_size=g(d, "image_size", 32),
        num_channels=g(d, "num_channels", 3),
        nf=g(m, "nf", 128),
        ch_mult=tuple(g(m, "ch_mult", (1, 2, 2, 2))),
        num_res_blocks=g(m, "num_res_blocks", 8),
        attn_resolutions=tuple(g(m, "attn_resolutions", (16,))),
        dropout=g(m, "dropout", 0.1),
        resamp_with_conv=g(m, "resamp_with_conv", True),
        conditional=g(m, "conditional", True),
        fir=g(m, "fir", False),
        fir_kernel=tuple(g(m, "fir_kernel", (1, 3, 3, 1))),
        skip_rescale=g(m, "skip_rescale", True),
        resblock_type=g(m, "resblock_type", "biggan"),
        progressive=g(m, "progressive", "none"),
        progressive_input=g(m, "progressive_input", "none"),
        progressive_combine=g(m, "progressive_combine", "sum"),
        embedding_type=g(m, "embedding_type", "positional"),
        fourier_scale=float(g(m, "fourier_scale", 16.0)),
        init_scale=g(m, "init_scale", 0.0),
        scale_by_sigma=g(m, "scale_by_sigma", False),
        centered=g(d, "centered", True),
        sigma_min=g(m, "sigma_min", 0.01),
        sigma_max=g(m, "sigma_max", 50.0),
        num_scales=g(m, "num_scales", 1000),
        dtype=dtype,
    )


def model_and_diffusion_defaults() -> dict:
    """ref script_util.py:51-74 (JAX :21)."""
    return dict(
        image_size=64, num_channels=128, num_res_blocks=2, num_heads=4,
        num_heads_upsample=-1, num_head_channels=-1, attention_resolutions="16,8",
        channel_mult="", dropout=0.0, class_cond=False, use_checkpoint=False,
        use_scale_shift_norm=True, resblock_updown=False, use_fp16=False,
        use_new_attention_order=False, learn_sigma=False, diffusion_steps=1000,
        noise_schedule="linear", timestep_respacing="", use_kl=False,
        predict_xstart=False, rescale_timesteps=False, rescale_learned_sigmas=False)


def adm_from_config(config: dict) -> ADMUNet:
    """The ADM of ``create_model_and_diffusion`` (ref script_util.py:82-136;
    JAX :233-257): the defaults merged with ``config`` (the YAML ``model:``
    section, ref runners/diffpure_sde.py:163-164), names it does not know
    ignored."""
    d = model_and_diffusion_defaults()
    d.update({k: v for k, v in config.items() if k in d})
    return create_model(
        image_size=d["image_size"], num_channels=d["num_channels"],
        num_res_blocks=d["num_res_blocks"], channel_mult=d["channel_mult"],
        learn_sigma=d["learn_sigma"], class_cond=d["class_cond"],
        use_checkpoint=d["use_checkpoint"],
        attention_resolutions=d["attention_resolutions"], num_heads=d["num_heads"],
        num_head_channels=d["num_head_channels"],
        num_heads_upsample=d["num_heads_upsample"],
        use_scale_shift_norm=d["use_scale_shift_norm"], dropout=d["dropout"],
        resblock_updown=d["resblock_updown"], use_fp16=d["use_fp16"],
        use_new_attention_order=d["use_new_attention_order"])


def channel_mult_for_image_size(image_size: int) -> Tuple[float, ...]:
    """ref script_util.py:156-168."""
    mults = {512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4),
             128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}
    if image_size not in mults:
        raise ValueError(f"unsupported image size: {image_size}")
    return mults[image_size]


def create_model(image_size: int, num_channels: int, num_res_blocks: int,
                 channel_mult: str = "", learn_sigma: bool = False,
                 class_cond: bool = False, use_checkpoint: bool = False,
                 attention_resolutions: str = "16", num_heads: int = 1,
                 num_head_channels: int = -1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False, dropout: float = 0.0,
                 resblock_updown: bool = False, use_fp16: bool = False,
                 use_new_attention_order: bool = False,
                 num_classes: Optional[int] = None) -> ADMUNet:
    """ref script_util.py:138-192; ``use_fp16`` gives a bf16 torso. As in
    JAX, ``use_flash`` is not passed, so a model built here never takes the
    flash kernel (``imagenet256_config`` does). ``use_checkpoint`` is a
    training-memory option with no effect on the eval forward."""
    if channel_mult == "":
        mult = channel_mult_for_image_size(image_size)
    else:
        mult = tuple(float(m) for m in channel_mult.split(","))
    attention_ds = tuple(image_size // int(res)
                         for res in attention_resolutions.split(","))
    return ADMUNet(
        image_size=image_size, in_channels=3, model_channels=num_channels,
        out_channels=(6 if learn_sigma else 3), num_res_blocks=num_res_blocks,
        attention_resolutions=attention_ds, dropout=dropout, channel_mult=mult,
        num_classes=(num_classes if class_cond else None), num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown,
        use_new_attention_order=use_new_attention_order,
        dtype=torch.bfloat16 if use_fp16 else None)
