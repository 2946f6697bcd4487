"""Model and diffusion construction (port of diffpure_tpu/models/factories.py;
ref guided_diffusion/script_util.py:27-460 and score_sde's create_model).

``adm_from_config`` is the model half of ``create_model_and_diffusion``
(JAX's CLI discards the diffusion, diffpure_tpu/cli.py:58, and so does the
port's). ``create_gaussian_diffusion`` is the one builder of a
``SpacedDiffusion`` from guided-diffusion's flags; the ImageNet
purification's process (``purify.runners.make_imagenet_diffusion``) is one
of its calls. The guidance classifier (``create_classifier``) and the
upsampler (``sr_create_model``) are built as JAX builds them: no class
conditioning and no flash attention.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from diffpure_tpu_torch.diffusion.discrete import ModelMeanType, ModelVarType, \
    SpacedDiffusion
from diffpure_tpu_torch.diffusion.schedules import get_named_beta_schedule, space_timesteps
from diffpure_tpu_torch.models.adm_unet import ADMUNet, EncoderUNetADM, SuperResADM
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


def create_gaussian_diffusion(*, steps: int = 1000, learn_sigma: bool = False,
                              sigma_small: bool = False, noise_schedule: str = "linear",
                              use_kl: bool = False, predict_xstart: bool = False,
                              rescale_timesteps: bool = False,
                              rescale_learned_sigmas: bool = False,
                              timestep_respacing="") -> SpacedDiffusion:
    """ref script_util.py:394-443 (JAX :101). ``use_kl`` and
    ``rescale_learned_sigmas`` choose the training loss only and are
    ignored, as in JAX; an empty respacing keeps all ``steps``."""
    betas = get_named_beta_schedule(noise_schedule, steps)
    if learn_sigma:
        var_type = ModelVarType.LEARNED_RANGE
    elif sigma_small:
        var_type = ModelVarType.FIXED_SMALL
    else:
        var_type = ModelVarType.FIXED_LARGE
    return SpacedDiffusion.from_original(
        betas, space_timesteps(steps, timestep_respacing or [steps]),
        model_mean_type=(ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON),
        model_var_type=var_type, rescale_timesteps=rescale_timesteps)


def classifier_defaults() -> dict:
    """ref script_util.py:27-42 (JAX :134)."""
    return dict(image_size=64, classifier_use_fp16=False, classifier_width=128,
                classifier_depth=2, classifier_attention_resolutions="32,16,8",
                classifier_use_scale_shift_norm=True, classifier_resblock_updown=True,
                classifier_pool="attention")


def create_classifier(image_size: int, classifier_use_fp16: bool, classifier_width: int,
                      classifier_depth: int, classifier_attention_resolutions: str,
                      classifier_use_scale_shift_norm: bool,
                      classifier_resblock_updown: bool,
                      classifier_pool: str) -> EncoderUNetADM:
    """The noise-conditioned guidance classifier (ref script_util.py:236-275;
    JAX :148): 1000 classes, heads of 64 channels; ``classifier_use_fp16``
    gives a bf16 torso."""
    attention_ds = tuple(image_size // int(res)
                         for res in classifier_attention_resolutions.split(","))
    return EncoderUNetADM(
        image_size=image_size, in_channels=3, model_channels=classifier_width,
        out_channels=1000, num_res_blocks=classifier_depth,
        attention_resolutions=attention_ds,
        channel_mult=channel_mult_for_image_size(image_size), num_head_channels=64,
        use_scale_shift_norm=classifier_use_scale_shift_norm,
        resblock_updown=classifier_resblock_updown, pool=classifier_pool,
        dtype=torch.bfloat16 if classifier_use_fp16 else None)


def _diffusion_of(d: dict) -> SpacedDiffusion:
    return create_gaussian_diffusion(
        steps=d.get("diffusion_steps", 1000), learn_sigma=d.get("learn_sigma", False),
        noise_schedule=d.get("noise_schedule", "linear"), use_kl=d.get("use_kl", False),
        predict_xstart=d.get("predict_xstart", False),
        rescale_timesteps=d.get("rescale_timesteps", False),
        rescale_learned_sigmas=d.get("rescale_learned_sigmas", False),
        timestep_respacing=d.get("timestep_respacing", ""))


def create_classifier_and_diffusion(**kwargs):
    """ref script_util.py:195-233 (JAX :169): the classifier from
    ``classifier_defaults`` updated by ``kwargs``, and its diffusion."""
    classifier = create_classifier(**{k: kwargs.get(k, v)
                                      for k, v in classifier_defaults().items()})
    return classifier, _diffusion_of(kwargs)


def sr_create_model(large_size: int, small_size: int, **kwargs) -> SuperResADM:
    """The upsampler (ref script_util.py:278-340; JAX :184): the model
    defaults updated by ``kwargs`` (names it does not know ignored), 6
    input channels. As in JAX, no class conditioning and none of the
    defaults' ``num_heads_upsample`` / ``use_new_attention_order``."""
    del small_size  # the low-resolution input's size is the caller's
    d = model_and_diffusion_defaults()
    d.update({k: v for k, v in kwargs.items() if k in d})
    if large_size in (256, 512):
        mult = (1, 1, 2, 2, 4, 4)
    elif large_size == 64:
        mult = (1, 2, 3, 4)
    else:
        raise ValueError(f"unsupported large size: {large_size}")
    attention_ds = tuple(large_size // int(res) for res in d["attention_resolutions"].split(","))
    return SuperResADM(
        image_size=large_size, in_channels=6, model_channels=d["num_channels"],
        out_channels=(6 if d["learn_sigma"] else 3), num_res_blocks=d["num_res_blocks"],
        attention_resolutions=attention_ds, dropout=d["dropout"], channel_mult=mult,
        num_heads=d["num_heads"], num_head_channels=d["num_head_channels"],
        use_scale_shift_norm=d["use_scale_shift_norm"],
        resblock_updown=d["resblock_updown"],
        dtype=torch.bfloat16 if d["use_fp16"] else None)


def sr_model_and_diffusion_defaults() -> dict:
    """ref script_util.py:278-292 (JAX :218)."""
    d = model_and_diffusion_defaults()
    d.update(large_size=256, small_size=64)
    d.pop("image_size")
    return d


def sr_create_model_and_diffusion(config: dict):
    """ref script_util.py:294-340 (JAX :226)."""
    d = sr_model_and_diffusion_defaults()
    d.update({k: v for k, v in config.items() if k in d})
    large, small = d.pop("large_size"), d.pop("small_size")
    return sr_create_model(large, small, **d), _diffusion_of(d)


def create_model_and_diffusion(config: dict):
    """ref script_util.py:82-136 (JAX :245): the ADM and its diffusion from
    the defaults merged with ``config``."""
    d = model_and_diffusion_defaults()
    d.update({k: v for k, v in config.items() if k in d})
    return adm_from_config(d), _diffusion_of(d)
