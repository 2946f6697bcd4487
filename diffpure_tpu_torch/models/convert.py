"""flax params -> PyTorch state dict: the inverse of
diffpure_tpu/models/convert.py (``_leaf`` :73, ``ncsnpp_key`` :107,
``translate_ncsnpp`` :182, ``translate_adm`` :195, ``translate_ncsnv2``
:218), so weights held by the JAX package load into the port with
``load_state_dict(strict=True)``. The score_sde DDPM's tree has NCSN++'s
``m{i}`` walk (``translate_ncsnpp`` carries it too), and so has NCSN++'s
with every option: the Fourier projection's ``W``, ``FIRConv2d``'s HWIO
``kernel``, ``Combine``'s ``Conv_0`` and the pyramids' convs and norms are
leaves of ``m{i}`` modules (the pyramids' resamplers without a conv hold
none).

Leaves: conv kernel HWIO -> weight OIHW; Dense kernel (in, out) -> weight
(out, in); norm ``scale`` -> ``weight``; NIN ``W``/``b`` unchanged.

The guided-diffusion checkpoint (JAX :259) and the SDEdit CelebA-HQ one
(JAX :263) are flat state dicts in the port's own ADM and DDPM-UNet keys:
``load_guided_diffusion_checkpoint`` and ``load_sdedit_checkpoint`` check
them. ``ddpm_unet_state_dict_from_flax`` is the inverse of ``translate_ddpm``
(JAX :208).

The score_sde checkpoint flow (JAX :28-71, :250): a CIFAR-10
``checkpoint_8.pth`` holds the model's state dict (``module.``-prefixed
under DataParallel) and its EMA shadow parameters; the port's NCSN++ keys
are score_sde's, so the flow ends in a state dict, with no translation.
NCSNv2's keys are score_sde's too: ``translate_ncsnv2`` takes a score_sde
state dict to the port's module by a check of its keys and shapes, and
``ncsnv2_state_dict_from_flax`` is the inverse of JAX's translator.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from diffpure_tpu_torch.models.ncsnpp import get_sigmas


def load_torch_state_dict(path: str):
    """Unpickle a PyTorch checkpoint onto the CPU (a file of the model's
    own publisher: unpickling runs code, as the reference's loader does)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def strip_module_prefix(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop DataParallel 'module.' prefixes (ref utils.py:119-127)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def apply_ema(model_sd: Mapping[str, torch.Tensor], ema_state: Mapping,
              buffer_keys: Tuple[str, ...] = ("sigmas",),
              frozen_keys: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """Overwrite the parameters with the EMA shadow parameters, a flat list
    in ``model.parameters()`` order: the state dict's order without its
    buffers (ref score_sde/models/ema.py:18-105). score_sde's EMA keeps
    only the parameters that require grad: a shadow list shorter by
    ``frozen_keys`` skips them (the port's EMA keeps every parameter)."""
    shadow = list(ema_state["shadow_params"])
    param_keys = [k for k in model_sd
                  if not any(k == b or k.endswith("." + b) for b in buffer_keys)]
    if len(param_keys) != len(shadow):
        param_keys = [k for k in param_keys if k not in frozen_keys]
    if len(param_keys) != len(shadow):
        raise ValueError(f"{len(shadow)} EMA shadow parameters for "
                         f"{len(param_keys)} model parameters")
    out = dict(model_sd)
    for k, p in zip(param_keys, shadow):
        p = torch.as_tensor(p)
        if tuple(out[k].shape) != tuple(p.shape):
            raise ValueError(f"EMA shadow of {k} has shape {tuple(p.shape)}, "
                             f"the model {tuple(out[k].shape)}")
        out[k] = p
    return out


def load_score_sde_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """score_sde checkpoint -> the port's NCSN++ state dict: load, strip the
    prefix, apply the EMA (ref runners/diffpure_sde.py:160-190)."""
    state = load_torch_state_dict(path)
    sd = strip_module_prefix(state["model"])
    # the VE NCSN++'s Fourier projection W is frozen (1-D; NIN's W are 2-D)
    frozen = tuple(k for k, v in sd.items() if k.rsplit(".", 1)[-1] == "W" and v.ndim == 1)
    return apply_ema(sd, state["ema"], frozen_keys=frozen)


def _check_fits(sd: Mapping, model: torch.nn.Module, path: str, what: str) -> None:
    """Raise unless ``sd`` has exactly ``model``'s keys and shapes."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(torch.as_tensor(v).shape) for k, v in sd.items()}
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    shapes = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing or extra or shapes:
        raise ValueError(
            f"{path} does not fit the {what}: missing {missing[:5]} ({len(missing)}), "
            f"unexpected {extra[:5]} ({len(extra)}), shapes differ at "
            f"{[(k, got[k], want[k]) for k in shapes[:5]]} ({len(shapes)})")


def load_guided_diffusion_checkpoint(path: str, model: torch.nn.Module
                                     ) -> Dict[str, torch.Tensor]:
    """A guided-diffusion checkpoint (``256x256_diffusion_uncond.pt``, a
    flat state dict) -> the port's ADM state dict (JAX :259). The port's
    keys are guided-diffusion's, so nothing is translated; the keys and
    shapes are checked against ``model`` before anything loads."""
    sd = load_torch_state_dict(path)
    _check_fits(sd, model, path, "ADM")
    return dict(sd)


def load_sdedit_checkpoint(path: str, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The SDEdit CelebA-HQ checkpoint (``celeba_hq.ckpt``, a flat state
    dict, ``module.``-prefixed under DataParallel) -> the port's
    ``DDPMUNet`` state dict (JAX :263); the keys are SDEdit's, checked
    against ``model``."""
    sd = strip_module_prefix(load_torch_state_dict(path))
    _check_fits(sd, model, path, "DDPM UNet")
    return sd


def flatten_params(tree: Mapping, prefix: Tuple[str, ...] = ()
                   ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    """(path, leaf) pairs of a nested params dict, ``{'params': ...}`` or bare."""
    if prefix == () and set(tree) == {"params"}:
        tree = tree["params"]
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from flatten_params(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def torch_leaf(name: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    """Inverse of the JAX ``_leaf``: flax (leaf, array) -> torch (leaf, array)."""
    if name == "kernel":
        if v.ndim == 4:
            return "weight", v.transpose(3, 2, 0, 1)
        if v.ndim == 2:
            return "weight", v.transpose(1, 0)
    if name == "scale":
        return "weight", v
    if name in ("bias", "W", "b"):
        return name, v
    raise ValueError(f"unhandled flax leaf {name} with shape {v.shape}")


def to_tensor(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(v, order="C", copy=True))


def _all_modules_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """``m{i}/...`` -> ``all_modules.{i}....`` (the score_sde module walk of
    NCSN++, in either block type, and of the DDPM)."""
    sd = {}
    for path, v in flatten_params(params):
        head, *mods, leaf = path
        if not head.startswith("m") or not head[1:].isdigit():
            raise ValueError(f"unexpected score_sde param path {'/'.join(path)}")
        name, arr = torch_leaf(leaf, v)
        sd[".".join(["all_modules", head[1:], *mods, name])] = to_tensor(arr)
    return sd


def _sigmas(sigma_min: float, sigma_max: float, num_scales: int) -> torch.Tensor:
    return torch.tensor(get_sigmas(sigma_min, sigma_max, num_scales), dtype=torch.float32)


def ncsnpp_state_dict_from_flax(params: Mapping, *, sigma_min: float = 0.01,
                                sigma_max: float = 50.0,
                                num_scales: int = 1000
                                ) -> Dict[str, torch.Tensor]:
    """NCSN++ (``resblock_type`` 'biggan' or 'ddpm'). The ``sigmas`` buffer,
    which the JAX translator drops, is rebuilt from the model's noise scales."""
    sd = _all_modules_state_dict(params)
    sd["sigmas"] = _sigmas(sigma_min, sigma_max, num_scales)
    return sd


def ddpm_state_dict_from_flax(params: Mapping, *, scale_by_sigma: bool = False,
                              sigma_min: float = 0.01, sigma_max: float = 50.0,
                              num_scales: int = 1000) -> Dict[str, torch.Tensor]:
    """The score_sde DDPM (``models/ddpm_v1.DDPM``); it holds a ``sigmas``
    buffer only with ``scale_by_sigma``."""
    sd = _all_modules_state_dict(params)
    if scale_by_sigma:
        sd["sigmas"] = _sigmas(sigma_min, sigma_max, num_scales)
    return sd


_MERGED = re.compile(r"^(.+?)((?:_\d+)+)$")


def split_module(name: str):
    """'input_blocks_4_0' -> ['input_blocks', '4', '0']: undo the JAX
    translators' merge of a module name with the digits after it."""
    m = _MERGED.match(name)
    if m is None:
        return [name]
    return [m.group(1)] + m.group(2).lstrip("_").split("_")


# ADM modules that are conv1d in guided-diffusion and Dense in flax (the
# attention blocks' and the classifier's AttentionPool2d's)
_CONV1D = ("qkv", "proj_out", "qkv_proj", "c_proj")


def adm_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ADM params -> the port's (guided-diffusion's) state dict: the
    UNet, the upsampler (the UNet's tree with 6 input channels) and the
    guidance classifier. The inverse of ``translate_adm``
    (diffpure_tpu/models/convert.py:195) on the UNet. Dense kernels (in,
    out) of ``_CONV1D`` become conv1d (out, in, 1), ``label_emb/embedding``
    becomes ``label_emb.weight``, the attention pool's
    ``positional_embedding`` (T, C) becomes guided-diffusion's (C, T), and
    the adaptive pool's 1x1 conv, flax's ``out_2``, guided-diffusion's
    ``out.3`` (its ``out.2`` is the parameterless AdaptiveAvgPool2d)."""
    flat = list(flatten_params(params))
    # a classifier (no output blocks) whose out_2 is a conv: the adaptive pool
    adaptive = not any(path[0].startswith("output_blocks") for path, _ in flat) and any(
        path[-2:] == ("out_2", "kernel") and v.ndim == 4 for path, v in flat)
    sd = {}
    for path, v in flat:
        *mods, leaf = path
        parts = [p for m in mods for p in split_module(m)]
        if adaptive and parts == ["out", "2"]:
            parts = ["out", "3"]
        key = ".".join(parts)
        if leaf == "embedding":
            name, arr = "weight", v
        elif leaf == "positional_embedding":
            name, arr = leaf, v.transpose(1, 0)
        elif leaf == "kernel" and v.ndim == 2 and mods[-1] in _CONV1D:
            name, arr = "weight", v.transpose(1, 0)[:, :, None]
        else:
            name, arr = torch_leaf(leaf, v)
        sd[f"{key}.{name}"] = to_tensor(arr)
    return sd


_DDPM_OUTER = ((re.compile(r"^(down|up)_(\d+)_(block|attn)_(\d+)$"), r"\1.\2.\3.\4"),
               (re.compile(r"^(down|up)_(\d+)_(downsample|upsample)_conv$"), r"\1.\2.\3.conv"),
               (re.compile(r"^mid_(block_1|block_2|attn_1)$"), r"mid.\1"),
               (re.compile(r"^temb_dense_(\d+)$"), r"temb.dense.\1"))


def ddpm_unet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``DDPMUNet`` params -> the SDEdit state dict: the inverse of
    ``translate_ddpm`` / ``ddpm_key`` (diffpure_tpu/models/convert.py:148,
    :208): ``down_0_block_1/norm1`` -> ``down.0.block.1.norm1``,
    ``up_3_upsample_conv`` -> ``up.3.upsample.conv``, ``mid_attn_1/q`` ->
    ``mid.attn_1.q``, ``temb_dense_0`` -> ``temb.dense.0``."""
    sd = {}
    for path, v in flatten_params(params):
        head, *mods, leaf = path
        for pat, rep in _DDPM_OUTER:
            if pat.match(head):
                head = pat.sub(rep, head)
                break
        name, arr = torch_leaf(leaf, v)
        sd[".".join([head, *mods, name])] = to_tensor(arr)
    return sd


def translate_ncsnv2(sd: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A score_sde NCSNv2 / NCSN state dict (``module.``-prefixed or not)
    -> the port's ``model`` (models/ncsnv2.py), whose keys are score_sde's:
    the counterpart of JAX's ``translate_ncsnv2`` (:218). Nothing is
    renamed or transposed; the keys and shapes are checked against
    ``model`` first."""
    sd = {k: torch.as_tensor(v) for k, v in strip_module_prefix(sd).items()}
    _check_fits(sd, model, "the state dict", type(model).__name__)
    return sd


def ncsnv2_state_dict_from_flax(params: Mapping, *, sigma_min: float = 0.01,
                                sigma_max: float = 50.0,
                                num_scales: int = 1000) -> Dict[str, torch.Tensor]:
    """flax NCSNv2 / NCSN params -> the port's state dict: the inverse of
    JAX's ``translate_ncsnv2``. ``res1_0/normalize1/alpha`` ->
    ``res1.0.normalize1.alpha``, ``refine1/adapt_convs_0/1_1_conv/kernel``
    -> ``refine1.adapt_convs.0.1_1_conv.weight``, a conditional norm's
    ``embed/embedding`` (num_classes, chunks * C) -> ``embed.weight``
    untransposed; the ``sigmas`` buffer is rebuilt from the noise scales."""
    sd = {}
    for path, v in flatten_params(params):
        *mods, leaf = path
        if leaf == "embedding":
            name, arr = "weight", v
        elif leaf in ("alpha", "gamma", "beta"):
            name, arr = leaf, v
        else:
            name, arr = torch_leaf(leaf, v)
        sd[".".join([p for m in mods for p in split_module(m)] + [name])] = to_tensor(arr)
    sd["sigmas"] = _sigmas(sigma_min, sigma_max, num_scales)
    return sd
