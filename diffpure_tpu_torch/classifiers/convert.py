"""flax params -> PyTorch state dict for the classifiers: the inverse of
diffpure_tpu/classifiers/convert.py (``_classifier_leaf`` :35,
``translate_classifier`` :54, ``translate_attribute_d`` :92,
``translate_vit`` :103); and ``attribute_state_dict``, the CelebA-HQ
attribute net's ``net_best.pth`` keys as the port's model takes them."""
from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from diffpure_tpu_torch.models.convert import flatten_params, split_module, \
    strip_module_prefix, to_tensor

_BN_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _classifier_state_dict(params: Mapping, split=split_module) -> Dict[str, torch.Tensor]:
    """The inverse of ``translate_classifier`` (JAX convert.py:54): module
    names through ``split`` (the digit merge undone), conv kernels HWIO ->
    OIHW, Dense kernels transposed, norm ``scale`` -> ``weight``, BN
    ``mean``/``var`` -> ``running_mean``/``running_var`` (plus the
    ``num_batches_tracked`` counter that PyTorch BatchNorm keys carry)."""
    sd = {}
    for path, v in flatten_params(params):
        *mods, leaf = path
        prefix = ".".join(p for m in mods for p in split(m))
        if leaf == "kernel":
            name, arr = "weight", (v.transpose(3, 2, 0, 1) if v.ndim == 4
                                   else v.transpose(1, 0))
        elif leaf == "scale":
            name, arr = "weight", v
        elif leaf in _BN_LEAVES:
            name, arr = _BN_LEAVES[leaf], v
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "bias":
            name, arr = "bias", v
        else:
            raise ValueError(f"unhandled classifier leaf {'/'.join(path)}")
        sd[f"{prefix}.{name}"] = to_tensor(arr)
    return sd


def wideresnet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """TRADES WideResNet at any depth and width (WRN-28-10, WRN-70-16 with
    dropout): ``block1/layer_10/bn1/scale`` -> ``block1.layer.10.bn1.weight``
    (JAX ``translate_wideresnet``)."""
    return _classifier_state_dict(params)


# torchvision ResNets: ``layer1_0/downsample_0`` -> ``layer1.0.downsample.0``;
# the CIFAR ResNet-50: ``layer1_0/shortcut_0`` -> ``layer1.0.shortcut.0``
# (JAX ``translate_torchvision_resnet``, ``translate_cifar_resnet``)
torchvision_resnet_state_dict_from_flax = wideresnet_state_dict_from_flax
cifar_resnet_state_dict_from_flax = wideresnet_state_dict_from_flax

# robustbench DMWideResNet's own names that end in a digit
_DM_NAMES = ("batchnorm_0", "batchnorm_1", "conv_0", "conv_1")


def dm_wideresnet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """robustbench DMWideResNet (JAX ``translate_dm_wideresnet``):
    ``layer_0/block_3/batchnorm_0/scale`` -> ``layer.0.block.3.batchnorm_0.weight``;
    the block's ``batchnorm_i`` / ``conv_i`` keep their underscore."""
    return _classifier_state_dict(
        params, lambda m: [m] if m in _DM_NAMES else split_module(m))


def vit_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of ``translate_vit`` (diffpure_tpu/classifiers/convert.py
    :103): ``patch_embed_proj`` -> ``patch_embed.proj``, ``blocks_3`` ->
    ``blocks.3``, ``mlp_fc1`` -> ``mlp.fc1``; LayerNorm ``scale`` ->
    ``weight``; ``cls_token`` and ``pos_embed`` stay top level."""
    sd = {}
    for path, v in flatten_params(params):
        *mods, leaf = path
        if not mods:
            sd[leaf] = to_tensor(v)
            continue
        parts = []
        for m in mods:
            if m == "patch_embed_proj":
                parts += ["patch_embed", "proj"]
            elif re.fullmatch(r"mlp_fc\d", m):
                parts += ["mlp", m[4:]]
            else:
                parts += split_module(m)
        if leaf == "kernel":
            name, arr = "weight", (v.transpose(3, 2, 0, 1) if v.ndim == 4
                                   else v.transpose(1, 0))
        elif leaf in ("scale", "bias"):
            name, arr = ("weight" if leaf == "scale" else "bias"), v
        else:
            raise ValueError(f"unhandled ViT leaf {'/'.join(path)}")
        sd[".".join(parts + [name])] = to_tensor(arr)
    return sd


# the attribute net's constant buffers, which its checkpoint may hold and the
# model does not (JAX convert.py:19 ``SKIP_KEYS``)
ATTRIBUTE_BUFFERS = ("mean", "std", "mu", "sigma", "lod_in")


def attribute_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A reference attribute-net state dict (``net_best.pth``) -> the port's
    ``AttributeD`` keys, which are the reference's: ``module.`` stripped,
    its top-level constant buffers and ``num_batches_tracked`` dropped."""
    return {k: torch.as_tensor(v) for k, v in strip_module_prefix(sd).items()
            if k not in ATTRIBUTE_BUFFERS and not k.endswith("num_batches_tracked")}


def attribute_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of ``translate_attribute_d``: ``block_256x256`` ->
    ``256x256``, a WScale layer's ``b`` -> ``wscale.b``, conv kernels HWIO
    -> OIHW, Dense kernels transposed."""
    sd = {}
    for path, v in flatten_params(params):
        *mods, leaf = path
        parts = [m[len("block_"):] if re.fullmatch(r"block_\d+x\d+", m) else m for m in mods]
        if leaf == "b":
            name, arr = "wscale.b", v
        elif leaf == "kernel":
            name, arr = "weight", (v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.transpose(1, 0))
        else:
            raise ValueError(f"unhandled attribute-net leaf {'/'.join(path)}")
        sd[".".join(parts + [name])] = to_tensor(arr)
    return sd
