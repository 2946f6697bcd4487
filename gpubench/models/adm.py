"""guided-diffusion's ADM UNet: the program's ``ADMUNet`` and the reference's,
from one set of widths. Both take images in [-1, 1] and integer steps."""
from __future__ import annotations

import torch


def port(args: dict, dtype: torch.dtype):
    from diffpure_tpu_torch.models.adm_unet import ADMUNet
    with torch.device("meta"):
        return ADMUNet(**args, dtype=None if dtype == torch.float32 else dtype)


def reference(args: dict):
    from gpubench.reference.adm import ADMUNet
    with torch.device("meta"):
        return ADMUNet(**{k: v for k, v in args.items() if k != "use_flash"})


def fixed(args: dict) -> dict:
    return {}
