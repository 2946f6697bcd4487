"""score_sde's NCSN++: the program's ``NCSNpp`` and the reference's, from one
set of widths. Both take NHWC / NCHW images in [-1, 1] and labels t * 999."""
from __future__ import annotations

import numpy as np
import torch


def port(args: dict, dtype: torch.dtype):
    from diffpure_tpu_torch.models.ncsnpp import NCSNpp
    with torch.device("meta"):
        return NCSNpp(**args, dtype=None if dtype == torch.float32 else dtype)


def reference(args: dict):
    from gpubench.reference.ncsnpp import NCSNpp
    with torch.device("meta"):
        return NCSNpp(**args)


def fixed(args: dict) -> dict:
    """The noise scales buffer (unused by the VP model, kept by both)."""
    s = np.exp(np.linspace(np.log(args.get("sigma_max", 50.0)),
                           np.log(args.get("sigma_min", 0.01)), args.get("num_scales", 1000)))
    return {"sigmas": torch.tensor(s, dtype=torch.float32)}
