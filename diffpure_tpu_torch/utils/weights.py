"""Seeded random weights for parity checks and smoke runs.

Flax's init of NCSN++ gives the second conv and the attention output NIN
weights of about 1e-10 (``init_scale=0``), which would make a check of
those layers pass whatever they compute. These draws give every layer
weight to carry: numpy N(0, 1) / sqrt(fan_in) for weight matrices and
kernels, 1 + 0.1 N for norm scales, 0.1 N for biases.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch.nn as nn

_KEEP = ("num_batches_tracked", "sigmas")


def seeded_normal_state_dict(module: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """A full state dict for ``module`` (float32 numpy), deterministic in
    ``seed`` and the module's key order."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in module.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if leaf in _KEEP:
            out[key] = t.detach().cpu().numpy()
        elif leaf == "running_var":
            out[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif leaf == "weight" and len(shape) == 1:  # norm scale
            out[key] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif len(shape) == 1:  # biases, NIN b, BN running_mean
            out[key] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            # NIN W is (in, out); conv and Linear weights are (out, in, ...)
            fan_in = shape[0] if leaf == "W" else int(np.prod(shape[1:]))
            out[key] = (rng.standard_normal(shape, dtype=np.float32)
                        / np.float32(np.sqrt(fan_in)))
    return out
