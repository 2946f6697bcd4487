"""Exponential moving average of a module's parameters (port of
diffpure_tpu/models/ema.py; ref score_sde/models/ema.py:18-105).

``update`` / ``copy_to`` / ``store`` / ``restore`` and a state dict of
(decay, num_updates, shadow_params), as the score_sde checkpoints hold it.
The shadow is a list of tensors in ``module.parameters()`` order.

Every write into a parameter goes through an in-place op on the parameter
itself (``p.copy_`` under ``torch.no_grad()``), never through ``p.data``:
the in-place op bumps the tensor's version counter, which is what the block
layers' kernel-layout packs are keyed by (models/layers.py ``_stamp``). A
write through ``p.data`` would leave the kernels on the old weights.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

Tensor = torch.Tensor


def _params(params) -> List[Tensor]:
    return list(params.parameters()) if isinstance(params, nn.Module) else list(params)


class ExponentialMovingAverage:
    """shadow <- shadow - (1 - decay) (shadow - params), with the
    min(decay, (1 + n) / (10 + n)) warmup when ``use_num_updates``."""

    def __init__(self, params, decay: float = 0.9999, use_num_updates: bool = True):
        if not 0.0 <= decay <= 1.0:
            raise ValueError(f"decay {decay} is not in [0, 1]")
        self.decay = decay
        self.num_updates: Optional[int] = 0 if use_num_updates else None
        self.shadow_params = [p.detach().clone() for p in _params(params)]

    @torch.no_grad()
    def update(self, params) -> None:
        """ref ema.py:35-48 (JAX ema.py:35)."""
        if self.num_updates is None:
            one_minus = 1.0 - self.decay
        else:
            # float32, as JAX forms it from its int32 counter
            self.num_updates += 1
            n = np.float32(self.num_updates)
            decay = min(np.float32(self.decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))
            one_minus = float(np.float32(1.0) - decay)
        params = [p.detach() for p in _params(params)]
        diff = torch._foreach_sub(self.shadow_params, params)
        torch._foreach_mul_(diff, one_minus)
        torch._foreach_sub_(self.shadow_params, diff)

    @torch.no_grad()
    def copy_to(self, params) -> None:
        """Load the averages into ``params`` (ref ema.py:50-58)."""
        for p, s in zip(_params(params), self.shadow_params, strict=True):
            p.copy_(s)

    def store(self, params) -> None:
        """Keep a copy of ``params`` to ``restore`` later (ref ema.py:60-68)."""
        self.collected_params = [p.detach().clone() for p in _params(params)]

    @torch.no_grad()
    def restore(self, params) -> None:
        """Put the stored parameters back (ref ema.py:70-80)."""
        for p, s in zip(_params(params), self.collected_params, strict=True):
            p.copy_(s)

    def state_dict(self) -> dict:
        return dict(decay=self.decay, num_updates=self.num_updates,
                    shadow_params=self.shadow_params)

    def load_state_dict(self, state: dict) -> None:
        self.decay = state["decay"]
        self.num_updates = state.get("num_updates")
        shadow = list(state["shadow_params"])
        if len(shadow) != len(self.shadow_params):
            raise ValueError(f"{len(shadow)} shadow tensors for "
                             f"{len(self.shadow_params)} parameters")
        self.shadow_params = [s.detach().clone().to(o.device, o.dtype)
                              for s, o in zip(shadow, self.shadow_params)]
