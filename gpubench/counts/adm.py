"""The ADM's blocks (counts/blocks.py) and its hand-written kernels (#6
GroupNorm statistics, #7 GroupNorm + FiLM + SiLU apply, #8 the halo
GN+SiLU+conv3x3, #9 flash attention). The count is of every block, on
whichever route the program sends it: the route is the program's, the
work is the block's."""
from __future__ import annotations

from collections import Counter
from typing import Dict

import torch
import torch.nn as nn

from gpubench.counts.blocks import Key
from gpubench.models import family

KERNELS = ("stats_kernel", "apply_kernel", "halo_wgmma_kernel", "halo_f32_kernel",
           "flash_wgmma_kernel", "flash_f32_kernel")


def census(args: dict) -> Dict[Key, int]:
    """(kind, resample, H, cin, cout, proj) -> calls in one evaluation."""
    from gpubench.reference.adm import AttentionBlock, ResBlock

    model = family("adm").reference(args)
    seen = Counter()

    def res_hook(mod, inputs):
        _, C, H, _ = inputs[0].shape
        rs = "up" if mod.up else ("down" if mod.down else "none")
        proj = not isinstance(mod.skip_connection, nn.Identity)
        seen[("resblock", rs, H, C, mod.out_layers[3].out_channels, proj)] += 1

    def attn_hook(mod, inputs):
        _, C, H, _ = inputs[0].shape
        seen[("attnblock", "none", H, C, C, False)] += 1

    handles = [m.register_forward_pre_hook(res_hook) for m in model.modules()
               if isinstance(m, ResBlock)]
    handles += [m.register_forward_pre_hook(attn_hook) for m in model.modules()
                if isinstance(m, AttentionBlock)]
    try:
        size = args.get("image_size", 256)
        with torch.no_grad():
            model(torch.empty(1, 3, size, size, device="meta"),
                  torch.zeros(1, dtype=torch.int32, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return dict(seen)
