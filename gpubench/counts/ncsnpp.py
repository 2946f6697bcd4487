"""NCSN++'s blocks (counts/blocks.py) and its hand-written kernels: #1, #2
run the residual blocks, #3 the attention blocks, #4, #5 the residual
blocks' backward."""
from __future__ import annotations

from collections import Counter
from typing import Dict

import torch

from gpubench.counts.blocks import Key
from gpubench.models import family

# the kernels' names as the profiler reports them (fragments), every dtype
KERNELS = ("f32conv_kernel", "rb_gn_kernel", "rb_gn_bwd_kernel", "splitk_", "gn_apply_kernel",
           "gn_silu_bwd_kernel", "gn_regs_kernel", "attn_qkv_f32_kernel", "attn_qkv_sum_kernel",
           "attn_f32_kernel", "rb_wgmma_kernel", "attn_wgmma_kernel", "igemm_", "attn_kernel")


def census(args: dict) -> Dict[Key, int]:
    """(kind, resample, H, cin, cout, proj) -> calls in one evaluation."""
    from gpubench.reference.ncsnpp import AttnBlockpp, ResnetBlockBigGANpp

    model = family("ncsnpp").reference(args)
    seen = Counter()

    def hook(mod, inputs):
        x = inputs[0]
        if isinstance(mod, AttnBlockpp):
            seen[("attnblock", "none", x.shape[2], x.shape[1], x.shape[1], False)] += 1
        else:
            rs = "up" if mod.up else ("down" if mod.down else "none")
            seen[("resblock", rs, x.shape[2], x.shape[1], mod.Conv_0.out_channels,
                  mod.proj)] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, (AttnBlockpp, ResnetBlockBigGANpp))]
    try:
        size = args.get("image_size", 32)
        with torch.no_grad():
            model(torch.empty(1, 3, size, size, device="meta"),
                  torch.zeros(1, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return dict(seen)
