"""The port's fused attention block (plain version, which its wrapper runs
on CPU tensors) against the TPU kernel #3 fused_attnblock_pallas in Pallas
interpret mode. The CUDA kernel is checked on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

from diffpure_tpu.ops.fused_attnblock import fused_attnblock_pallas
from diffpure_tpu_torch.ops import fused_attnblock as fab
from torch_parity import DTYPES, REL, assert_close, attnblock_params, \
    normal, to_jax, to_torch


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hw", [4, 8])  # HW = 16 and 64 positions
def test_attnblock_matches_pallas(hw, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(hw)
    C = 64
    x = normal(rng, 2, hw, hw, C)
    p = attnblock_params(rng, C)
    want = fused_attnblock_pallas(to_jax(x, jdt), tuple(to_jax(a) for a in p),
                                  num_groups=16, interpret=True)
    launches = fab.fused_attnblock.launches
    with torch.inference_mode():
        got = fab.fused_attnblock(to_torch(x, tdt),
                                  tuple(to_torch(a) for a in p), num_groups=16)
    assert got.dtype == tdt
    assert fab.fused_attnblock.launches == launches  # CPU: plain, no launch
    assert_close(got, want, REL[dtype], f"attnblock hw={hw * hw}")


def test_pack_layout():
    rng = np.random.default_rng(0)
    p = tuple(to_torch(a) for a in attnblock_params(rng, 8))
    pk = fab.pack_attnblock_params(p, torch.float32, "cpu")
    assert torch.equal(pk.wqkv, torch.cat([p[2], p[4], p[6]], 1).t())
    assert torch.equal(pk.wo, p[8].t())
    assert torch.equal(pk.bqkv, torch.cat([p[3], p[5], p[7]]))
