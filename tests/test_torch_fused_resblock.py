"""The port's fused BigGAN block (plain version, which its wrappers run on
CPU tensors) against the TPU kernels in Pallas interpret mode.

Kernel #1 fused_resblock_pallas for resample in {none, down, up} with and
without the 1x1 projection; kernel #2 fused_resblock_cat_pallas, including
a seam that splits a GroupNorm group. The CUDA kernel itself is checked
against this plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from diffpure_tpu.ops.fused_resblock import fused_resblock_cat_pallas, \
    fused_resblock_pallas
from diffpure_tpu_torch.ops import fused_resblock as frb
from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups
from torch_parity import DTYPES, REL, assert_close, normal, resblock_params, \
    resblock_params_torch, to_jax, to_torch

N, H = 2, 8

# (resample, cin, cout, projection)
BLOCKS = [("none", 32, 64, True), ("down", 64, 96, True), ("up", 96, 64, True),
          ("none", 32, 32, False), ("down", 64, 64, False), ("up", 96, 96, False)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("resample,cin,cout,proj", BLOCKS)
def test_resblock_matches_pallas(resample, cin, cout, proj, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(cin + cout + len(resample))
    x = normal(rng, N, H, H, cin)
    temb = normal(rng, N, cout, scale=0.3)
    p = resblock_params(rng, cin, cout, proj)
    g1, g2 = ncsn_num_groups(cin), ncsn_num_groups(cout)
    want = fused_resblock_pallas(
        to_jax(x, jdt), to_jax(temb, jdt), tuple(to_jax(a) for a in p),
        num_groups1=g1, num_groups2=g2, resample=resample, interpret=True)
    launches = frb.fused_resblock.launches
    with torch.inference_mode():
        got = frb.fused_resblock(
            to_torch(x, tdt), to_torch(temb, tdt), resblock_params_torch(p),
            num_groups1=g1, num_groups2=g2, resample=resample)
    assert got.dtype == tdt
    assert frb.fused_resblock.launches == launches  # CPU: plain, no launch
    assert_close(got, want, REL[dtype], f"resblock {resample} {cin}->{cout}")


# (c1, c2, cout): 64 | 32 splits at a group edge (96 channels, 24 groups of
# 4); 64 | 96 puts the seam inside group 12 (160 channels, 32 groups of 5).
CATS = [(64, 32, 64), (64, 96, 96)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c1,c2,cout", CATS)
def test_resblock_cat_matches_pallas(c1, c2, cout, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(c1 + c2)
    x1, x2 = normal(rng, N, H, H, c1), normal(rng, N, H, H, c2, scale=2.0)
    temb = normal(rng, N, cout, scale=0.3)
    p = resblock_params(rng, c1 + c2, cout)
    g1, g2 = ncsn_num_groups(c1 + c2), ncsn_num_groups(cout)
    want = fused_resblock_cat_pallas(
        to_jax(x1, jdt), to_jax(x2, jdt), to_jax(temb, jdt),
        tuple(to_jax(a) for a in p), num_groups1=g1, num_groups2=g2,
        interpret=True)
    with torch.inference_mode():
        got = frb.fused_resblock_cat(
            to_torch(x1, tdt), to_torch(x2, tdt), to_torch(temb, tdt),
            resblock_params_torch(p), num_groups1=g1, num_groups2=g2)
    assert_close(got, want, REL[dtype], f"cat {c1}|{c2}->{cout}")


def test_pack_layout():
    """The kernel's packed weights: column (3*dy + dx)*cin + c of w0 is
    w0[:, c, dy, dx]; conv1's columns are followed by the projection's, and
    the two biases are summed."""
    rng = np.random.default_rng(3)
    p = resblock_params_torch(resblock_params(rng, 8, 12))
    pk = frb.pack_resblock_params(p, torch.float32, "cpu")
    w0, w1, ws = p[2], p[6], p[8]
    assert pk.w0.shape == (12, 72) and pk.w1.shape == (12, 9 * 12 + 8)
    for dy, dx, c in [(0, 0, 0), (1, 2, 5), (2, 1, 7)]:
        assert torch.equal(pk.w0[:, (3 * dy + dx) * 8 + c], w0[:, c, dy, dx])
        assert torch.equal(pk.w1[:, (3 * dy + dx) * 12 + c], w1[:, c, dy, dx])
    assert torch.equal(pk.w1[:, 108:], ws)
    assert torch.allclose(pk.bias1, p[7] + p[9])


def test_refuses_gradients():
    """What the wrapper refuses: a device other than cpu or cuda. Gradients
    it does not refuse: dx and dtemb flow through the block's Function and
    match autograd of the plain version."""
    rng = np.random.default_rng(4)
    p = resblock_params_torch(resblock_params(rng, 8, 8, proj=False))
    x = torch.randn(1, 4, 4, 8, requires_grad=True)
    temb = torch.zeros(1, 8, requires_grad=True)
    out = frb.fused_resblock(x, temb, p, num_groups1=2, num_groups2=2)
    dx, dt = torch.autograd.grad(out.square().sum(), (x, temb))
    ref = frb.fused_resblock_reference(x, temb, p, num_groups1=2, num_groups2=2)
    want = torch.autograd.grad(ref.square().sum(), (x, temb))
    assert_close(dx, want[0], 1e-5, "dx")
    assert_close(dt, want[1], 1e-5, "dtemb")
    with pytest.raises(ValueError, match="cpu or cuda"):
        frb.fused_resblock(x.detach().to("meta"), torch.zeros(1, 8), p,
                           num_groups1=2, num_groups2=2)
