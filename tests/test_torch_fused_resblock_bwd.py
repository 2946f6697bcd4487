"""The port's plain backward of the fused BigGAN block (which the backward
wrappers run on CPU tensors) against the TPU backward kernels in Pallas
interpret mode, and the block's autograd Function against autograd of the
plain version.

Kernel #4 fused_resblock_bwd_pallas for resample in {none, down, up} with
and without the 1x1 projection; kernel #5 fused_resblock_cat_bwd_pallas,
including a seam that splits a GroupNorm group. The CUDA kernels are held
against this plain version on the card by chip_smoke.py (phase 2b).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffpure_tpu.ops.fused_resblock import fused_resblock_bwd_pallas, \
    fused_resblock_cat_bwd_pallas
from diffpure_tpu_torch.ops import fused_resblock as frb
from diffpure_tpu_torch.ops.groupnorm import ncsn_num_groups
from torch_parity import DTYPES, assert_close, normal, resblock_params, \
    resblock_params_torch, to_jax, to_torch

N, H = 2, 8

# (resample, cin, cout, projection)
BLOCKS = [("none", 32, 64, True), ("down", 64, 96, True), ("up", 96, 64, True),
          ("none", 32, 32, False), ("down", 64, 64, False), ("up", 96, 96, False)]
# (c1, c2, cout): 64 | 32 splits at a group edge; 64 | 96 puts the seam
# inside group 12 (160 channels, 32 groups of 5)
CATS = [(64, 32, 64), (64, 96, 96)]

# fp32: the JAX package's own bound for its backward kernel against
# autodiff (tests/test_fused_resblock.py:167-169), applied to max|want|:
# only the summation order differs. bf16: the plain backward rounds each
# conv's input gradient to bf16 (three roundings on the way to dx) where the
# TPU kernel keeps them in fp32. Over these cases that gap is at most
# 5.7e-3 of max|want|; the bound is 1.5e-2.
TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}


def _inputs(rng, cin, cout, Ho, proj=True):
    x = normal(rng, N, H, H, cin)
    temb = normal(rng, N, cout, scale=0.3)
    g = normal(rng, N, Ho, Ho, cout)
    return x, temb, g, resblock_params(rng, cin, cout, proj)


def _close(got, want, dtype, what):
    if dtype == "float32":
        got, want = np.asarray(got.float()), np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=what)
    else:
        assert_close(got, want, TOL[dtype], what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("resample,cin,cout,proj", BLOCKS)
def test_resblock_bwd_matches_pallas(resample, cin, cout, proj, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(cin + 3 * cout + len(resample))
    Ho = {"none": H, "down": H // 2, "up": 2 * H}[resample]
    x, temb, g, p = _inputs(rng, cin, cout, Ho, proj)
    g1, g2 = ncsn_num_groups(cin), ncsn_num_groups(cout)
    want_dx, want_dt = fused_resblock_bwd_pallas(
        to_jax(x, jdt), to_jax(temb, jdt), tuple(to_jax(a) for a in p),
        to_jax(g, jdt), num_groups1=g1, num_groups2=g2, resample=resample,
        interpret=True)
    launches = frb.fused_resblock_bwd.launches
    dx, dt = frb.fused_resblock_bwd(
        to_torch(x, tdt), to_torch(temb, tdt), resblock_params_torch(p),
        to_torch(g, tdt), num_groups1=g1, num_groups2=g2, resample=resample)
    assert frb.fused_resblock_bwd.launches == launches  # CPU: plain, no launch
    assert dx.dtype == dt.dtype == torch.float32
    _close(dx, want_dx, dtype, f"dx {resample} {cin}->{cout}")
    _close(dt, want_dt, dtype, f"dtemb {resample} {cin}->{cout}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c1,c2,cout", CATS)
def test_resblock_cat_bwd_matches_pallas(c1, c2, cout, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(c1 + c2 + cout)
    x1, x2 = normal(rng, N, H, H, c1), normal(rng, N, H, H, c2, scale=2.0)
    temb = normal(rng, N, cout, scale=0.3)
    g = normal(rng, N, H, H, cout)
    p = resblock_params(rng, c1 + c2, cout)
    g1, g2 = ncsn_num_groups(c1 + c2), ncsn_num_groups(cout)
    want = fused_resblock_cat_bwd_pallas(
        to_jax(x1, jdt), to_jax(x2, jdt), to_jax(temb, jdt),
        tuple(to_jax(a) for a in p), to_jax(g, jdt), num_groups1=g1,
        num_groups2=g2, interpret=True)
    got = frb.fused_resblock_cat_bwd(
        to_torch(x1, tdt), to_torch(x2, tdt), to_torch(temb, tdt),
        resblock_params_torch(p), to_torch(g, tdt), num_groups1=g1,
        num_groups2=g2)
    for name, a, b in zip(("dx1", "dx2", "dtemb"), got, want):
        _close(a, b, dtype, f"cat {c1}|{c2}->{cout} {name}")


def _leaf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)


@pytest.mark.parametrize("cat", [False, True], ids=["single", "cat"])
def test_function_matches_autograd(cat):
    """The Function's backward (the plain wrappers on CPU) against autograd
    of the plain version, for the inputs and, through the needs_input_grad
    branch, the weights; a weight that does not require grad gets none."""
    rng = np.random.default_rng(11)
    c1, c2, cout = (16, 16, 32) if cat else (32, 0, 48)
    cin = c1 + c2
    x = normal(rng, N, H, H, cin)
    temb = normal(rng, N, cout, scale=0.3)
    p = [t if t is None else t.requires_grad_(True)
         for t in resblock_params_torch(resblock_params(rng, cin, cout))]
    p[0].requires_grad_(False)   # gn1 scale: held constant
    g = torch.from_numpy(normal(rng, N, H, H, cout))
    g1, g2 = ncsn_num_groups(cin), ncsn_num_groups(cout)
    kw = dict(num_groups1=g1, num_groups2=g2)

    xa, ta = _leaf(x), _leaf(temb)
    if cat:
        out = frb.fused_resblock_cat(xa[..., :c1], xa[..., c1:], ta, tuple(p), **kw)
    else:
        out = frb.fused_resblock(xa, ta, tuple(p), resample="none", **kw)
    wrt = [xa, ta] + [t for t in p if t.requires_grad]
    got = torch.autograd.grad(out, wrt, g)

    xb, tb = _leaf(x), _leaf(temb)
    want_out = frb.fused_resblock_reference(xb, tb, tuple(p), **kw)
    want = torch.autograd.grad(want_out, [xb, tb] + wrt[2:], g)
    assert_close(out, want_out, 1e-6, "forward")
    for i, (a, b) in enumerate(zip(got, want)):
        assert_close(a, b, 1e-5, f"grad {i}")
    # a block whose weights require no grad still gives dx
    (dx,) = torch.autograd.grad(
        frb.fused_resblock(xa, ta, tuple(t.detach() for t in p), **kw), xa, g)
    assert_close(dx, want[0], 1e-5, "dx, constant weights")


def test_pack_bwd_is_the_transposed_conv():
    """Row c of the packed transposed weights, as a 3x3 SAME conv, gives the
    input gradient of the forward conv; wskip^T that of the projection."""
    rng = np.random.default_rng(5)
    p = resblock_params_torch(resblock_params(rng, 8, 12))
    pkb = frb.pack_resblock_bwd_params(p, torch.float32, "cpu")
    assert pkb.w1t.shape == (12, 108) and pkb.w0t.shape == (8, 108)
    assert pkb.wskipt.shape == (8, 12)
    gy = torch.randn(2, 5, 5, 12, dtype=torch.float64)
    for w, wt in ((p[2], pkb.w0t), (p[6], pkb.w1t)):
        ci = w.shape[1]
        x = torch.zeros(2, ci, 5, 5, dtype=torch.float64, requires_grad=True)
        y = F.conv2d(x, w.double(), padding=1)
        (want,) = torch.autograd.grad(y, x, gy.permute(0, 3, 1, 2))
        wt_oihw = wt.double().reshape(ci, 3, 3, 12).permute(0, 3, 1, 2)
        got = F.conv2d(gy.permute(0, 3, 1, 2), wt_oihw, padding=1)
        torch.testing.assert_close(got, want)
    torch.testing.assert_close(pkb.wskipt, p[8].t())
    assert frb.pack_resblock_bwd_params(
        resblock_params_torch(resblock_params(rng, 8, 8, proj=False)),
        torch.float32, "cpu").wskipt is None
