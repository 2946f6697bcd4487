"""The gradients of the port's 256-px and GroupNorm+SiLU autograd Functions
(kernels #6-#10) against jax.grad of diffpure_tpu's custom_vjp wrappers,
for every differentiable input, on the same seeded inputs and cotangents.

On the CPU each Function runs its plain forward and the backward the card
runs too: autograd of the plain version, recomputed. JAX's forwards run
their Pallas kernels in interpret mode; its backwards are jax.vjp of the
same plain versions (``_gcb_bwd``, ``_gnfs_bwd``, ``_flash_vjp_bwd``), and
#10's is the plain chain's own autodiff (JAX's default path).
Tolerances (ROADMAP Queue 1): fp32 1e-4, bf16 0.5% of max |JAX|; #10's
bf16 chain 1e-2 (GN_SILU_GRAD_REL).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.models import layers as jlayers
from diffpure_tpu.ops import flash_attention as jfa
from diffpure_tpu.ops import groupnorm as jgn
from diffpure_tpu.ops import halo_conv as jhc
from diffpure_tpu.ops import tiled_groupnorm as jtgn
from diffpure_tpu_torch.models.layers import GNSiLU
from diffpure_tpu_torch.ops import flash_attention as fa
from diffpure_tpu_torch.ops import groupnorm as gn
from diffpure_tpu_torch.ops import halo_conv as hc
from diffpure_tpu_torch.ops import tiled_groupnorm as tgn
from torch_parity import DTYPES, REL, assert_close, normal, to_jax, to_torch

GRAD_REL = {"float32": 1e-4, "bfloat16": 5e-3}
# #10's plain chain rounds the GroupNorm to bf16, then takes the SiLU's
# derivative in bf16, where JAX's logistic derivative and torch's land an
# ulp apart in about a third of the elements (0.4-0.8% of the value at the
# top of a binade): the bf16 forward bound, REL.
GN_SILU_GRAD_REL = {"float32": 1e-4, "bfloat16": REL["bfloat16"]}
N, H, W = 2, 8, 8


def _grads(torch_fn, jax_fn, args, which, dtypes, g, what, rel):
    """d/d args[i] (i in which) of <g, fn(*args)> in both packages: args
    are numpy arrays or None, dtypes their (jax, torch) dtypes; asserts
    each gradient and the forward close."""
    jargs = [None if a is None else to_jax(a, d[0]) for a, d in zip(args, dtypes)]

    def jf(*diff):
        a = list(jargs)
        for i, v in zip(which, diff):
            a[i] = v
        return jax_fn(*a)

    want_out, vjp = jax.vjp(jf, *[jargs[i] for i in which])
    want = vjp(jnp.asarray(g).astype(want_out.dtype))
    targs = [None if a is None else to_torch(a, d[1]) for a, d in zip(args, dtypes)]
    leaves = [targs[i].requires_grad_(True) for i in which]
    out = torch_fn(*targs)
    assert out.dtype == dtypes[0][1]
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(out.dtype))
    assert_close(out, want_out, REL[jnp.dtype(dtypes[0][0]).name], f"{what} forward")
    for i, a, b in zip(which, got, want):
        assert a.dtype == leaves[which.index(i)].dtype and a.shape == leaves[which.index(i)].shape
        assert_close(a, b, rel, f"{what} d/d arg {i}")


# the halo stage: (film, skip, w_proj, pre_shift) present or absent, as
# the ADM's two stages and the DDPM's form have them, and all at once
STAGES = {"bare": (False, None, False, False), "film_proj": (True, "proj", True, False),
          "pre_shift": (False, "identity", False, True), "all": (True, "proj", True, True)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stage", list(STAGES))
def test_gn_silu_conv_block_grads_match_jax(dtype, stage):
    film, skip, proj, pre = STAGES[stage]
    jdt, tdt = DTYPES[dtype]
    # two channels a group: a per-channel shift is not a per-group one, to
    # which the GroupNorm would be blind (a zero pre_shift gradient)
    cin, cout = 64, (128 if proj else 64)
    rng = np.random.default_rng(list(STAGES).index(stage))
    cr = cin if proj else cout
    args = [normal(rng, N, H, W, cin, shift=0.2), normal(rng, cin, scale=0.1, shift=1.0),
            normal(rng, cin, scale=0.1),
            normal(rng, N, cin, scale=0.1) if film else None,
            normal(rng, N, cin, scale=0.1) if film else None,
            normal(rng, 3, 3, cin, cout, fan_in=9 * cin), normal(rng, cout, scale=0.1),
            normal(rng, N, H, W, cr) if skip else None,
            normal(rng, cr, cout, fan_in=cr) if proj else None,
            normal(rng, N, cin, scale=0.5) if pre else None]
    f32 = (jnp.float32, torch.float32)
    dtypes = [(jdt, tdt)] + [f32] * 6 + [(jdt, tdt)] + [f32] * 2
    which = [i for i, a in enumerate(args) if a is not None]
    g = normal(rng, N, H, W, cout)
    _grads(lambda *a: hc.gn_silu_conv_block(*a, 32, 1e-5),
           lambda *a: jhc.gn_silu_conv_block(*a, 32, 1e-5, True),
           args, which, dtypes, g, f"halo block {stage} {dtype}", GRAD_REL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_film_silu_grads_match_jax(dtype, film, silu):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(10 + 2 * film + silu)
    C = 64
    args = [normal(rng, N, H, W, C, shift=0.3), normal(rng, C, scale=0.1, shift=1.0),
            normal(rng, C, scale=0.1), normal(rng, N, C, scale=0.1) if film else None,
            normal(rng, N, C, scale=0.1) if film else None]
    f32 = (jnp.float32, torch.float32)
    which = [i for i, a in enumerate(args) if a is not None]
    _grads(lambda x, s, b, fs, ft: tgn.group_norm_film_silu(x, s, b, 32, 1e-5, fs, ft, silu),
           lambda x, s, b, fs, ft: jtgn.group_norm_film_silu(x, s, b, 32, 1e-5, fs, ft, silu,
                                                             True),
           args, which, [(jdt, tdt)] + [f32] * 4, normal(rng, N, H, W, C),
           f"tiled GN film={film} silu={silu} {dtype}", GRAD_REL[dtype])


def test_the_pieces_have_their_plain_gradients():
    """The two passes and the halo conv, each its own Function, against
    jax.vjp of JAX's plain versions (the stats as x's sums per example)."""
    rng = np.random.default_rng(20)
    x, A, B = normal(rng, N, H, W, 32), normal(rng, N, 32, shift=1.0), normal(rng, N, 32)
    w, b = normal(rng, 3, 3, 32, 64, fan_in=288), normal(rng, 64, scale=0.1)
    f32 = [(jnp.float32, torch.float32)] * 5
    _grads(lambda *a: hc.gn_silu_conv3x3_halo(*a), lambda *a: jhc.gn_silu_conv3x3_reference(*a),
           [x, A, B, w, b], [0, 1, 2, 3, 4], f32, normal(rng, N, H, W, 64), "halo conv", 1e-4)
    _grads(lambda *a: tgn.gn_film_silu_apply(*a),
           lambda x_, a_, b_: jax.nn.silu(x_ * a_[:, None, None] + b_[:, None, None]),
           [x, A, B], [0, 1, 2], f32, normal(rng, N, H, W, 32), "apply", 1e-4)
    xt = torch.from_numpy(x).requires_grad_(True)
    sums, sqs = tgn.group_stats(xt)
    gs, gq = normal(rng, N, 1, 32), normal(rng, N, 1, 32)
    (got,) = torch.autograd.grad((sums, sqs), xt, (torch.from_numpy(gs), torch.from_numpy(gq)))
    want = jax.grad(lambda v: jnp.sum(jnp.sum(v, (1, 2))[:, None] * gs)
                    + jnp.sum(jnp.sum(v * v, (1, 2))[:, None] * gq))(jnp.asarray(x))
    assert_close(got, want, 1e-5, "stats")


def test_frozen_inputs_get_no_gradient():
    """needs_input_grad: with the weights frozen, as the attacks have them,
    only x gets a gradient, and it is the one with the weights live."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(normal(rng, N, H, W, 32))
    gs, gb = torch.from_numpy(normal(rng, 32, shift=1.0)), torch.from_numpy(normal(rng, 32))
    w, b = torch.from_numpy(normal(rng, 3, 3, 32, 32, fan_in=288)), torch.zeros(32)
    grads = []
    for live in (False, True):
        leaves = [t.clone().requires_grad_(live) for t in (gs, gb, w, b)]
        xt = x.clone().requires_grad_(True)
        out = hc.gn_silu_conv_block(xt, leaves[0], leaves[1], None, None, leaves[2],
                                    leaves[3], None, None, None, 32, 1e-5)
        out.square().sum().backward()
        grads.append(xt.grad)
        assert all((t.grad is not None) == live for t in leaves)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("BH, D", [(4, 64), (6, 48), (40, 32)])
def test_flash_attention_grads_match_jax(monkeypatch, dtype, BH, D):
    """D = 48 is one the card's kernel reads padded (fp32) or in place
    (bf16); BH = 40 makes two slabs of 20 (the largest divisor <= 32), as
    JAX's lax.map does."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(BH + D)
    T = 128
    q, k, v, g = (normal(rng, BH, T, D) for _ in range(4))
    scale = 1.0 / D ** 0.25
    slabs = []
    dense = fa._dense_vjp
    monkeypatch.setattr(fa, "_dense_vjp", lambda s, need, t, gr: slabs.append(
        t[0].shape[0]) or dense(s, need, t, gr))
    _grads(lambda *a: fa.flash_attention(*a, scale),
           lambda *a: jfa.flash_attention(*a, scale, block_q=64, block_k=64, interpret=True),
           [q, k, v], [0, 1, 2], [(jdt, tdt)] * 3, g, f"flash BH={BH} D={D} {dtype}",
           GRAD_REL[dtype])
    slab = fa.largest_divisor_leq(BH, 32)
    assert slabs == [slab] * (BH // slab) and slab == jfa._largest_divisor_leq(BH, 32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_group_norm_silu_fused_grads_are_the_plain_chains(dtype):
    """#10's Function: the forward is the kernel's one-rounding form, the
    gradient the plain chain's (JAX's default path: jax.grad of
    group_norm_silu)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(30)
    C = 64
    args = [normal(rng, N, H, W, C, shift=0.3), normal(rng, C, scale=0.1, shift=1.0),
            normal(rng, C, scale=0.1)]
    g = normal(rng, N, H, W, C)
    jargs = [to_jax(args[0], jdt), to_jax(args[1]), to_jax(args[2])]
    _, vjp = jax.vjp(lambda *a: jgn.group_norm_silu(*a, 32, 1e-6), *jargs)
    want = vjp(jnp.asarray(g).astype(jdt))
    leaves = [to_torch(args[0], tdt).requires_grad_(True), to_torch(args[1]).requires_grad_(True),
              to_torch(args[2]).requires_grad_(True)]
    out = gn.group_norm_silu_fused(*leaves, 32, 1e-6)
    assert_close(out, gn.group_norm_silu_fused_reference(*leaves, 32, 1e-6), 0.0, "forward")
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(tdt))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == leaves[i].dtype
        assert_close(a, b, GN_SILU_GRAD_REL[dtype], f"#10 d/d arg {i} {dtype}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gnsilu_module_grads_match_jax(dtype):
    """The GNSiLU module (the DDPM's and NCSN++ 'ddpm''s): input and
    parameter gradients against JAX's module."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(31)
    C = 64
    x, g = normal(rng, N, H, W, C), normal(rng, N, H, W, C)
    scale, bias = normal(rng, C, scale=0.1, shift=1.0), normal(rng, C, scale=0.1)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    jmod = jlayers.GNSiLU(num_groups=32)
    _, vjp = jax.vjp(lambda p, xx: jmod.apply(p, xx), params, to_jax(x, jdt))
    dp, dx = vjp(jnp.asarray(g).astype(jdt))
    mod = GNSiLU(32, C, eps=1e-6)
    mod.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    xt = to_torch(x, tdt).requires_grad_(True)
    (mod(xt).float() * torch.from_numpy(g).to(tdt).float()).sum().backward()
    assert_close(xt.grad, dx, GN_SILU_GRAD_REL[dtype], "GNSiLU d/dx")
    assert_close(mod.weight.grad, dp["params"]["scale"], GN_SILU_GRAD_REL[dtype], "GNSiLU d/dscale")
    assert_close(mod.bias.grad, dp["params"]["bias"], GN_SILU_GRAD_REL[dtype], "GNSiLU d/dbias")
