"""Fused bias + leaky ReLU + gain, kernel #11's plain version and CPU
wrapper, against diffpure_tpu's fused_leaky_relu and
fused_leaky_relu_pallas (interpret mode; it always takes a bias, so the
no-bias case gives it zeros). fp32: 1e-5 of max |ref|; bf16: 1e-2.

Also its gradient (first and second order) against ``jax.grad``, and the
kernel's launch plan ``flr_plan``: the route it picks, a grid within the
resident CTAs that covers every element once at phase 2d's shapes (the
kernel's index formulas walked here in numpy), and the shared route's
channel-by-addition and scalar tail emulated against JAX's Pallas kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FLR_CASES, FLR_LARGE
from diffpure_tpu.ops import fused_act as jfa
from diffpure_tpu_torch.ops import fused_act, fused_leaky_relu, launch_counts
from diffpure_tpu_torch.ops.fused_act import FLR_UNROLL, flr_plan
from torch_parity import DTYPES, REL, assert_close, normal, to_jax, to_torch

TOL = {"float32": 1e-5, "bfloat16": REL["bfloat16"]}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("slope,gain", [(0.2, 2.0 ** 0.5), (0.1, 1.0), (0.0, 3.0)])
@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (3, 5, 7)], ids=["nhwc", "odd"])
def test_matches_jax(shape, slope, gain, with_bias, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(len(shape))
    x = normal(rng, *shape)
    b = normal(rng, shape[-1]) if with_bias else None
    want = jfa.fused_leaky_relu(to_jax(x, jdt), to_jax(b, jdt), slope, gain)
    want_pallas = jfa.fused_leaky_relu_pallas(
        to_jax(x, jdt), to_jax(b if with_bias else np.zeros(shape[-1], np.float32), jdt),
        slope, gain, interpret=True)
    before = launch_counts()["fused_leaky_relu"]
    got = fused_leaky_relu(to_torch(x, tdt), to_torch(b), slope, gain)
    assert got.dtype == tdt and launch_counts()["fused_leaky_relu"] == before
    assert torch.equal(got, fused_act.fused_leaky_relu_reference(
        to_torch(x, tdt), to_torch(b), slope, gain))
    assert_close(got, want, TOL[dtype], "fused_leaky_relu")
    assert_close(got, want_pallas, TOL[dtype], "fused_leaky_relu_pallas")


def test_defaults_and_devices():
    x = torch.tensor([[-1.0, 2.0]])
    np.testing.assert_allclose(fused_leaky_relu(x).numpy(),
                               [[-0.2 * 2 ** 0.5, 2.0 * 2 ** 0.5]], rtol=1e-6)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_leaky_relu(torch.zeros(2, 4, device="meta"))


def _grad_case(shape, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    x, w = normal(rng, *shape), normal(rng, *shape)
    b = normal(rng, shape[-1]) if with_bias else None
    return x, b, w


def _torch_grads(x, b, w, create_graph=False):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = None if b is None else torch.from_numpy(b).requires_grad_(True)
    loss = (fused_leaky_relu(xt, bt, 0.2, 2.0 ** 0.5) * wt).sum()
    wrt = (xt,) if bt is None else (xt, bt)
    return (xt, bt, wt), torch.autograd.grad(loss, wrt, create_graph=create_graph)


def _jax_loss(x, b, w):
    return jnp.sum(jfa.fused_leaky_relu(x, b, 0.2, 2.0 ** 0.5) * w)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (3, 5, 7)], ids=["nhwc", "odd"])
def test_gradient_matches_jax(shape, with_bias):
    """d/dx and d/dbias of sum(w * y) against jax.grad, fp32, 1e-5."""
    x, b, w = _grad_case(shape, with_bias)
    _, got = _torch_grads(x, b, w)
    if with_bias:
        want = jax.grad(_jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b),
                                                   jnp.asarray(w))
    else:
        want = (jax.grad(lambda x_: _jax_loss(x_, None, jnp.asarray(w)))(jnp.asarray(x)),)
    assert len(got) == len(want)
    for g, wnt, name in zip(got, want, ("dx", "dbias")):
        assert_close(g, wnt, 1e-5, name)


def test_second_order_gradient_matches_jax():
    """The gradient of sum(dx) + sum(dbias) (the first gradient of sum(w *
    y)) with respect to x, bias and w, against JAX's, fp32, 1e-5: zero in
    x and bias (the select's kink), scale * where(h >= 0, 1, slope) in w."""
    x, b, w = _grad_case((2, 3, 5, 8), True, seed=1)
    (xt, bt, wt), (gx, gb) = _torch_grads(x, b, w, create_graph=True)
    got = torch.autograd.grad(gx.sum() + gb.sum(), (xt, bt, wt), allow_unused=True)

    def first_sum(x_, b_, w_):
        gx_, gb_ = jax.grad(_jax_loss, argnums=(0, 1))(x_, b_, w_)
        return jnp.sum(gx_) + jnp.sum(gb_)

    want = jax.grad(first_sum, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(b),
                                                  jnp.asarray(w))
    for g, wnt, name in zip(got, want, ("x", "bias", "w")):
        g = torch.zeros_like(xt if name == "x" else bt) if g is None else g
        np.testing.assert_array_equal(np.isfinite(np.asarray(wnt)), True)
        if name == "w":
            assert_close(g, wnt, 1e-5, name)
        else:
            assert float(g.abs().max()) == 0.0 and float(jnp.abs(wnt).max()) == 0.0, name


@pytest.mark.parametrize("with_bias", [True, False])
def test_zero_takes_the_nonnegative_branch(with_bias):
    """x + bias exactly 0 (and -0 without a bias) takes the >= 0 branch on
    both sides: y = 0 and dy/dx = scale, as in JAX."""
    rng = np.random.default_rng(2)
    b = normal(rng, 8) if with_bias else None
    x = normal(rng, 3, 8)
    x[0] = -b if with_bias else 0.0
    if not with_bias:
        x[1, :4] = -0.0
    w = np.ones_like(x)
    _, got = _torch_grads(x, b, w)
    want = jax.grad(_jax_loss, argnums=0)(jnp.asarray(x), None if b is None else jnp.asarray(b),
                                          jnp.asarray(w))
    y = fused_leaky_relu(torch.from_numpy(x), None if b is None else torch.from_numpy(b))
    assert float(y[0].abs().max()) == 0.0
    np.testing.assert_array_equal(got[0].numpy()[0], np.float32(2.0 ** 0.5))
    np.testing.assert_array_equal(np.asarray(want)[0], np.float32(2.0 ** 0.5))
    assert_close(got[0], want, 1e-5, "dx")


# phase 2d's shapes: FLR_CASES (batch 8) and the two past L2
PHASE_2D = [shape for shape, _ in FLR_CASES] + list(FLR_LARGE)
ODD = [(7, 9, 11, 13), (3, 5, 7), (2, 3, 3), (5, 1), (1,), (4, 12), (2, 6, 4096),
       (3, 16400), (2, 2, 8192), (16, 1032)]


def _cdiv(a, b):
    return -(-a // b)


def _visits(plan, shape):
    """How often the kernel's index formulas (csrc/fused_act.cu) reach each
    row of the (rows, C) view (registers: a thread covers a channel
    vector of its rows, the CTA every channel) or each element (shared)."""
    C = shape[-1]
    total = int(np.prod(shape))
    R, vw = total // C, plan.vw
    if plan.route == "registers":
        cv = C // vw  # a CTA of (cv, lanes) threads: one channel vector each
        lanes = plan.threads // cv
        assert lanes * cv == plan.threads and cv * vw == C
        assert plan.rows == lanes * plan.unroll
        seen = np.zeros(R, np.int64)
        for blk in range(plan.grid):  # trips of plan.rows rows, a grid apart
            for r in range(blk * plan.rows, R, plan.grid * plan.rows):
                for lane in range(lanes):
                    rs = r + lane + lanes * np.arange(plan.unroll)
                    seen[rs[rs < R]] += 1
        return seen
    nvec, G = total // vw, plan.grid * plan.threads
    seen = np.zeros(total, np.int64)
    first = np.arange(G)
    for i0 in range(0, nvec, plan.unroll * G):
        for k in range(plan.unroll):
            idx = first + k * G + i0
            idx = idx[idx < nvec]
            for j in range(vw):
                seen[idx * vw + j] += 1
    tail = nvec * vw + first
    seen[tail[tail < total]] += 1
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", PHASE_2D + ODD, ids=str)
def test_plan_route_grid_and_coverage(shape, dtype):
    """The registers route where C % vw == 0 (and at most 1024 vectors a
    row), else the shared route; a grid within the resident CTAs that
    covers every element exactly once."""
    plan = flr_plan(shape, dtype)
    C = shape[-1]
    esize = 4 if dtype == torch.float32 else 2
    vw = 16 // esize
    want = "registers" if C % vw == 0 and C // vw <= 1024 else "shared"
    assert plan.route == want and plan.vw == vw
    assert 1 <= plan.grid <= plan.resident and plan.threads <= 1024
    assert plan.resident * plan.threads <= 132 * 1024
    assert (_visits(plan, shape) == 1).all()
    total = int(np.prod(shape))
    if plan.route == "registers":
        assert plan.grid * plan.rows >= min(total // C, plan.resident * plan.rows)
    elif plan.route == "shared":
        assert plan.smem in (0, (C + vw) * 4) and plan.smem <= 48 * 1024
        assert (plan.smem == 0) == ((C + vw) * 4 > 48 * 1024)


def test_plan_toy_shapes_launch_one_short_wave():
    """A toy size gives each thread at most FLR_UNROLL vectors, one short
    wave (unroll 1 where a thread has one vector); a size past L2 fills
    the resident CTAs, each looping over trips of FLR_UNROLL rows a
    thread."""
    for shape, _ in FLR_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            plan = flr_plan(shape, dtype)
            per_thread = _cdiv(int(np.prod(shape)) // plan.vw, plan.grid * plan.threads)
            assert plan.grid <= plan.resident and per_thread <= FLR_UNROLL
            assert plan.unroll == (1 if per_thread == 1 else FLR_UNROLL)
    for shape in FLR_LARGE:
        for dtype in (torch.float32, torch.bfloat16):
            plan = flr_plan(shape, dtype)
            lanes = plan.threads // (shape[-1] // plan.vw)
            assert plan.route == "registers"
            assert plan.unroll == FLR_UNROLL and plan.rows == lanes * FLR_UNROLL
            assert plan.resident // 2 < plan.grid <= plan.resident


def _emulate_shared(x, b, slope, scale, plan, staged):
    """The shared route's arithmetic, index by index as flr_flat_kernel
    computes it (each in-flight vector's channel advanced by addition, the
    bias from the extended row sb[j] = b[j % C] or, unstaged, with one
    wrap; the scalar tail by e % C), in fp32."""
    xf = x.reshape(-1)
    total, C, vw = xf.size, x.shape[-1], plan.vw
    nvec, G, U = total // vw, plan.grid * plan.threads, plan.unroll
    act = lambda h: np.where(h >= 0, h, h * np.float32(slope)) * np.float32(scale)  # noqa: E731
    out = np.full(total, np.nan, np.float32)
    first = np.arange(G)
    if b is not None:
        sb = b[np.arange(C + vw) % C]
        c = [((first + k * G) * vw) % C for k in range(U)]
        dc = (U * G * vw) % C
    for i0 in range(0, nvec, U * G):
        for k in range(U):
            idx = first + k * G + i0
            live = idx < nvec
            for j in range(vw):
                h = xf[idx[live] * vw + j]
                if b is not None:
                    cj = c[k][live] + j
                    h = h + (sb[cj] if staged else b[np.where(cj >= C, cj - C, cj)])
                out[idx[live] * vw + j] = act(h)
        if b is not None:
            c = [ck + dc - np.where(ck + dc >= C, C, 0) for ck in c]
    tail = nvec * vw + first
    tail = tail[tail < total]
    out[tail] = act(xf[tail] + (b[tail % C] if b is not None else np.float32(0)))
    return out.reshape(x.shape)


# (shape, staged): the unstaged bias (C > 12280 on the card) needs C >= vw
SHARED_CASES = [((7, 9, 11, 13), True), ((3, 5, 9), True), ((2, 3, 3), True),
                ((7, 9, 11, 13), False), ((3, 5, 9), False)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,staged", SHARED_CASES,
                         ids=[f"{s}-{'smem' if st else 'global'}_bias" for s, st in SHARED_CASES])
def test_shared_route_and_scalar_tail_match_jax(shape, dtype, staged):
    """The shared route's index formulas on shapes with a scalar tail and
    C off the vector width (C = 3 below it), against JAX's Pallas kernel in
    interpret mode; in fp32 bit for bit the plain version."""
    jdt, tdt = DTYPES[dtype]
    plan = flr_plan(shape, tdt)
    assert plan.route == "shared" and int(np.prod(shape)) % plan.vw
    rng = np.random.default_rng(5)
    x, b = normal(rng, *shape), normal(rng, shape[-1])
    xq = to_torch(x, tdt).float().numpy()
    bq = to_torch(b, tdt).float().numpy()
    got = torch.from_numpy(_emulate_shared(xq, bq, 0.2, 2.0 ** 0.5, plan, staged)).to(tdt)
    want = jfa.fused_leaky_relu_pallas(to_jax(x, jdt), to_jax(b, jdt), 0.2, 2.0 ** 0.5,
                                       interpret=True)
    assert_close(got, want, TOL[dtype], "emulated shared route")
    if dtype == "float32":
        assert torch.equal(got, fused_act.fused_leaky_relu_reference(
            torch.from_numpy(x), torch.from_numpy(b), 0.2, 2.0 ** 0.5))
