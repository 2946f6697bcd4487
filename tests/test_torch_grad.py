"""Gradients through the port's defence against jax.grad of diffpure_tpu,
with the noise JAX draws injected into the port.

- the input gradient of ``purify_sde`` with grad_mode 'checkpoint' (exact
  backpropagation through the solver) and 'adjoint' (the O(1)-memory
  adjoint), each against its JAX counterpart, on a small NCSN++;
- grad_mode 'none' blocks the gradient as JAX's ``stop_gradient`` does;
- the input gradient of ``DefendedModel`` and ``UndefendedModel``;
- the attention block's autograd Function against jax.grad of the JAX
  block (its custom_vjp backward is autodiff of the plain version too).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.classifiers.convert import translate_wideresnet
from diffpure_tpu.classifiers.wideresnet import WideResNet as JaxWRN
from diffpure_tpu.eval.defended import DefendedModel as JaxDefended
from diffpure_tpu.eval.defended import UndefendedModel as JaxUndefended
from diffpure_tpu.models.convert import translate_ncsnpp
from diffpure_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffpure_tpu.ops.fused_attnblock import fused_attnblock as jax_attnblock
from diffpure_tpu.purify import PurifyConfig as JaxPurifyConfig
from diffpure_tpu.purify.runners import purify_sde as jax_purify_sde
from diffpure_tpu.solvers.adjoint import sdeint_em_adjoint as jax_sdeint_em_adjoint
from diffpure_tpu.solvers.em import brownian_increment as jax_brownian
from diffpure_tpu_torch.classifiers import WideResNet
from diffpure_tpu_torch.eval import DefendedModel, UndefendedModel
from diffpure_tpu_torch.models import NCSNpp
from diffpure_tpu_torch.ops import fused_attnblock as fab
from diffpure_tpu_torch.purify import PurifyConfig, purify_sde
from diffpure_tpu_torch.solvers import sdeint_em, sdeint_em_adjoint
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from test_torch_purify import JaxNoise
from torch_parity import assert_close, attnblock_params, normal, np32, to_jax

SMALL = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             image_size=16)
T_STAR = 4
# fp32 gradients after T_STAR steps, both packages in fp32 on the CPU: the
# forward agrees to ~1e-6 relative per step; the backward repeats that
# through the same number of steps in another summation order.
GRAD_REL = 2e-4


@pytest.fixture(scope="module")
def models():
    score = NCSNpp(**SMALL).eval()
    sd = seeded_normal_state_dict(score, 0)
    score.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    clf = WideResNet(depth=10, widen_factor=1).eval()
    csd = seeded_normal_state_dict(clf, 1)
    clf.load_state_dict({k: torch.from_numpy(v) for k, v in csd.items()})
    for m in (score, clf):
        m.requires_grad_(False)
    jscore = JaxNCSNpp(**SMALL)
    jclf = JaxWRN(depth=10, widen_factor=1, normalize_input=False)
    rng = np.random.default_rng(3)
    return dict(score=score, clf=clf, jscore=jscore, jparams=translate_ncsnpp(sd),
                jclf=jclf, jcparams=translate_wideresnet(csd),
                x01=rng.uniform(size=(2, 16, 16, 3)).astype(np.float32),
                w=normal(rng, 2, 16, 16, 3), key=jax.random.PRNGKey(11))


def _jax_model(m):
    return lambda p, x, t: m["jscore"].apply(p, x, t)


@pytest.mark.parametrize("grad_mode", ["checkpoint", "adjoint"])
def test_purify_sde_input_grad_matches_jax(models, grad_mode):
    """d/dx sum(w * purify_sde(x)) in both packages, same noise."""
    m = models
    x = m["x01"] * 2.0 - 1.0
    jcfg = JaxPurifyConfig(t=T_STAR, grad_mode=grad_mode)
    want = jax.grad(lambda xx: jnp.sum(jnp.asarray(m["w"]) * jax_purify_sde(
        _jax_model(m), m["jparams"], xx, m["key"], jcfg)))(jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = purify_sde(m["score"], xt, JaxNoise(m["key"]),
                     PurifyConfig(t=T_STAR, grad_mode=grad_mode))
    (got,) = torch.autograd.grad((torch.from_numpy(m["w"]) * out).sum(), xt)
    assert_close(got, want, GRAD_REL, f"d purify / dx, {grad_mode}")


def test_adjoint_is_near_the_checkpointed_gradient(models):
    """The adjoint approximates the exact (checkpointed) gradient: close to
    it, and not equal (its reconstructed trajectory carries O(dt) error)."""
    m = models
    x = torch.from_numpy(m["x01"] * 2.0 - 1.0)
    grads = {}
    for mode in ("checkpoint", "adjoint"):
        xt = x.clone().requires_grad_(True)
        out = purify_sde(m["score"], xt, JaxNoise(m["key"]),
                         PurifyConfig(t=T_STAR, grad_mode=mode))
        (grads[mode],) = torch.autograd.grad(out.square().sum(), xt)
    gap = float((grads["adjoint"] - grads["checkpoint"]).abs().max())
    assert 0 < gap < 0.1 * float(grads["checkpoint"].abs().max())


def test_grad_mode_none_stops_the_gradient(models):
    """'none' returns a result with no graph; a loss that adds a direct term
    in x gets only that term's gradient, as with JAX's stop_gradient."""
    m = models
    x = m["x01"] * 2.0 - 1.0
    w2 = normal(np.random.default_rng(5), 2, 16, 16, 3)
    jcfg = JaxPurifyConfig(t=T_STAR, grad_mode="none")
    want = jax.grad(lambda xx: jnp.sum(jnp.asarray(m["w"]) * jax_purify_sde(
        _jax_model(m), m["jparams"], xx, m["key"], jcfg)) + jnp.sum(w2 * xx))(
        jnp.asarray(x))
    np.testing.assert_array_equal(np32(want), w2)

    xt = torch.from_numpy(x).requires_grad_(True)
    out = purify_sde(m["score"], xt, JaxNoise(m["key"]),
                     PurifyConfig(t=T_STAR, grad_mode="none"))
    assert not out.requires_grad
    loss = (torch.from_numpy(m["w"]) * out).sum() + (torch.from_numpy(w2) * xt).sum()
    (got,) = torch.autograd.grad(loss, xt)
    np.testing.assert_array_equal(np32(got), w2)


def test_defended_model_input_grad_matches_jax(models):
    """d/dx of the summed logits of purify + classify (checkpoint mode)."""
    m = models
    jcfg = JaxPurifyConfig(t=T_STAR, grad_mode="checkpoint")
    jdm = JaxDefended(_jax_model(m), m["jparams"],
                      lambda p, x: m["jclf"].apply(p, x), m["jcparams"], jcfg,
                      log_every=0)
    want = jax.grad(lambda xx: jnp.sum(jdm(xx, m["key"])))(jnp.asarray(m["x01"]))
    dm = DefendedModel(m["score"], m["clf"], PurifyConfig(t=T_STAR), log_every=0)
    xt = torch.from_numpy(m["x01"]).requires_grad_(True)
    (got,) = torch.autograd.grad(dm(xt, JaxNoise(m["key"])).sum(), xt)
    assert_close(got, want, GRAD_REL, "d defended / dx")


def test_undefended_model_matches_jax(models):
    """purify is the identity; logits and their input gradient match."""
    m = models
    jum = JaxUndefended(lambda p, x: m["jclf"].apply(p, x), m["jcparams"])
    um = UndefendedModel(m["clf"])
    x = m["x01"]
    w = normal(np.random.default_rng(6), 2, 10)
    np.testing.assert_array_equal(np32(um.purify(torch.from_numpy(x), 0)), x)
    want_logits = jum(jnp.asarray(x), m["key"])
    want = jax.grad(lambda xx: jnp.sum(w * jum(xx, m["key"])))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = um(xt, 0)
    assert_close(logits, want_logits, 1e-4, "undefended logits")
    (got,) = torch.autograd.grad((torch.from_numpy(w) * logits).sum(), xt)
    assert_close(got, want, 1e-4, "d undefended / dx")


def test_attnblock_function_grads_match_jax():
    """dx and every weight gradient of the attention block's Function (its
    plain forward and autograd backward on the CPU) against jax.grad of the
    JAX custom_vjp block with the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(8)
    C = 32
    x = normal(rng, 2, 8, 8, C)
    p = attnblock_params(rng, C)
    g = normal(rng, 2, 8, 8, C)
    want = jax.grad(lambda xx, pp: jnp.sum(jnp.asarray(g) * jax_attnblock(
        xx, pp, 8, 1e-6, True, True)), argnums=(0, 1))(
        to_jax(x), tuple(to_jax(a) for a in p))
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = tuple(torch.from_numpy(a).requires_grad_(True) for a in p)
    launches = fab.fused_attnblock.launches
    out = fab.fused_attnblock(xt, pt, num_groups=8)
    got = torch.autograd.grad(out, (xt, *pt), torch.from_numpy(g))
    assert fab.fused_attnblock.launches == launches  # CPU: plain, no launch
    assert_close(got[0], want[0], 1e-5, "dx")
    for i, (a, b) in enumerate(zip(got[1:], want[1])):
        if i == 5:  # the key bias: softmax ignores it, both sides give rounding noise
            assert float(a.abs().max()) <= 1e-5 * float(np.abs(np32(want[0])).max())
            continue
        assert_close(a, b, 1e-5, f"dparam {i}")


def test_solvers_on_a_linear_sde_match_jax():
    """dx = -a x dt + s(t) dW with JAX's Brownian increments: the
    checkpointed solver gives the exact gradient prod(1 - a dt) of x(T);
    the adjoint's x- and a-gradients equal those of JAX's adjoint (which
    differ from the exact a-gradient by the adjoint's O(dt) error)."""
    key, n, t0, t1 = jax.random.PRNGKey(2), 20, 0.0, 1.0
    x0 = normal(np.random.default_rng(4), 3, 2, 2, 4)
    dw = [torch.from_numpy(np.array(jax_brownian(key, i, x0.shape, (t1 - t0) / n,
                                                 jnp.float32))) for i in range(n)]
    want = jax.grad(lambda p, xx: jnp.sum(jax_sdeint_em_adjoint(
        lambda pp, x, t: -pp * x, lambda t: 0.5 + t, p, xx, t0, t1, n, key)),
        argnums=(0, 1))(jnp.float32(0.7), jnp.asarray(x0))

    a = torch.tensor(0.7, requires_grad=True)
    drift = lambda x, t: -a * x  # noqa: E731
    diffusion = lambda t: 0.5 + t  # noqa: E731
    x = torch.from_numpy(x0).requires_grad_(True)
    got = torch.autograd.grad(sdeint_em_adjoint(drift, diffusion, x, t0, t1, n,
                                                dw.__getitem__, params=(a,)).sum(), (x, a))
    assert_close(got[0], want[1], 1e-6, "adjoint dx")
    assert_close(got[1], want[0], 1e-5, "adjoint da")

    x = torch.from_numpy(x0).requires_grad_(True)
    (dx,) = torch.autograd.grad(sdeint_em(drift, diffusion, x, t0, t1, n, dw.__getitem__,
                                          checkpoint=True).sum(), x)
    exact = np.float32((1 - 0.7 * (t1 - t0) / n) ** n)
    np.testing.assert_allclose(np32(dx), np.full(x0.shape, exact), rtol=1e-5)
