"""The port's StAdv attack and its driver against diffpure_tpu's (item 13).

Tolerance: 1e-5 absolute on grid_sample's values and both of its
gradients, the TV norm and the CW loss; stadv_attack's x_adv at 1e-5 and
its ``found`` equal, on a classifier that ignores its noise (both packages
then take the same keep-best decisions).

- ``identity_grid`` bit for bit (JAX's float32 formula, not affine_grid's);
- ``grid_sample`` at the identity grid, on random grids and on grids past
  [-1, 1] (zeros there), values and the gradients with respect to the
  image and to the grid;
- ``stadv_tv_norm`` (edge-replicated neighbours), ``_cw_f6`` with finite
  and infinite kappa, ``_constrain``;
- ``stadv_attack`` (5 iterations, 2 EOT samples), the Adam arithmetic
  included;
- ``eval_stadv`` / ``robustness_eval('stadv')``: the keys, the undefended
  baseline against JAX's, the saved adversarial images; the CLI's kwargs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffpure_tpu.attacks.stadv as jstadv
import diffpure_tpu.ops.grid_sample as jgs
from diffpure_tpu.eval.defended import DefendedModel as JaxDefended
from diffpure_tpu.eval.drivers import eval_stadv as jax_eval_stadv
from diffpure_tpu.purify import PurifyConfig as JaxPurifyConfig
from diffpure_tpu_torch import cli
from diffpure_tpu_torch.attacks import StAdvConfig, stadv_attack
from diffpure_tpu_torch.attacks.stadv import _constrain, _cw_f6, stadv_tv_norm
from diffpure_tpu_torch.config import build_parser
from diffpure_tpu_torch.eval import DefendedModel, eval_stadv, robustness_eval
from diffpure_tpu_torch.ops.grid_sample import grid_sample, identity_grid
from diffpure_tpu_torch.purify import PurifyConfig
from torch_parity import np32

ATOL = 1e-5


@pytest.mark.parametrize("hw", [(8, 8), (5, 7), (32, 32)])
def test_identity_grid_is_jax_bit_for_bit(hw):
    H, W = hw
    got = identity_grid(3, H, W).numpy()
    want = np.asarray(jgs.identity_grid(3, H, W))
    np.testing.assert_array_equal(got, want)


def _grids(kind, rng, N, H, W):
    ident = np.asarray(jgs.identity_grid(N, H, W))
    if kind == "identity":
        return ident.copy()
    if kind == "random":
        return (ident + rng.uniform(-0.3, 0.3, ident.shape)).astype(np.float32)
    return rng.uniform(-1.6, 1.6, ident.shape).astype(np.float32)  # past [-1, 1]


@pytest.mark.parametrize("kind", ["identity", "random", "outside"])
def test_grid_sample_and_its_gradients_match_jax(kind):
    rng = np.random.default_rng(0)
    N, H, W, C = 2, 6, 8, 3
    x = rng.uniform(size=(N, H, W, C)).astype(np.float32)
    grid = _grids(kind, rng, N, H, W)
    ct = rng.standard_normal((N, H, W, C)).astype(np.float32)
    want, vjp = jax.vjp(jgs.grid_sample, jnp.asarray(x), jnp.asarray(grid))
    wdx, wdg = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    tg = torch.from_numpy(grid).requires_grad_(True)
    got = grid_sample(tx, tg)
    gdx, gdg = torch.autograd.grad(got, (tx, tg), torch.from_numpy(ct))
    for g, w, what in ((got, want, "value"), (gdx, wdx, "d/dx"), (gdg, wdg, "d/dgrid")):
        np.testing.assert_allclose(np32(g), np.asarray(w), atol=ATOL, err_msg=what)
    if kind == "identity":
        np.testing.assert_allclose(np32(got), x, atol=1e-6)
    if kind == "outside":
        far = (np.abs(grid) > 1 + 1.0 / min(H, W)).any(-1)
        assert far.any() and not np.abs(np32(got)[far]).any()


def test_tv_norm_cw_and_constrain_match_jax():
    rng = np.random.default_rng(1)
    d = rng.standard_normal((3, 5, 6, 2)).astype(np.float32) * 0.1
    d[0] = 0.0  # a flat flow: sqrt(1e-10) per neighbour
    np.testing.assert_allclose(np32(stadv_tv_norm(torch.from_numpy(d))),
                               np.asarray(jstadv.stadv_tv_norm(jnp.asarray(d))), rtol=1e-6)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    y = rng.integers(0, 10, 6)
    for kappa in (float("inf"), 0.5, 0.0):
        np.testing.assert_allclose(
            np32(_cw_f6(torch.from_numpy(logits), torch.from_numpy(y), kappa)),
            np.asarray(jstadv._cw_f6(jnp.asarray(logits), jnp.asarray(y), kappa)), atol=ATOL)
    ident = identity_grid(2, 4, 4)
    g = (ident + torch.from_numpy(rng.uniform(-0.2, 0.2, ident.shape).astype(np.float32)) * 8)
    np.testing.assert_array_equal(
        np32(_constrain(g, ident, 0.05)),
        np.asarray(jstadv._constrain(jnp.asarray(np32(g)), jnp.asarray(np32(ident)), 0.05)))


def _linear_classifier(rng, H, W, C, K=10):
    Wm = (rng.standard_normal((H * W * C, K)) / np.sqrt(H * W * C)).astype(np.float32)
    b = rng.standard_normal(K).astype(np.float32) * 0.1
    jW, jb, tW, tb = jnp.asarray(Wm), jnp.asarray(b), torch.from_numpy(Wm), torch.from_numpy(b)
    return (lambda x, k: x.reshape(x.shape[0], -1) @ jW + jb,
            lambda x, s: x.reshape(x.shape[0], -1) @ tW + tb, Wm, b)


@pytest.mark.parametrize("kappa", [float("inf"), 1.0])
def test_stadv_attack_matches_jax(kappa):
    rng = np.random.default_rng(2)
    N, H, W, C = 4, 8, 8, 3
    jclf, tclf, Wm, b = _linear_classifier(rng, H, W, C)
    x = rng.uniform(size=(N, H, W, C)).astype(np.float32)
    y = np.argmax(x.reshape(N, -1) @ Wm + b, -1)
    cfg = dict(bound=0.05, n_iter=5, eot_iter=2, kappa=kappa)
    jx, jfound = jax.jit(lambda xx, yy: jstadv.stadv_attack(
        jclf, xx, yy, jax.random.PRNGKey(0), jstadv.StAdvConfig(**cfg)))(
            jnp.asarray(x), jnp.asarray(y))
    tx, tfound = stadv_attack(tclf, torch.from_numpy(x), torch.from_numpy(y), 0,
                              StAdvConfig(**cfg))
    np.testing.assert_allclose(np32(tx), np.asarray(jx), atol=ATOL)
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    assert not np.allclose(np32(tx), x)  # the attack moved the images
    assert tx.min() >= 0 and tx.max() <= 1


def test_stadv_iters_per_dispatch_changes_nothing():
    rng = np.random.default_rng(3)
    _, tclf, Wm, b = _linear_classifier(rng, 4, 4, 3)
    x = torch.from_numpy(rng.uniform(size=(2, 4, 4, 3)).astype(np.float32))
    y = torch.tensor([0, 1])
    a = stadv_attack(tclf, x, y, 7, StAdvConfig(n_iter=3))
    b_ = stadv_attack(tclf, x, y, 7, StAdvConfig(n_iter=3, iters_per_dispatch=1))
    torch.testing.assert_close(a[0], b_[0], rtol=0, atol=0)


def _tiny_defence(lib):
    """A linear epsilon model and a linear 10-class classifier on 4 x 4 x 3
    (tests/test_torch_bpda.py's), the t*=2 SDE purifier."""
    rng = np.random.RandomState(0)
    W = rng.randn(48, 48).astype(np.float32) * 0.01
    C = rng.randn(48, 10).astype(np.float32)
    if lib == "jax":
        return JaxDefended(
            lambda p, x, t: (x.reshape(x.shape[0], -1) @ p).reshape(x.shape), jnp.asarray(W),
            lambda p, x: x.reshape(x.shape[0], -1) @ p, jnp.asarray(C),
            JaxPurifyConfig(t=2), log_every=0)
    tW, tC = torch.from_numpy(W), torch.from_numpy(C)
    return DefendedModel(lambda x, t: (x.reshape(x.shape[0], -1) @ tW).reshape(x.shape),
                         lambda x: x.reshape(x.shape[0], -1) @ tC,
                         PurifyConfig(t=2), log_every=0)


def test_eval_stadv_and_dispatch(tmp_path):
    rng = np.random.RandomState(2)
    x = rng.rand(4, 4, 4, 3).astype(np.float32)
    C = np.random.RandomState(0).randn(48, 10).astype(np.float32)
    y = np.argmax(x.reshape(4, -1) @ C, -1)
    y[0] = (y[0] + 1) % 10  # one example wrong from the start
    kw = dict(bound=0.05, n_iter=3, eot_iter=2)
    want = jax_eval_stadv(_tiny_defence("jax"), jnp.asarray(x), jnp.asarray(y),
                          jax.random.PRNGKey(0), jstadv.StAdvConfig(**kw), log=lambda s: None)
    got = robustness_eval(_tiny_defence("torch"), torch.from_numpy(x), torch.from_numpy(y),
                          0, "stadv", log_dir=str(tmp_path), log=lambda s: None, **kw)
    assert set(got) == set(want) | {"x_adv"}
    # the undefended attack is deterministic: the same in both packages
    assert got["classifier_robust_acc"] == want["classifier_robust_acc"]
    for k in ("defended_clean_acc", "defended_robust_acc"):
        assert 0.0 <= got[k] <= 0.75
    for name in ("x_adv_classifier_stadv.npy", "x_adv_defended_stadv.npy"):
        saved = np.load(tmp_path / name)
        assert saved.shape == x.shape and saved.min() >= 0 and saved.max() <= 1
    np.testing.assert_array_equal(np.load(tmp_path / "x_adv_defended_stadv.npy"),
                                  np32(got["x_adv"]))
    direct = eval_stadv(_tiny_defence("torch"), torch.from_numpy(x), torch.from_numpy(y), 0,
                        StAdvConfig(**kw), log=lambda s: None)
    np.testing.assert_array_equal(np32(direct["x_adv"]), np32(got["x_adv"]))


def test_cli_stadv_kwargs_are_jax_s():
    args = build_parser().parse_args(["--config", "cifar10.yml", "--attack_version", "stadv",
                                      "--adv_eps", "0.05", "--eot_iter", "20"])
    assert cli._attack_kwargs(args) == dict(bound=0.05, n_iter=100, eot_iter=20,
                                            iters_per_dispatch=0)
    StAdvConfig(**cli._attack_kwargs(args))
