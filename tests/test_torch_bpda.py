"""The port's BPDA+EOT attack and its drivers against diffpure_tpu's.

- ``_pgd_update`` (l_inf with sign(0) == 0, l_2 with both norm clamps);
- ``bpda_eot_attack`` end to end on a linear classifier with purifiers
  that ignore their noise, so both packages take the same decisions: the
  same ``class_batch`` and ``x_adv`` to 1e-6, monolithic and chunked
  attack reps, and a purifier that answers the attack reps and the defence
  vote differently, so that flip candidates are verified and kept;
- ``_rep_predict`` / ``_attack_grad_core`` with a purifier that adds a
  fixed table by rep position (rep-major tiling, sums across chunks);
- the gradient pulled back through the 8 -> 12 bilinear resize against
  ``jax.vjp`` of ``jax.image.resize``;
- the NFE ledger's totals of a BPDA run against JAX's;
- ``eval_bpda`` / ``robustness_eval``: dispatch, the undefended baseline
  against JAX's, the saved adversarial images.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffpure_tpu.attacks.bpda_eot as jbpda
import diffpure_tpu_torch.attacks.bpda_eot as bpda
from diffpure_tpu.eval.defended import DefendedModel as JaxDefended
from diffpure_tpu.eval.drivers import eval_bpda as jax_eval_bpda
from diffpure_tpu.purify import PurifyConfig as JaxPurifyConfig
from diffpure_tpu.utils.profiling import count_nfe as jax_count_nfe
from diffpure_tpu.utils.profiling import record_nfe as jax_record_nfe
from diffpure_tpu_torch.attacks import BPDAEOTConfig, bpda_eot_attack
from diffpure_tpu_torch.eval import DefendedModel, eval_bpda, robustness_eval
from diffpure_tpu_torch.eval.defended import bilinear_resize
from diffpure_tpu_torch.purify import PurifyConfig
from diffpure_tpu_torch.utils.profiling import count_nfe, record_nfe
from torch_parity import assert_close, np32

D = 16  # 4 x 4 x 1 images


@pytest.fixture
def linear():
    """The 2-class linear model of tests/test_attacks.py::linear_setup with
    a bias that brings its margins within an l_inf ball of 0.1, in both
    packages; its inputs, its labels and its weight as an image."""
    rng = np.random.RandomState(0)
    w = rng.randn(D).astype(np.float32)
    W = np.stack([w, -w], axis=1) * 0.5
    b = np.array([-2.5, 2.5], np.float32)
    x = (rng.rand(6, 4, 4, 1) * 0.5 + 0.25).astype(np.float32)
    y = np.argmax(x.reshape(6, -1) @ W + b, -1)
    jW, jb, tW, tb = jnp.asarray(W), jnp.asarray(b), torch.from_numpy(W), torch.from_numpy(b)
    return dict(x=x, y=y, w=w.reshape(4, 4, 1),
                jclf=lambda p: p.reshape(p.shape[0], -1) @ jW + jb,
                tclf=lambda p: p.reshape(p.shape[0], -1) @ tW + tb)


def _run_both(linear, jpurify, tpurify, cfg_kw):
    x, y = linear["x"], linear["y"]
    xa_j, cb_j = jbpda.bpda_eot_attack(jpurify, linear["jclf"], jnp.asarray(x),
                                       jnp.asarray(y), jax.random.PRNGKey(0),
                                       jbpda.BPDAEOTConfig(**cfg_kw))
    xa_t, cb_t = bpda_eot_attack(tpurify, linear["tclf"], torch.from_numpy(x),
                                 torch.from_numpy(y), 0, BPDAEOTConfig(**cfg_kw))
    return (xa_j, cb_j), (xa_t, cb_t)


@pytest.mark.parametrize("norm", ["l_inf", "l_2"])
def test_pgd_update_matches_jax(norm):
    rng = np.random.default_rng(1)
    x0 = rng.uniform(size=(4, 4, 4, 3)).astype(np.float32)
    x_adv = np.clip(x0 + rng.uniform(-0.05, 0.05, x0.shape), 0, 1).astype(np.float32)
    grad = rng.standard_normal(x0.shape).astype(np.float32)
    grad[0, 0, 0] = 0.0  # sign(0) == 0 in both
    grad[1] = 0.0        # a zero gradient: the l_2 norm clamp
    x_adv[2] = x0[2]     # a zero step so far: the l_2 distance clamp
    cfg = dict(adv_eps=0.1, adv_eta=0.03, attack_norm=norm)
    want = jbpda._pgd_update(jnp.asarray(x_adv), jnp.asarray(grad), jnp.asarray(x0),
                             jbpda.BPDAEOTConfig(**cfg))
    got = bpda._pgd_update(torch.from_numpy(x_adv), torch.from_numpy(grad),
                           torch.from_numpy(x0), BPDAEOTConfig(**cfg))
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-6, rtol=0)
    assert np.isfinite(np32(got)).all()


BASE = dict(adv_eps=0.1, adv_eta=0.02, adv_steps=4, eot_defense_reps=4,
            eot_attack_reps=5, defense_batch=2)


@pytest.mark.parametrize("attack_batch", [0, 2])
def test_bpda_eot_attack_matches_jax(linear, attack_batch):
    """A purifier that ignores its noise: both packages decide alike."""
    (xa_j, cb_j), (xa_t, cb_t) = _run_both(
        linear, lambda xx, k: jnp.clip(xx * 0.9 + 0.05, 0, 1),
        lambda xx, s: torch.clamp(xx * 0.9 + 0.05, 0, 1),
        dict(BASE, attack_batch=attack_batch))
    assert cb_t.shape == (BASE["adv_steps"] + 2, 6) and cb_t.dtype == bool
    np.testing.assert_array_equal(cb_t, cb_j)
    np.testing.assert_allclose(np32(xa_t), np32(xa_j), atol=1e-6, rtol=0)
    assert cb_t[0].any() and not cb_t[-1].all()  # some fall in the 0.1 ball


def test_bpda_flips_are_verified(linear):
    """The attack reps (a call of 5 x 6 images) see the images moved
    against the classifier's weight, the defence vote (calls of 2 x 6) sees
    them as they are: at step 1 the flip candidates are verified and kept,
    later ones fall."""
    push = 0.04

    def jpurify(xx, k):
        return xx - push * jnp.asarray(linear["w"]) if xx.shape[0] == 30 else xx

    def tpurify(xx, s):
        calls.append(xx.shape[0])
        return xx - push * torch.from_numpy(linear["w"]) if xx.shape[0] == 30 else xx

    calls = []
    (xa_j, cb_j), (xa_t, cb_t) = _run_both(linear, jpurify, tpurify,
                                           dict(BASE, adv_steps=6))
    np.testing.assert_array_equal(cb_t, cb_j)
    np.testing.assert_allclose(np32(xa_t), np32(xa_j), atol=1e-6, rtol=0)
    # the clean vote (2 chunks), steps 0 and 1, then step 1's verification
    assert calls[:6] == [12, 12, 30, 30, 12, 12]
    assert cb_t[2].all()  # ... which kept every candidate
    counts = cb_t.sum(1)
    assert (np.diff(counts[1:]) <= 0).all() and counts[-1] < counts[1]


class Table:
    """A purifier that adds table[j] to the images of rep position j in its
    call (reps tiled rep-major: image j * B + b is rep j of example b)."""

    def __init__(self, B, reps, lib):
        self.B = B
        self.table = np.random.default_rng(4).normal(0, 0.3, (reps, 4, 4, 1)).astype(np.float32)
        self.lib = lib

    def __call__(self, xx, key):
        n = xx.shape[0] // self.B
        t = np.repeat(self.table[:n], self.B, axis=0)
        return xx + (jnp.asarray(t) if self.lib == "jax" else torch.from_numpy(t))


def _mlp(lib):
    rng = np.random.RandomState(5)
    w1 = rng.randn(D, 8).astype(np.float32)
    w2 = rng.randn(8, 3).astype(np.float32)
    if lib == "jax":
        return lambda p: jnp.tanh(p.reshape(p.shape[0], -1) @ w1) @ w2
    w1, w2 = torch.from_numpy(w1), torch.from_numpy(w2)
    return lambda p: torch.tanh(p.reshape(p.shape[0], -1) @ w1) @ w2


def test_rep_predict_and_attack_grad_match_jax():
    """reps = 5 in chunks of 2: positions 0, 1 | 0, 1 | 0 of the table."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(3, 4, 4, 1)).astype(np.float32)
    y = np.array([0, 2, 1])
    want = jbpda._rep_predict(Table(3, 5, "jax"), _mlp("jax"), jnp.asarray(x),
                              jax.random.PRNGKey(0), 5, 2)
    got = bpda._rep_predict(Table(3, 5, "torch"), _mlp("torch"), torch.from_numpy(x),
                            0, 5, 2)
    assert_close(got, want, 1e-6, "rep_predict")

    jps, jgs, _ = jbpda._attack_grad_core(Table(3, 5, "jax"), _mlp("jax"), jnp.asarray(x),
                                          jnp.asarray(y), jax.random.PRNGKey(0), 5,
                                          jbpda.BPDAEOTConfig())
    tps, tgs = bpda._attack_grad_core(Table(3, 5, "torch"), _mlp("torch"),
                                      torch.from_numpy(x), torch.from_numpy(y), 0, 5)
    assert_close(tps, jps, 1e-6, "probability sum")
    assert_close(tgs, jgs, 1e-5, "gradient sum")

    # chunked: 2 + 2 + 1 attack reps, summed across chunks, normalised once
    cfg = dict(eot_attack_reps=5, attack_batch=2)
    key = jax.random.PRNGKey(0)
    jc, jg = jbpda._attack_grad(Table(3, 5, "jax"), _mlp("jax"), jnp.asarray(x),
                                jnp.asarray(y), key, jbpda.BPDAEOTConfig(
                                    eot_attack_reps=5))[:2]
    chunks = [jbpda._attack_grad_core(Table(3, 5, "jax"), _mlp("jax"), jnp.asarray(x),
                                      jnp.asarray(y), key, n, None)[1] for n in (2, 2, 1)]
    tc, tg = bpda._attack_grad(Table(3, 5, "torch"), _mlp("torch"), torch.from_numpy(x),
                               torch.from_numpy(y), 0, BPDAEOTConfig(**cfg))
    assert_close(tg, sum(chunks) / 5, 1e-5, "chunked gradient")
    assert not np.allclose(np32(tg), np32(jg), atol=1e-4)  # the positions differ
    assert tc.dtype == torch.bool and tc.shape == (3,)


def test_resize_adjoint_gradient_matches_jax():
    """Purifier at 12 x 12 for 8 x 8 inputs: the gradient comes back through
    the exact adjoint of the bilinear upsize."""
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    y = np.array([1, 0])
    w = rng.standard_normal((12 * 12 * 3, 4)).astype(np.float32) * 0.1
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    _, jgs, _ = jbpda._attack_grad_core(
        lambda xx, k: jax.image.resize(xx, (xx.shape[0], 12, 12, 3), "bilinear"),
        lambda p: jnp.tanh(p.reshape(p.shape[0], -1) @ jw), jnp.asarray(x),
        jnp.asarray(y), jax.random.PRNGKey(0), 3, jbpda.BPDAEOTConfig())
    _, tgs = bpda._attack_grad_core(
        lambda xx, s: bilinear_resize(xx, 12),
        lambda p: torch.tanh(p.reshape(p.shape[0], -1) @ tw), torch.from_numpy(x),
        torch.from_numpy(y), 0, 3)
    assert tgs.shape == x.shape
    assert_close(tgs, jgs, 1e-5, "resize-adjoint gradient")


@pytest.mark.parametrize("attack_batch", [0, 2])
def test_bpda_nfe_totals_match_jax(linear, attack_batch):
    """Every purify call's evaluations reach the ledger once, in both
    packages: the defence vote's chunks, each PGD step's attack reps
    (chunked or not) and the verifications."""
    def jpurify(xx, k):
        jax_record_nfe("toy", 3)
        return jnp.clip(xx * 0.9 + 0.05, 0, 1)

    def tpurify(xx, s):
        record_nfe("toy", 3)
        return torch.clamp(xx * 0.9 + 0.05, 0, 1)

    cfg = dict(BASE, attack_batch=attack_batch)
    with jax_count_nfe() as cj, count_nfe() as ct:
        (_, cb_j), (_, cb_t) = _run_both(linear, jpurify, tpurify, cfg)
    np.testing.assert_array_equal(cb_t, cb_j)
    assert dict(ct.counts) == dict(cj.counts) and ct.total() > 0
    # defence vote 2 chunks; 5 steps of 1 call (or 3 chunks); verifications
    per_step = 1 if attack_batch == 0 else 3
    verifications = (ct.total() // 3 - 2 - 5 * per_step) // 2
    assert ct.total() == 3 * (2 + 5 * per_step + 2 * verifications)


def _tiny_defence(lib):
    """A linear epsilon model and a linear 10-class classifier on 4 x 4 x 3."""
    rng = np.random.RandomState(0)
    W = rng.randn(48, 48).astype(np.float32) * 0.01
    C = rng.randn(48, 10).astype(np.float32)
    if lib == "jax":
        return JaxDefended(
            lambda p, x, t: (x.reshape(x.shape[0], -1) @ p).reshape(x.shape), jnp.asarray(W),
            lambda p, x: x.reshape(x.shape[0], -1) @ p, jnp.asarray(C),
            JaxPurifyConfig(t=2, grad_mode="none"), log_every=0)
    tW, tC = torch.from_numpy(W), torch.from_numpy(C)
    return DefendedModel(lambda x, t: (x.reshape(x.shape[0], -1) @ tW).reshape(x.shape),
                         lambda x: x.reshape(x.shape[0], -1) @ tC,
                         PurifyConfig(t=2, grad_mode="none"), log_every=0)


def test_eval_bpda_and_dispatch(tmp_path):
    rng = np.random.RandomState(2)
    x = rng.rand(4, 4, 4, 3).astype(np.float32)
    C = np.random.RandomState(0).randn(48, 10).astype(np.float32)
    y = np.argmax(x.reshape(4, -1) @ C, -1)
    y[0] = (y[0] + 1) % 10  # one example wrong from the start
    kw = dict(adv_eps=0.05, adv_eta=0.02, adv_steps=2, eot_defense_reps=2,
              eot_attack_reps=2, defense_batch=2)
    want = jax_eval_bpda(_tiny_defence("jax"), jnp.asarray(x), jnp.asarray(y),
                         jax.random.PRNGKey(0), jbpda.BPDAEOTConfig(**kw),
                         log=lambda s: None)
    dm = _tiny_defence("torch")
    with count_nfe() as c:
        got = robustness_eval(dm, torch.from_numpy(x), torch.from_numpy(y), 0, "bpda",
                              log_dir=str(tmp_path), log=lambda s: None, **kw)
    assert set(got) == set(want) | {"x_adv"}
    # the undefended baseline is deterministic: the same in both packages
    for k in ("classifier_init_acc", "classifier_robust_acc"):
        assert got[k] == want[k]
    assert got["class_batch"].shape == (4, 4) and got["init_acc"] <= 0.75
    assert c.counts["sde_euler"] >= 2 * (1 + 3)
    saved = np.load(tmp_path / "x_adv_bpda.npy")
    np.testing.assert_array_equal(saved, np32(got["x_adv"]))
    assert np.abs(saved - x).max() <= kw["adv_eps"] + 1e-6

    direct = eval_bpda(dm, torch.from_numpy(x), torch.from_numpy(y), 0,
                       BPDAEOTConfig(**kw), log=lambda s: None, run_baseline=False)
    assert "classifier_init_acc" not in direct
    np.testing.assert_array_equal(direct["class_batch"], got["class_batch"])

    rand = robustness_eval(dm, torch.from_numpy(x), torch.from_numpy(y), 0, "custom",
                           log=lambda s: None, attacks_to_run=())
    assert set(rand) == {"classifier_robust_acc", "defended_robust_acc", "x_adv"}
    # 'stadv' dispatches to eval_stadv since item 13 (test_torch_stadv.py)
    stadv = robustness_eval(dm, torch.from_numpy(x), torch.from_numpy(y), 0, "stadv",
                            log=lambda s: None, n_iter=1)
    assert set(stadv) == {"classifier_robust_acc", "defended_clean_acc",
                          "defended_robust_acc", "x_adv"}
    with pytest.raises(ValueError, match="unknown attack version"):
        robustness_eval(dm, torch.from_numpy(x), torch.from_numpy(y), 0, "fgsm")
