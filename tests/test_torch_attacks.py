"""The port's attack layer against diffpure_tpu's.

- the losses (CE, DLR, targeted DLR, margin, CW-f6) on the same logits;
- an APGD trajectory against JAX's ``_apgd_single_run`` on the
  deterministic MLP of tests/test_apgd_parity.py, with JAX's initial
  perturbation injected: the same step-size (halving) sequence, the same
  flips, the losses to float tolerance; CE and DLR, each in Linf and L2
  (rand's L2 suite runs both: run_cifar_rand_L2.sh), and EOT 'last'
  (several repetitions of a deterministic model);
- ``apgd_attack`` with restarts and the targeted variant, with a fixed
  initial point in both packages: the same flips and points;
- ``AutoAttack`` rand's robust-flags protocol, with APGD replaced by the
  same deterministic stand-in in both packages;
- ``eval_autoattack`` on a tiny defence (smoke).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffpure_tpu.attacks.apgd as jax_apgd_mod
import diffpure_tpu.attacks.autoattack as jax_aa_mod
import diffpure_tpu_torch.attacks.apgd as apgd_mod
import diffpure_tpu_torch.attacks.autoattack as aa_mod
from diffpure_tpu.attacks import losses as jax_losses
from diffpure_tpu.attacks.apgd import APGDConfig as JaxAPGDConfig
from diffpure_tpu.attacks.autoattack import AutoAttack as JaxAutoAttack
from diffpure_tpu.attacks.autoattack import AutoAttackConfig as JaxAAConfig
from diffpure_tpu_torch.attacks import APGDConfig, AutoAttack, \
    AutoAttackConfig, apgd_attack
from diffpure_tpu_torch.attacks import losses
from diffpure_tpu_torch.classifiers import WideResNet
from diffpure_tpu_torch.eval import DefendedModel, eval_autoattack
from diffpure_tpu_torch.models import NCSNpp
from diffpure_tpu_torch.purify import PurifyConfig
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from test_apgd_parity import make_model
from torch_parity import assert_close, np32

LOSSES = ["ce_loss", "dlr_loss", "dlr_loss_targeted", "margin_loss", "cw_f6_loss"]


@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax(name):
    rng = np.random.default_rng(LOSSES.index(name))
    logits = rng.standard_normal((16, 10)).astype(np.float32) * 3
    logits[0, 4] = logits[0].max()  # a tie at the top
    y = rng.integers(0, 10, 16)
    y[0] = 4
    args = (y, (y + 1 + rng.integers(0, 9, 16)) % 10)[:2 if name.endswith("targeted") else 1]
    want = getattr(jax_losses, name)(jnp.asarray(logits), *map(jnp.asarray, args))
    got = getattr(losses, name)(torch.from_numpy(logits), *map(torch.from_numpy, args))
    assert_close(got, want, 1e-6, name)


def _mlp(n_classes, seed=0, d=48):
    """The torch twin of test_apgd_parity.make_model (noise_scale 0)."""
    rng = np.random.RandomState(seed)
    w1 = torch.from_numpy(rng.randn(d, 32).astype(np.float32) * 0.5)
    w2 = torch.from_numpy(rng.randn(32, n_classes).astype(np.float32) * 0.5)
    return lambda x, seed: torch.tanh(x.reshape(x.shape[0], -1) @ w1) @ w2


@pytest.fixture
def data():
    rng = np.random.RandomState(3)
    return rng.rand(6, 4, 4, 3).astype(np.float32), rng.randint(0, 5, 6)


# JAX's own battery (tests/test_apgd_parity.py), and DLR in L2: (loss, norm,
# eot_iter, n_classes, iterations over which the losses are compared: DLR's
# rational form amplifies ulp differences of the two frameworks' model
# evaluations). DLR-L2 runs on the 5-class model: on the 10-class one an
# example's label is its third-largest logit, where DLR is constant (1), so
# its gradient is rounding noise, which the L2 step normalises to a full
# step in each framework's own direction, and late halvings part.
TRAJ = [("ce", "Linf", 1, 5, 100), ("dlr", "Linf", 1, 10, 1), ("ce", "L2", 1, 5, 100),
        ("ce", "Linf", 3, 5, 100), ("dlr", "L2", 1, 5, 1)]


@pytest.mark.parametrize("loss,norm,eot_iter,n_classes,prefix", TRAJ)
def test_apgd_trajectory_matches_jax(data, loss, norm, eot_iter, n_classes, prefix):
    x, y = data
    key = jax.random.PRNGKey(42)
    cfg = dict(norm=norm, eps=0.1, n_iter=100, eot_iter=eot_iter, loss=loss,
               eot_loss="last")
    jloss = {"ce": jax_losses.ce_loss, "dlr": jax_losses.dlr_loss}[loss]
    want_x, want_found, _, want = jax_apgd_mod._apgd_single_run(
        make_model(n_classes=n_classes), lambda lg: jloss(lg, jnp.asarray(y)),
        jnp.asarray(x), jnp.asarray(y), key, JaxAPGDConfig(**cfg), collect_trajectory=True)
    x_init = jax_apgd_mod._init_perturbation(jax.random.split(key)[0], jnp.asarray(x),
                                             JaxAPGDConfig(**cfg))

    tloss = {"ce": losses.ce_loss, "dlr": losses.dlr_loss}[loss]
    yt = torch.from_numpy(y)
    got_x, got_found, _, got = apgd_mod._apgd_single_run(
        _mlp(n_classes), lambda lg: tloss(lg, yt), torch.from_numpy(x), yt, 0,
        APGDConfig(**cfg), collect_trajectory=True, x_init=torch.from_numpy(np.array(x_init, np.float32)))
    np.testing.assert_array_equal(np32(got["step_size"]), np32(want["step_size"]))
    assert (np32(got["step_size"])[-1] < 0.2).any()  # the run did halve
    np.testing.assert_array_equal(got_found.numpy(), np.asarray(want_found))
    np.testing.assert_allclose(np32(got["losses"])[:prefix], np32(want["losses"])[:prefix],
                               rtol=2e-5, atol=2e-5)
    if norm == "Linf":  # the final points differ where a gradient is ~0 (its sign)
        assert float((got_x - torch.from_numpy(x)).abs().max()) <= 0.1 + 1e-6


def _fixed_init(xp):
    """A deterministic initial point, the same in both packages."""
    def init(seed, x, cfg):
        pattern = xp.sign(xp.sin(xp.arange(x.size, dtype=xp.float32) + 0.5))
        return xp.clip(x + 0.5 * cfg.eps * pattern.reshape(x.shape), 0.0, 1.0)
    return init


@pytest.mark.parametrize("loss,restarts", [("ce", 2), ("dlr-targeted", 1)])
def test_apgd_attack_matches_jax(data, monkeypatch, loss, restarts):
    """Restarts keep the first flip; APGD-T walks the targets from the
    second most probable class on. Same model, same initial point."""
    x, y = data
    monkeypatch.setattr(jax_apgd_mod, "_init_perturbation", _fixed_init(jnp))
    torch_init = _fixed_init(np)
    monkeypatch.setattr(apgd_mod, "_init_perturbation", lambda s, xx, cfg: torch.from_numpy(
        torch_init(s, xx.numpy(), cfg).astype(np.float32)))
    cfg = dict(norm="Linf", eps=0.05, n_iter=20, n_restarts=restarts, loss=loss,
               n_target_classes=3)
    want_x, want_found = jax_apgd_mod.apgd_attack(
        make_model(n_classes=10), jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1),
        JaxAPGDConfig(**cfg))
    got_x, got_found = apgd_attack(_mlp(10), torch.from_numpy(x), torch.from_numpy(y), 1,
                                   APGDConfig(**cfg))
    np.testing.assert_array_equal(got_found.numpy(), np.asarray(want_found))
    assert got_found.any()
    np.testing.assert_allclose(np32(got_x), np32(want_x), rtol=1e-5, atol=1e-5)


def test_autoattack_rand_protocol_matches_jax(monkeypatch):
    """Each phase attacks only the still-robust examples, in power-of-two
    buckets capped at bs and padded with duplicates; robust flags and x_adv
    follow the flips. APGD is replaced by one deterministic stand-in in both
    packages (its own parity is tested above)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(11, 4, 4, 3)).astype(np.float32)
    w = rng.standard_normal((48, 5)).astype(np.float32)
    y = (x.reshape(11, -1) @ w).argmax(-1)
    y[:2] = (y[:2] + 1) % 5  # two examples start misclassified
    calls = {"jax": [], "torch": []}

    def stand_in(tag):
        def attack(model_fn, xx, yy, key, cfg):
            calls[tag].append((cfg.loss, int(xx.shape[0]), cfg.eot_iter, cfg.n_iter))
            ch = {"ce": 0, "dlr": 1}[cfg.loss]
            found = xx[:, 0, 0, ch] > 0.6
            return xx + 0.01 * (ch + 1), found
        return attack

    monkeypatch.setattr(jax_aa_mod, "apgd_attack", stand_in("jax"))
    monkeypatch.setattr(aa_mod, "apgd_attack", stand_in("torch"))
    kw = dict(version="rand", eot_iter=4, n_iter=7)
    jaa = JaxAutoAttack(lambda xx, k: xx.reshape(xx.shape[0], -1) @ jnp.asarray(w),
                        JaxAAConfig(**kw), log_fn=lambda s: None)
    want_x, want_robust = jaa.run_standard_evaluation(jnp.asarray(x), jnp.asarray(y),
                                                      jax.random.PRNGKey(0), bs=4)
    aa = AutoAttack(lambda xx, s: xx.reshape(xx.shape[0], -1) @ torch.from_numpy(w),
                    AutoAttackConfig(**kw), log_fn=lambda s: None)
    got_x, got_robust = aa.run_standard_evaluation(torch.from_numpy(x), torch.from_numpy(y),
                                                   0, bs=4)
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) > 2
    assert aa.phase_batch_sizes == jaa.phase_batch_sizes
    assert [(r[0], r[2]) for r in aa.phase_results] == [(r[0], r[2]) for r in jaa.phase_results]
    assert [r[1] for r in aa.phase_results] == pytest.approx([r[1] for r in jaa.phase_results])
    np.testing.assert_array_equal(got_robust.numpy(), np.asarray(want_robust))
    np.testing.assert_array_equal(np32(got_x), np32(want_x))


def test_unported_attacks_raise():
    """Every attack of the suites is ported (FAB-T and Square since ROADMAP
    item 12); a name outside them raises."""
    assert AutoAttack(lambda x, s: x, AutoAttackConfig(version="standard")).attacks == [
        "apgd-ce", "apgd-t", "fab-t", "square"]
    AutoAttack(lambda x, s: x, AutoAttackConfig(version="custom",
                                                attacks_to_run=("square", "fab-t")))
    AutoAttack(lambda x, s: x, AutoAttackConfig(version="custom",
                                                attacks_to_run=("apgd-t",)))
    with pytest.raises(ValueError, match="unknown attacks"):
        AutoAttack(lambda x, s: x, AutoAttackConfig(version="custom",
                                                    attacks_to_run=("fab",)))


def test_eval_autoattack_on_a_tiny_defence(tmp_path):
    """The entry point end to end on the CPU: a small NCSN++ + WRN-10-1 at
    t*=2, AutoAttack rand with EOT; x_adv stays in the eps-ball and [0, 1]
    and the accuracies are fractions."""
    score = NCSNpp(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                   image_size=16).eval()
    clf = WideResNet(depth=10, widen_factor=1).eval()
    for m, seed in ((score, 0), (clf, 1)):
        sd = seeded_normal_state_dict(m, seed)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        m.requires_grad_(False)
    dm = DefendedModel(score, clf, PurifyConfig(t=2), log_every=0)
    x = torch.from_numpy(np.random.default_rng(1).uniform(size=(3, 16, 16, 3))
                         .astype(np.float32))
    with torch.no_grad():
        y = clf(x).argmax(-1)  # the undefended suite starts all robust
    cfg = AutoAttackConfig(version="rand", eot_iter=2, n_iter=2, eps=8 / 255)
    res = eval_autoattack(dm, x, y, 3, cfg, log_dir=str(tmp_path), log=lambda s: None)
    for k in ("classifier_robust_acc", "defended_robust_acc"):
        assert 0.0 <= res[k] <= 1.0
    x_adv = res["x_adv"]
    assert x_adv.shape == x.shape and bool(torch.isfinite(x_adv).all())
    assert float((x_adv - x).abs().max()) <= cfg.eps + 1e-6
    assert 0.0 <= float(x_adv.min()) and float(x_adv.max()) <= 1.0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "x_adv_classifier_rand.npy", "x_adv_defended_rand.npy"]
