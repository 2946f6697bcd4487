"""The port's AutoAttack standard suite against diffpure_tpu's (ROADMAP item
12): FAB-T, Square and the suite that runs them.

- FAB's box-constrained hyperplane projections (Linf, L2) at 1e-5, and
  ``fab_attack`` in Linf and L2 on the deterministic 5-class MLP of
  tests/test_apgd_parity.py (there the argmax and improvement decisions
  agree between the frameworks): the same found flags, x_adv at 1e-5;
- Square in Linf and L2 with the same injected draws (JAX's ``draws=``):
  the same accepted queries (each side's decisions from its own model
  outputs), x_adv at 1e-6 and the same found flags (the candidates of
  rejected L2 queries may part by about 1e-6: float32 norms summed in
  another order); the L2 init's cell grid with an odd and an even number
  of cells; ``_p_selection`` and ``_eta_pattern`` exactly;
- ``AutoAttack(version='standard')``: APGD-CE, APGD-T, FAB-T and Square
  in that order, the same phase sizes, robust flags and x_adv as JAX's
  (APGD and Square replaced by one deterministic stand-in in both
  packages, FAB run for real), and the on_phase hook.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffpure_tpu.attacks.autoattack as jax_aa_mod
import diffpure_tpu.attacks.fab as jfab
import diffpure_tpu.attacks.square as jsq
import diffpure_tpu_torch.attacks.autoattack as aa_mod
from diffpure_tpu.attacks.autoattack import AutoAttack as JaxAutoAttack
from diffpure_tpu.attacks.autoattack import AutoAttackConfig as JaxAAConfig
from diffpure_tpu_torch.attacks import AutoAttack, AutoAttackConfig, FABConfig, \
    SquareConfig, fab_attack, square_attack
from diffpure_tpu_torch.attacks import fab, square
from test_apgd_parity import make_model
from test_torch_attacks import _mlp
from torch_parity import np32
from torch_parity import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")


@pytest.mark.parametrize("norm", ["Linf", "L2"])
def test_projections_match_jax(norm):
    """Feasible and infeasible right-hand sides, several dimensions."""
    rng = np.random.default_rng(0 if norm == "Linf" else 1)
    jproj = {"Linf": jfab._proj_hyperplane_box_linf, "L2": jfab._proj_hyperplane_box_l2}[norm]
    tproj = {"Linf": fab._proj_hyperplane_box_linf, "L2": fab._proj_hyperplane_box_l2}[norm]
    for shape in ((5, 4, 4, 3), (3, 8, 8, 3), (4, 2, 2, 1)):
        x = rng.uniform(size=shape).astype(np.float32)
        w = rng.standard_normal(shape).astype(np.float32)
        shift = rng.normal(0, 0.3, shape).astype(np.float32)
        b = ((x + shift) * w).reshape(shape[0], -1).sum(-1).astype(np.float32)
        b[0] += 1e3  # out of reach
        want = jproj(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        got = tproj(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
        np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=1e-5)


@pytest.fixture
def data():
    """Six 4x4x3 images, labelled by the 5-class model so all start right."""
    x = np.random.RandomState(3).rand(6, 4, 4, 3).astype(np.float32)
    with torch.no_grad():
        y = _mlp(5)(torch.from_numpy(x), 0).argmax(-1).numpy()
    return x, y


@pytest.mark.parametrize("norm,eps", [("Linf", 0.05), ("L2", 0.3)])
def test_fab_attack_matches_jax(data, norm, eps):
    x, y = data
    kw = dict(norm=norm, eps=eps, n_iter=20, n_target_classes=3)
    want_x, want_found = jfab.fab_attack(make_model(n_classes=5), jnp.asarray(x),
                                         jnp.asarray(y), jax.random.PRNGKey(1),
                                         jfab.FABConfig(**kw))
    got_x, got_found = fab_attack(_mlp(5), torch.from_numpy(x), torch.from_numpy(y), 1,
                                  FABConfig(**kw))
    np.testing.assert_array_equal(got_found.numpy(), np.asarray(want_found))
    assert got_found.any() and not got_found.all()
    np.testing.assert_allclose(np32(got_x), np32(want_x), rtol=0, atol=1e-5)


def _sq_model(d, seed=1):
    """test_square_parity.make_model in both packages (5 classes)."""
    rng = np.random.RandomState(seed)
    W1 = (rng.randn(d, 32) * 0.5).astype(np.float32)
    W2 = (rng.randn(32, 5) * 0.5).astype(np.float32)
    jW1, jW2, tW1, tW2 = jnp.asarray(W1), jnp.asarray(W2), torch.from_numpy(W1), \
        torch.from_numpy(W2)
    calls = {"jax": [], "torch": []}

    def jmodel(x, key):
        out = jnp.tanh(x.reshape(x.shape[0], -1) @ jW1) @ jW2
        # ordered: the calls land in query order under jit as well
        jax.debug.callback(lambda o: calls["jax"].append(np.asarray(o)), out, ordered=True)
        return out

    def tmodel(x, seed):
        out = torch.tanh(x.reshape(x.shape[0], -1) @ tW1) @ tW2
        calls["torch"].append(out.numpy().copy())
        return out

    return jmodel, tmodel, calls


def _draws(rng, norm, eps, B, H, W, C, n):
    if norm == "Linf":
        sizes = jsq_linf_sizes(H, W, C, n)
        return dict(
            stripes=(rng.randint(0, 2, (B, 1, W, C)) * 2 - 1).astype(np.float32) * eps,
            vh=np.stack([rng.randint(0, H - s + 1, B) for s in sizes]).astype(np.int32),
            vw=np.stack([rng.randint(0, W - s + 1, B) for s in sizes]).astype(np.int32),
            color=(rng.randint(0, 2, (n, B, 1, 1, C)) * 2 - 1).astype(np.float32) * eps)
    sizes = square.l2_sizes(H, C, W, n, 0.8)
    ncells = len(square.l2_init_cells(H, W)[1])
    return dict(
        signs0=(rng.randint(0, 2, (ncells, B, 1, 1, C)) * 2 - 1).astype(np.float32),
        transpose0=rng.randint(0, 2, (ncells, B)).astype(bool),
        vh=np.stack([rng.randint(0, H - s + 1, B) for s in sizes]).astype(np.int32),
        vw=np.stack([rng.randint(0, W - s + 1, B) for s in sizes]).astype(np.int32),
        signs=(rng.randint(0, 2, (n, B, 1, 1, C)) * 2 - 1).astype(np.float32),
        orient=rng.randint(0, 2, (n, B)).astype(np.int32))


def jsq_linf_sizes(H, W, C, n):
    n_feat = C * H * W
    return [min(max(int(round(np.sqrt(jsq._p_selection(0.8, i, n) * n_feat / C))), 1), H - 1)
            for i in range(n)]


# (norm, eps, H): L2 at H = 10 has 5 x 5 init cells of side 2, at H = 12
# 6 x 6; Linf at 8
SQUARE = [("Linf", 0.05, 8), ("L2", 0.5, 10), ("L2", 1.0, 12)]


def _accepted(logits, y):
    """(n, B) accept decisions of the queries, from the model's outputs:
    the init's, then one call a query."""
    def margin(lg):
        lg = lg.astype(np.float64)
        z_y = lg[np.arange(len(y)), y]
        lg[np.arange(len(y)), y] = -np.inf
        return z_y - lg.max(-1)
    margins, out = margin(logits[0]), []
    for lg in logits[1:]:
        m_new = margin(lg)
        accept = (m_new < margins) & (margins > 0)
        margins = np.where(accept, m_new, margins)
        out.append(accept)
    return np.stack(out)


@pytest.mark.parametrize("norm,eps,H", SQUARE)
def test_square_trajectory_matches_jax(norm, eps, H):
    """The same queries accepted, query by query (JAX's model records each
    call by an ordered callback inside its jitted scan), and the same
    x_adv."""
    B, C, n = 6, 3, 60
    x = np.random.RandomState(4).rand(B, H, H, C).astype(np.float32)
    jmodel, tmodel, calls = _sq_model(H * H * C)
    y = np.asarray(jmodel(jnp.asarray(x), None)).argmax(-1)
    calls["jax"].clear()
    draws = _draws(np.random.RandomState(5), norm, eps, B, H, H, C, n)
    want_x, want_found = jax.jit(lambda xx, yy: jsq.square_attack(
        jmodel, xx, yy, jax.random.PRNGKey(0), jsq.SquareConfig(norm=norm, eps=eps, n_queries=n),
        draws=draws))(jnp.asarray(x), jnp.asarray(y))
    jax.effects_barrier()
    got_x, got_found = square_attack(tmodel, torch.from_numpy(x), torch.from_numpy(y), 0,
                                     SquareConfig(norm=norm, eps=eps, n_queries=n),
                                     draws=draws)
    assert len(calls["torch"]) == len(calls["jax"]) == n + 1
    accepted = _accepted(calls["torch"], y)
    np.testing.assert_array_equal(accepted, _accepted(calls["jax"], y))
    assert accepted[10:].any()  # queries past the first window sizes land
    np.testing.assert_array_equal(got_found.numpy(), np.asarray(want_found))
    assert got_found.any()
    np.testing.assert_allclose(np32(got_x), np32(want_x), rtol=0, atol=1e-6)
    d = (got_x - torch.from_numpy(x)).reshape(B, -1)
    if norm == "Linf":
        assert float(d.abs().max()) <= eps + 1e-6
    else:
        assert float(d.square().sum(-1).sqrt().max()) <= eps + 1e-5


def test_l2_init_cells_and_schedules():
    """The init grid: side H // 5, centred at upstream's sp_init, an odd
    (5 x 5 at H = 32, anchored at 1) or even (6 x 6 at H = 12) number of
    cells; _p_selection at every breakpoint; _eta_pattern exactly."""
    s0, cells = square.l2_init_cells(32, 32)
    assert s0 == 6 and len(cells) == 25 and cells[0] == (1, 1) and cells[-1] == (25, 25)
    s0, cells = square.l2_init_cells(12, 12)
    assert s0 == 2 and len(cells) == 36 and cells[0] == (0, 0)
    for n in (8, 100, 5000, 10000):
        for i in range(0, n, max(1, n // 500)):
            assert square._p_selection(0.8, i, n) == jsq._p_selection(0.8, i, n)
    for s in range(1, 32):
        np.testing.assert_array_equal(square._eta_pattern(s), jsq._eta_pattern(s))


def test_square_seeded_draws_stay_in_the_ball():
    """Without injected draws: the generators' draws keep x_adv in the ball
    and [0, 1], and the same seed replays the same attack."""
    jmodel, tmodel, _ = _sq_model(8 * 8 * 3)
    x = torch.from_numpy(np.random.RandomState(6).rand(4, 8, 8, 3).astype(np.float32))
    y = torch.tensor([0, 1, 2, 3])
    for norm, eps in (("Linf", 0.05), ("L2", 0.5)):
        cfg = SquareConfig(norm=norm, eps=eps, n_queries=30)
        a, fa = square_attack(tmodel, x, y, 3, cfg)
        b, fb = square_attack(tmodel, x, y, 3, cfg)
        assert torch.equal(a, b) and torch.equal(fa, fb)
        d = (a - x).reshape(4, -1)
        dist = d.abs().max(-1).values if norm == "Linf" else d.square().sum(-1).sqrt()
        assert float(dist.max()) <= eps + 1e-5
        assert 0.0 <= float(a.min()) and float(a.max()) <= 1.0


def test_standard_suite_matches_jax(monkeypatch):
    """The standard suite's protocol with FAB-T for real: phase sizes,
    robust flags and x_adv as JAX's; on_phase after each phase."""
    rng = np.random.RandomState(3)
    x = rng.rand(11, 4, 4, 3).astype(np.float32)
    with torch.no_grad():
        y = _mlp(5)(torch.from_numpy(x), 0).argmax(-1).numpy()
    y[:2] = (y[:2] + 1) % 5  # two examples start misclassified
    calls = {"jax": [], "torch": []}

    def stand_in(tag, name):
        def attack(model_fn, xx, yy, key, cfg):
            calls[tag].append((name, int(xx.shape[0])))
            ch = {"apgd": 0, "square": 2}[name]
            return xx + 0.001, xx[:, 0, 0, ch] > 0.8
        return attack

    for tag, mod in (("jax", jax_aa_mod), ("torch", aa_mod)):
        monkeypatch.setattr(mod, "apgd_attack", stand_in(tag, "apgd"))
        monkeypatch.setattr(mod, "square_attack", stand_in(tag, "square"))
    kw = dict(version="standard", eps=0.04, n_iter=10, fab_n_target_classes=2,
              apgd_t_n_target_classes=2, square_n_queries=5)
    jaa = JaxAutoAttack(make_model(n_classes=5), JaxAAConfig(**kw), log_fn=lambda s: None)
    want_x, want_robust = jaa.run_standard_evaluation(jnp.asarray(x), jnp.asarray(y),
                                                      jax.random.PRNGKey(0), bs=4)
    seen = []
    aa = AutoAttack(_mlp(5), AutoAttackConfig(**kw), log_fn=lambda s: None,
                    on_phase=lambda r: seen.append(len(r)))
    assert aa.attacks == ["apgd-ce", "apgd-t", "fab-t", "square"]
    got_x, got_robust = aa.run_standard_evaluation(torch.from_numpy(x), torch.from_numpy(y),
                                                   0, bs=4)
    assert calls["torch"] == calls["jax"]
    assert [r[0] for r in aa.phase_results] == ["apgd-ce", "apgd-t", "fab-t", "square"]
    assert aa.phase_batch_sizes == jaa.phase_batch_sizes
    assert [r[1] for r in aa.phase_results] == pytest.approx([r[1] for r in jaa.phase_results])
    assert aa.phase_batch_sizes[2] > aa.phase_batch_sizes[3]  # FAB flipped some
    assert seen == [1, 2, 3, 4]
    np.testing.assert_array_equal(got_robust.numpy(), np.asarray(want_robust))
    np.testing.assert_allclose(np32(got_x), np32(want_x), rtol=0, atol=1e-5)
