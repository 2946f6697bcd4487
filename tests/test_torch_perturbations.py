"""mister_ed's perturbation framework, spatial and color transforms, its
attacks and PGD in the port (attacks/perturbations.py, spatial.py,
recoloradv.py, mister_ed.py, pgd.py) against diffpure_tpu's: a counterpart
of each case of tests/test_perturbations.py, held against JAX's outputs on
the same inputs and parameters (JAX's random draws injected where a case
needs them), the LUT's gradient against ``jax.grad``, and the attacks'
x_adv and found on a small classifier that ignores its seed.

Tolerances: the transforms 1e-6 of the largest value (the affine grids'
products sum in another order); the deterministic signed attacks' x_adv
and found exactly; the Adam and L2 attacks 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.attacks import mister_ed as jme
from diffpure_tpu.attacks import perturbations as jpert
from diffpure_tpu.attacks import pgd as jpgd
from diffpure_tpu.attacks import recoloradv as jrc
from diffpure_tpu.attacks import spatial as jsp
from diffpure_tpu_torch.attacks import mister_ed as me
from diffpure_tpu_torch.attacks import perturbations as pert
from diffpure_tpu_torch.attacks import pgd
from diffpure_tpu_torch.attacks import recoloradv as rc
from diffpure_tpu_torch.attacks import spatial as sp
from torch_parity import assert_close, np32

REL = 1e-6


def t_(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def j_(a):
    return jnp.asarray(np32(a) if isinstance(a, torch.Tensor) else a)


def mlp(seed=0, d=48, hidden=16, classes=3):
    """The same small classifier in both packages: tanh(x W1) W2 + b, the
    seed ignored."""
    rng = np.random.default_rng(seed)
    W1 = (rng.standard_normal((d, hidden)) / np.sqrt(d)).astype(np.float32)
    W2 = rng.standard_normal((hidden, classes)).astype(np.float32)
    b = (0.1 * rng.standard_normal(classes)).astype(np.float32)

    def jm(x, key):
        return jnp.tanh(x.reshape(x.shape[0], -1) @ jnp.asarray(W1)) @ jnp.asarray(W2) \
            + jnp.asarray(b)

    def tm(x, seed):
        return torch.tanh(x.reshape(x.shape[0], -1) @ t_(W1)) @ t_(W2) + t_(b)

    return jm, tm


@pytest.fixture
def setup():
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(4, 4, 4, 3)) * 0.5 + 0.25).astype(np.float32)
    jm, tm = mlp()
    y = np.asarray(jnp.argmax(jm(jnp.asarray(x), None), -1))
    return jm, tm, x, y


class TestDeltaAddition:
    @pytest.mark.parametrize("lp,bound", [("inf", 0.1), (2, 0.5)])
    def test_project_matches_jax(self, setup, lp, bound):
        _, _, x, _ = setup
        delta = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
        got = pert.DeltaAddition(lp_style=lp, lp_bound=bound).project(t_(delta), t_(x))
        want = jpert.DeltaAddition(lp_style=lp, lp_bound=bound).project(j_(delta), j_(x))
        assert_close(got, want, REL, f"project {lp}")
        assert float(pert.batchwise_norm(got, lp).max()) <= bound * (1 + 1e-5)
        assert float((t_(x) + got).max()) <= 1.0

    @pytest.mark.parametrize("lp", ["inf", 2])
    def test_random_init_in_ball(self, setup, lp):
        """The draw by its law: in the ball, and (Linf) uniform over it."""
        _, _, x, _ = setup
        d = pert.DeltaAddition(lp_style=lp, lp_bound=0.1)
        p = d.random_init(5, d.init_params(t_(x)), t_(x))
        assert float(pert.batchwise_norm(p, lp).max()) <= 0.1 + 1e-6
        assert not torch.equal(p, d.random_init(6, d.init_params(t_(x)), t_(x)))
        assert torch.equal(p, d.random_init(5, d.init_params(t_(x)), t_(x)))
        if lp == "inf":
            big = torch.full((64, 8, 8, 3), 0.5)
            u = d.random_init(7, d.init_params(big), big)
            assert abs(float(u.mean())) < 2e-3 and abs(float(u.std()) - 0.1 / 3 ** 0.5) < 2e-3

    def test_merge(self, setup):
        _, _, x, _ = setup
        m = pert.DeltaAddition().merge(torch.ones(x.shape), torch.zeros(x.shape),
                                       torch.tensor([1, 0, 1, 0]))
        assert bool((m[0] == 1).all()) and bool((m[1] == 0).all())


def test_threat_model_factory():
    tm = pert.ThreatModel.create(pert.DeltaAddition, lp_style="inf", lp_bound=0.03)
    p = tm()
    assert isinstance(p, pert.DeltaAddition) and p.lp_bound == 0.03
    assert tm.kwargs == jpert.ThreatModel.create(jpert.DeltaAddition, lp_style="inf",
                                                 lp_bound=0.03).kwargs


TRANSFORMS = {"full": (sp.FullSpatial, jsp.FullSpatial), "affine": (sp.Affine, jsp.Affine),
              "rotation": (sp.Rotation, jsp.Rotation),
              "translation": (sp.Translation, jsp.Translation)}


class TestSpatialTransforms:
    @pytest.mark.parametrize("name", list(TRANSFORMS))
    def test_transform_matches_jax(self, setup, name):
        """identity params (a no-op), and params off the identity: apply,
        norm, project in Linf and L2, each against JAX."""
        _, _, x, _ = setup
        T, J = (c() for c in TRANSFORMS[name])
        ident = T.identity_params(t_(x))
        assert_close(ident, J.identity_params(j_(x)), 0.0, f"{name} identity")
        assert_close(T.apply(ident, t_(x)), x, 1e-4, f"{name} identity apply")
        p = ident + t_(0.2 * np.random.default_rng(2).standard_normal(tuple(ident.shape)))
        assert_close(T.apply(p, t_(x)), J.apply(j_(p), j_(x)), REL, f"{name} apply")
        assert_close(T.norm(p, t_(x)), J.norm(j_(p), j_(x)), REL, f"{name} norm")
        for lp in ("inf", 2):
            assert_close(T.project(p, t_(x), lp, 0.1), J.project(j_(p), j_(x), lp, 0.1),
                         REL, f"{name} project {lp}")
        if name == "full":
            assert_close(T.stadv_norm(p, t_(x)), J.stadv_norm(j_(p), j_(x)), REL, "stadv norm")

    def test_translation_and_rotation_move_the_image(self):
        x = np.zeros((1, 8, 8, 1), np.float32)
        x[0, 4, 4, 0] = 1.0
        out = sp.Translation().apply(torch.tensor([[0.25, 0.0]]), t_(x))
        assert float(out[0, 4, 4, 0]) < 1.0 and float(out.sum()) > 0.5
        x = np.zeros((1, 8, 8, 1), np.float32)
        x[0, 2, :, 0] = 1.0
        out = sp.Rotation().apply(torch.tensor([np.pi / 2]), t_(x))[0, :, :, 0]
        assert float(out.sum(0).var()) > float(out.sum(1).var())
        want = jsp.Rotation().apply(jnp.array([np.pi / 2]), j_(x))
        assert_close(out, want[0, :, :, 0], REL, "rotation by 90 degrees")

    def test_sequential_matches_jax(self, setup):
        """init, apply, project, norm of Translation then DeltaAddition at
        the params JAX's random_init drew."""
        _, _, x, _ = setup
        layers = lambda m, s: (m.ParameterizedXformAdv(xform=s.Translation(), lp_bound=0.1),  # noqa
                               m.DeltaAddition(lp_style="inf", lp_bound=0.05))
        seq = pert.SequentialPerturbation(layers=layers(pert, sp))
        jseq = jpert.SequentialPerturbation(layers=layers(jpert, jsp))
        p0 = seq.init_params(t_(x))
        assert_close(seq.apply(p0, t_(x)), x, 1e-4, "sequential identity")
        jp = jseq.random_init(jax.random.PRNGKey(0), jseq.init_params(j_(x)), j_(x))
        p = tuple(t_(np.asarray(a)) for a in jp)
        assert_close(seq.apply(p, t_(x)), jseq.apply(jp, j_(x)), REL, "sequential apply")
        for a, b in zip(seq.project(p, t_(x)), jseq.project(jp, j_(x))):
            assert_close(a, b, REL, "sequential project")
        assert_close(seq.norm(p, t_(x)), jseq.norm(jp, j_(x)), REL, "sequential norm")
        p2 = seq.random_init(0, p0, t_(x))
        assert not torch.allclose(seq.apply(p2, t_(x)), t_(x))
        assert seq.norm(p2, t_(x)).shape == (4,)


class TestReColorAdv:
    def test_ypbpr_matches_jax(self):
        x = np.random.default_rng(3).uniform(size=(2, 4, 4, 3)).astype(np.float32)
        cs, jcs = rc.YPbPrColorSpace(), jrc.YPbPrColorSpace()
        assert_close(cs.from_rgb(t_(x)), jcs.from_rgb(j_(x)), REL, "from_rgb")
        assert_close(cs.to_rgb(cs.from_rgb(t_(x))), x, 1e-5, "round trip")
        assert_close(cs.to_rgb(t_(x)), jcs.to_rgb(j_(x)), REL, "to_rgb")

    @pytest.mark.parametrize("R", [4, 8])
    def test_lut_matches_jax(self, R):
        """The lattice bit for bit, the identity lookup a no-op, a perturbed
        LUT's lookup and smoothness norm against JAX (colors of exactly 0
        and 1 included: ``lo`` clipped to R - 2)."""
        rng = np.random.default_rng(4)
        x = rng.uniform(size=(2, 4, 4, 3)).astype(np.float32)
        x[0, 0, 0] = (0.0, 1.0, 1.0)
        x[1, 1, 1] = (1.0, 0.0, 0.5)
        T, J = rc.FullSpatialColorTransform(R), jrc.FullSpatialColorTransform(R)
        ident = T.identity_params(t_(x))
        assert torch.equal(ident, t_(np.asarray(J.identity_params(j_(x)))))
        assert_close(T.apply(ident, t_(x)), x, 1e-5, "identity LUT")
        lut = ident + t_(0.05 * rng.standard_normal(tuple(ident.shape)))
        assert_close(T.apply(lut, t_(x)), J.apply(j_(lut), j_(x)), REL, "LUT lookup")
        assert_close(T.smoothness_norm(lut), J.smoothness_norm(j_(lut)), REL, "smoothness")
        assert float(T.smoothness_norm(ident).max()) < 1e-3

    def test_lut_gradient_matches_jax(self):
        """d/dLUT and d/dx of sum(w * lookup): the gathers' adjoint, a
        scatter-add into the lattice."""
        rng = np.random.default_rng(5)
        x = rng.uniform(size=(2, 6, 6, 3)).astype(np.float32)
        x[0, 0, 0] = (1.0, 1.0, 0.0)
        w = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)
        T, J = rc.FullSpatialColorTransform(4), jrc.FullSpatialColorTransform(4)
        lut0 = T.identity_params(t_(x)) + t_(0.05 * rng.standard_normal((2, 4, 4, 4, 3)))
        want = jax.grad(lambda lut, xx: jnp.sum(j_(w) * J.apply(lut, xx)),
                        argnums=(0, 1))(j_(lut0), j_(x))
        lut, xt = lut0.clone().requires_grad_(True), t_(x).requires_grad_(True)
        got = torch.autograd.grad((t_(w) * T.apply(lut, xt)).sum(), (lut, xt))
        assert_close(got[0], want[0], REL, "d/dLUT")
        assert_close(got[1], want[1], 1e-5, "d/dx")

    def test_affine_color_and_perturbation_match_jax(self, setup):
        _, _, x, _ = setup
        A, JA = rc.AffineColorTransform(), jrc.AffineColorTransform()
        theta = A.identity_params(t_(x)) + t_(0.1 * np.random.default_rng(6).standard_normal(
            (4, 3, 4)))
        assert_close(A.apply(A.identity_params(t_(x)), t_(x)), x, 1e-6, "affine identity")
        assert_close(A.apply(theta, t_(x)), JA.apply(j_(theta), j_(x)), REL, "affine apply")
        assert_close(A.smoothness_norm(theta), JA.smoothness_norm(j_(theta)), REL, "affine norm")
        for space in ("RGBColorSpace", "YPbPrColorSpace"):
            p = rc.ReColorAdv(color_space=getattr(rc, space)(), lp_bound=0.1)
            jp = jrc.ReColorAdv(color_space=getattr(jrc, space)(), lp_bound=0.1)
            params = p.init_params(t_(x))
            assert_close(p.apply(params, t_(x)), x, 1e-4, f"ReColorAdv {space} identity")
            moved = params + t_(0.3 * np.random.default_rng(7).standard_normal(
                tuple(params.shape)))
            proj = p.project(moved, t_(x))
            assert_close(proj, jp.project(j_(moved), j_(x)), REL, f"{space} project")
            assert float((proj - params).abs().max()) <= 0.1 + 1e-6
            assert_close(p.apply(proj, t_(x)), jp.apply(j_(proj), j_(x)), REL, f"{space} apply")
            assert_close(p.norm(proj, t_(x)), jp.norm(j_(proj), j_(x)), REL, f"{space} norm")


def _attack_pair(setup, pert_of, cfg_kw):
    jm, tm, x, y = setup
    got = me.perturbation_pgd(tm, pert_of(pert, sp, rc), t_(x), torch.from_numpy(y), 0,
                              me.MisterEdPGDConfig(**cfg_kw))
    want = jme.perturbation_pgd(jm, pert_of(jpert, jsp, jrc), j_(x), jnp.asarray(y),
                                jax.random.PRNGKey(0), jme.MisterEdPGDConfig(**cfg_kw))
    return got, want


class TestMisterEdAttacks:
    @pytest.mark.parametrize("which", ["delta", "recolor", "sequential"])
    def test_signed_pgd_matches_jax(self, setup, which):
        """Signed steps, keep-best and the perturbation's projection: x_adv
        and found exactly JAX's, with EOT (two repetitions of a seedless
        model) and a norm penalty on the sequence."""
        perts = {
            "delta": lambda m, s, r: m.DeltaAddition(lp_style="inf", lp_bound=0.3),
            "recolor": lambda m, s, r: r.ReColorAdv(
                xform=r.FullSpatialColorTransform(4), color_space=r.YPbPrColorSpace(),
                lp_bound=0.1),
            "sequential": lambda m, s, r: m.SequentialPerturbation(layers=(
                r.ReColorAdv(xform=r.FullSpatialColorTransform(4), lp_bound=0.1),
                m.ParameterizedXformAdv(xform=s.FullSpatial(), lp_bound=0.05,
                                        use_stadv=True)))}
        kw = dict(num_iterations=12, step_size=0.03, eot_iter=2 if which == "delta" else 1,
                  perturbation_norm_weight=0.01 if which == "sequential" else 0.0)
        (x_adv, found), (jx, jf) = _attack_pair(setup, perts[which], kw)
        assert np.array_equal(found.numpy(), np.asarray(jf))
        assert np.array_equal(x_adv.numpy(), np.asarray(jx)), f"{which} x_adv"
        if which == "delta":
            assert found.any() and float((x_adv - t_(setup[2])).abs().max()) <= 0.3 + 1e-6

    def test_adam_pgd_matches_jax(self, setup):
        (x_adv, found), (jx, jf) = _attack_pair(
            setup, lambda m, s, r: m.DeltaAddition(lp_style="inf", lp_bound=0.3),
            dict(num_iterations=40, optimizer_lr=0.05))
        assert np.array_equal(found.numpy(), np.asarray(jf)) and found.any()
        assert_close(x_adv, jx, REL, "Adam x_adv")

    def test_random_init_pgd(self, setup):
        """random_init by its law: the start in the ball, the result in it."""
        jm, tm, x, y = setup
        cfg = me.MisterEdPGDConfig(num_iterations=3, step_size=0.01, random_init=True)
        d = pert.DeltaAddition(lp_style="inf", lp_bound=0.05)
        x_adv, _ = me.perturbation_pgd(tm, d, t_(x), torch.from_numpy(y), 1, cfg)
        assert float((x_adv - t_(x)).abs().max()) <= 0.05 + 1e-6

    def test_fgsm_matches_jax(self, setup):
        jm, tm, x, y = setup
        got = me.fgsm(tm, t_(x), torch.from_numpy(y), 0, eps=0.1)
        want = jme.fgsm(jm, j_(x), jnp.asarray(y), jax.random.PRNGKey(0), eps=0.1)
        assert np.array_equal(got.numpy(), np.asarray(want))
        from diffpure_tpu_torch.attacks import ce_loss
        assert float(ce_loss(tm(got, 0), torch.from_numpy(y)).mean()) > \
            float(ce_loss(tm(t_(x), 0), torch.from_numpy(y)).mean())

    def test_carlini_wagner_matches_jax(self, setup):
        jm, tm, x, y = setup
        cfg = dict(num_iterations=60, lr=0.05, initial_const=10.0)
        got, found = me.carlini_wagner(tm, t_(x), torch.from_numpy(y), 0,
                                       me.CarliniWagnerConfig(**cfg))
        want, jf = jme.carlini_wagner(jm, j_(x), jnp.asarray(y), jax.random.PRNGKey(0),
                                      jme.CarliniWagnerConfig(**cfg))
        assert np.array_equal(found.numpy(), np.asarray(jf)) and found.any()
        assert_close(got, want, 1e-5, "CW x_adv")
        d = (got - t_(x)).reshape(4, -1).norm(dim=-1)
        assert float(d[found].max()) < 3.0

    def test_adversarial_attack_parameters(self, setup):
        jm, tm, x, y = setup
        params = me.AdversarialAttackParameters(
            lambda xx, yy, s: (torch.ones_like(xx), None), proportion_attacked=0.5)
        out, y_out, mask = params.attack(t_(x), torch.from_numpy(y), 3)
        assert int(mask.sum()) == 2 and torch.equal(y_out, torch.from_numpy(y))
        assert bool((out[mask] == 1).all()) and torch.equal(out[~mask], t_(x)[~mask])


@pytest.mark.parametrize("norm", ["Linf", "L2"])
def test_pgd_attack_matches_jax(setup, norm):
    """pgd_attack on the small classifier, deterministic start, EOT 2:
    x_adv and found against JAX's (Linf's signed steps exactly)."""
    jm, tm, x, y = setup
    kw = dict(norm=norm, eps=0.1 if norm == "Linf" else 0.5, step_size=0.02 if norm == "Linf"
              else 0.1, n_iter=10, eot_iter=2)
    got, found = pgd.pgd_attack(tm, t_(x), torch.from_numpy(y), 0, pgd.PGDConfig(**kw))
    want, jf = jpgd.pgd_attack(jm, j_(x), jnp.asarray(y), jax.random.PRNGKey(0),
                               jpgd.PGDConfig(**kw))
    assert np.array_equal(found.numpy(), np.asarray(jf)) and found.any()
    if norm == "Linf":
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert_close(got, want, REL, f"pgd {norm}")
    d = (got - t_(x)).reshape(4, -1)
    assert float((d.abs().amax(-1) if norm == "Linf" else d.norm(dim=-1)).max()) <= \
        kw["eps"] * (1 + 1e-5)


@pytest.mark.parametrize("norm", ["Linf", "L2"])
def test_pgd_random_init_by_its_law(setup, norm):
    jm, tm, x, y = setup
    eps = 0.1 if norm == "Linf" else 0.5
    cfg = pgd.PGDConfig(norm=norm, eps=eps, step_size=0.0, n_iter=1, random_init=True)
    a, _ = pgd.pgd_attack(tm, t_(x), torch.from_numpy(y), 4, cfg)
    b, _ = pgd.pgd_attack(tm, t_(x), torch.from_numpy(y), 5, cfg)
    d = (a - t_(x)).reshape(4, -1)
    assert float((d.abs().amax(-1) if norm == "Linf" else d.norm(dim=-1)).max()) <= eps + 1e-6
    assert not torch.equal(a, b) and float(d.abs().max()) > 0
