"""The defence demonstration on the port, on the CPU.

- the protocol on the Gaussian mixture, whose VP-SDE score is closed form
  (``gmm_vp_eps_model``), as tests/test_defense_demo.py runs it for JAX: a
  standard classifier falls to APGD, purification restores it against the
  transferred and the white-box attack, and the defence fades as t* -> 0
  (JAX's margins but at t*=2, see there: these are the port's own draws).
The demo's own functions and its entry point: tests/test_torch_demo_entry.py.
"""
import pytest
import torch

from diffpure_tpu_torch.attacks import AutoAttack, AutoAttackConfig
from diffpure_tpu_torch.attacks.apgd import APGDConfig, apgd_attack
from diffpure_tpu_torch.classifiers.small_cnn import train_classifier
from diffpure_tpu_torch.data.synthetic import SyntheticSpec, gmm_vp_eps_model, \
    sample_gmm_batch
from diffpure_tpu_torch.eval import DefendedModel
from diffpure_tpu_torch.purify import PurifyConfig
from diffpure_tpu_torch.utils.prng import fold_in, generator
from torch_parity import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

AMP, SIG = 0.25, 0.08
EPS = 16 / 255


@pytest.fixture(scope="module")
def spec():
    return SyntheticSpec(size=8)


@pytest.fixture(scope="module")
def gmm_setup(spec):
    """A fragile standard-trained classifier, the eval batch and the
    adversarial examples that break it."""
    sample_fn = lambda g, n: sample_gmm_batch(g, n, spec, AMP, SIG)  # noqa: E731
    clf, _ = train_classifier(0, sample_fn, steps=300, n_train=256, arch="cnn", width=8,
                              device="cpu")
    clf.requires_grad_(False)
    x, y = sample_fn(generator(5), 32)
    x01 = (x + 1.0) * 0.5
    aa = AutoAttack(lambda x_, k: clf(x_), AutoAttackConfig(
        version="custom", attacks_to_run=("apgd-ce",), eps=EPS, n_iter=30),
        log_fn=lambda s: None)
    x_adv, rob = aa.run_standard_evaluation(x01, y, 7)
    return dict(clf=clf, x01=x01, y=y, x_adv=x_adv, undefended=float(rob.float().mean()))


def _defended(spec, setup, t=100):
    cfg = PurifyConfig(diffusion_type="sde", t=t, score_type="score_sde",
                       grad_mode="checkpoint")
    return DefendedModel(gmm_vp_eps_model(spec, AMP, SIG), setup["clf"], cfg, log_every=0)


def _vote(model_fn, x01, y, seed, reps=4):
    with torch.no_grad():
        probs = sum(torch.softmax(model_fn(x01, fold_in(seed, r)), -1) for r in range(reps))
    return float((probs.argmax(-1) == y).float().mean())


def test_attack_breaks_undefended(gmm_setup):
    assert gmm_setup["undefended"] <= 0.5


def test_purification_restores_accuracy(spec, gmm_setup):
    d = _defended(spec, gmm_setup)
    clean = _vote(d, gmm_setup["x01"], gmm_setup["y"], 42)
    robust = _vote(d, gmm_setup["x_adv"], gmm_setup["y"], 43)
    assert clean >= 0.9
    assert robust >= gmm_setup["undefended"] + 0.3 and robust >= 0.9


def test_white_box_apgd_eot_and_dose_response(spec, gmm_setup):
    """Exact gradients through the purifier still lose at t*=100, and win as
    t* -> 0: the defended number is falsifiable."""
    s = gmm_setup
    accs = {}
    for t_star, eot in ((2, 2), (25, 2), (100, 3)):
        d = _defended(spec, s, t=t_star)
        acfg = APGDConfig(norm="Linf", eps=EPS, n_iter=20, eot_iter=eot, loss="ce")
        x_adv, _ = apgd_attack(d, s["x01"], s["y"], 50 + t_star, acfg)
        accs[t_star] = _vote(d, x_adv, s["y"], 60 + t_star)
    assert accs[100] >= s["undefended"] + 0.3 and accs[100] >= 0.9, accs
    # the attack wins at t*=2: over attack seeds 52-54 the port's vote there
    # read 0.06-0.16 (2-5 of 32 examples) against 0.0 undefended; JAX's
    # test bounds its own draws by +0.15
    assert accs[2] <= s["undefended"] + 0.2, accs
    assert accs[2] <= accs[25] + 0.1 <= accs[100] + 0.2, accs
