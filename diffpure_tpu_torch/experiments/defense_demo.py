"""The defence demonstration on weights trained here (port of
diffpure_tpu/experiments/defense_demo.py and scripts/defense_demo.py).

No checkpoint can be downloaded, so the property purification exists for —
defended robust accuracy well above undefended robust accuracy at
comparable clean accuracy (ref eval_sde_adv.py:211-243) — is shown on the
procedural gratings of data/synthetic.py with models trained by the port's
own trainers:
  1. a SmallCNN trained on a finite sample (standard training: fragile);
  2. an NCSN++ trained by continuous score matching (training/losses.py
     ``get_step_fn``, the score_sde recipe), its EMA weights kept;
  3. the reference protocol through the port's drivers: AutoAttack
     APGD(+EOT) and BPDA+EOT against the bare classifier and through the
     purifier.
eps = 16/255, the reference's CelebA-HQ threat model: at 8/255 the grating
task is too easy for any standard classifier to be broken.

Seeds are integers; the JAX key layout fold_in(key, k) becomes
``prng.fold_in(seed, k)`` and each draw its own generator (utils/prng.py).
The models run on ``device``.

    python -m diffpure_tpu_torch.experiments.defense_demo [--large] [--hard]
        [--sweep 0,5,25,100] [--dpm] [--standard] [--device cuda|cpu] ...

The entry point takes scripts/defense_demo.py's flags and ``--device``
(default ``cuda``, which raises when no card is present; ``--platform
cpu`` is the JAX script's spelling of ``--device cpu``). It writes
``results.json`` (or ``dose_response.json``) under ``--out`` and caches the
trained weights there (``trained_weights.pt``), keyed by the fields that
affect training.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from diffpure_tpu_torch.classifiers.small_cnn import SmallCNN, train_classifier
from diffpure_tpu_torch.data.synthetic import SyntheticSpec, sample_batch
from diffpure_tpu_torch.diffusion import VPSDE
from diffpure_tpu_torch.eval import DefendedModel
from diffpure_tpu_torch.models.ema import ExponentialMovingAverage
from diffpure_tpu_torch.models.ncsnpp import NCSNpp
from diffpure_tpu_torch.purify import PurifyConfig
from diffpure_tpu_torch.training import get_optimizer, get_step_fn
from diffpure_tpu_torch.utils.prng import fold_in, generator

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DemoConfig:
    # data distribution
    size: int = 16
    n_classes: int = 4
    amp_min: float = 0.2      # low amplitude = small-margin (fragile) regime
    amp_max: float = 0.4
    # the --hard variant raises freq and the class count so that t*=100
    # purification no longer restores the class signal perfectly
    freq: float = 2.0
    noise_std: float = 0.04
    # classifier (standard, non-robust training on a finite sample)
    clf_width: int = 32
    clf_steps: int = 1200
    clf_train_size: int = 512
    # score model + score-matching training
    score_nf: int = 32
    score_ch_mult: Tuple[int, ...] = (1, 2)
    score_blocks: int = 2
    score_attn: Tuple[int, ...] = (8,)
    score_steps: int = 3000
    score_batch: int = 128
    score_lr: float = 1e-3
    score_warmup: int = 500
    ema_rate: float = 0.999
    # defence / threat model
    t_star: int = 100
    eps: float = 16 / 255
    # evaluation
    n_eval: int = 64
    eot_iter: int = 5          # EOT reps for APGD through the purifier
    apgd_iter: int = 50
    aa_iter: Optional[int] = None  # AA standard suite's iterations (None: apgd_iter)
    defense_reps: int = 8      # stochastic-defence vote for accuracy numbers
    # None: the full standard suite; a tuple runs that subset (version
    # 'custom'), to resume a suite whose finished attacks left the robust
    # set unchanged
    aa_attacks: Optional[Tuple[str, ...]] = None
    # resume legs that rerun an attack subset skip the defended clean /
    # transfer accounting
    skip_accounting: bool = False
    seed: int = 0


# the DemoConfig fields that change what is trained (the weight cache's key)
TRAIN_FIELDS = ("size", "n_classes", "amp_min", "amp_max", "freq", "noise_std",
                "clf_width", "clf_steps", "clf_train_size", "score_nf", "score_ch_mult",
                "score_blocks", "score_attn", "score_steps", "score_batch", "score_lr",
                "score_warmup", "ema_rate", "seed")


def demo_spec(cfg: DemoConfig) -> SyntheticSpec:
    return SyntheticSpec(size=cfg.size, n_classes=cfg.n_classes,
                         amp_range=(cfg.amp_min, cfg.amp_max),
                         freq=cfg.freq, noise_std=cfg.noise_std)


def _eval_batch(cfg: DemoConfig, seed: int, device) -> Tuple[Tensor, Tensor]:
    x, y = sample_batch(generator(seed, device=device), cfg.n_eval, demo_spec(cfg))
    return (x + 1.0) * 0.5, y


def demo_score_model(cfg: DemoConfig) -> NCSNpp:
    return NCSNpp(image_size=cfg.size, nf=cfg.score_nf, ch_mult=cfg.score_ch_mult,
                  num_res_blocks=cfg.score_blocks, attn_resolutions=cfg.score_attn,
                  num_scales=1000, dropout=0.0)


def demo_classifier(cfg: DemoConfig) -> SmallCNN:
    return SmallCNN(n_classes=cfg.n_classes, width=cfg.clf_width, size=cfg.size)


def _frozen(model: torch.nn.Module) -> torch.nn.Module:
    # attacks differentiate the input only: frozen weights keep the blocks'
    # weight-cotangent branch off
    return model.eval().requires_grad_(False)


def train_demo_classifier(cfg: DemoConfig, seed: Optional[int] = None,
                          device="cuda") -> SmallCNN:
    """The standard (non-robust) classifier, trained on ``device``."""
    seed = cfg.seed if seed is None else seed
    spec = demo_spec(cfg)
    model, _ = train_classifier(
        fold_in(seed, 1), lambda g, n: sample_batch(g, n, spec),
        n_classes=cfg.n_classes, width=cfg.clf_width, steps=cfg.clf_steps,
        n_train=cfg.clf_train_size, device=device)
    return _frozen(model)


def train_demo_score(cfg: DemoConfig, seed: Optional[int] = None, log=print,
                     device="cuda") -> NCSNpp:
    """An NCSN++ trained by continuous score matching from a fresh flax-style
    init; returns the model holding its EMA weights. Step i's batch comes
    from stream fold_in(key, 10000 + i), its loss draws from
    fold_in(key, 20000 + i), key = fold_in(seed, 2)."""
    seed = cfg.seed if seed is None else seed
    key = fold_in(seed, 2)
    spec = demo_spec(cfg)
    model = demo_score_model(cfg).init_(generator(key)).to(device)
    opt = get_optimizer(lr=cfg.score_lr, warmup=cfg.score_warmup)
    step_fn = get_step_fn(VPSDE(), train=True, optimizer=opt)
    params = list(model.parameters())
    state = dict(params=model, opt_state=opt.init(params), step=0,
                 ema=ExponentialMovingAverage(params, cfg.ema_rate, use_num_updates=False))
    t0 = time.time()
    loss = None
    for i in range(cfg.score_steps):
        xb, _ = sample_batch(generator(fold_in(key, 10_000 + i), device=device),
                             cfg.score_batch, spec)
        state, loss = step_fn(state, xb, generator(fold_in(key, 20_000 + i), device=device))
        if i % 500 == 0:
            log(f"  score step {i}: loss {float(loss):.4f}")
    log(f"score model trained: {cfg.score_steps} steps in {time.time() - t0:.0f}s, "
        f"final loss {float(loss):.4f}")
    state["ema"].copy_to(model)
    return _frozen(model)


def build_demo_defended(cfg: DemoConfig, score_model, clf, *, diffusion_type: str = "sde",
                        n_steps: Optional[int] = None, grad_mode: str = "checkpoint",
                        t_star: Optional[int] = None) -> DefendedModel:
    pcfg = PurifyConfig(diffusion_type=diffusion_type,
                        t=cfg.t_star if t_star is None else t_star, n_steps=n_steps,
                        score_type="score_sde", grad_mode=grad_mode)
    return DefendedModel(score_model, clf, pcfg, log_every=0)


def _vote_acc(model_fn, x01: Tensor, y: Tensor, seed: int, reps: int):
    """(vote_acc, single_acc): accuracy of the mean softmax over ``reps``
    defence samples (the eot_defense_prediction vote, ref
    bpda_eot_attack.py:41-53) and of the first sample alone (the
    AutoAttack drivers' accounting)."""
    probs = single = None
    with torch.no_grad():
        for r in range(reps):
            logits = model_fn(x01, fold_in(seed, r))
            if single is None:
                single = float((logits.argmax(-1) == y).float().mean())
            p = torch.softmax(logits, dim=-1)
            probs = p if probs is None else probs + p
    return float((probs.argmax(-1) == y).float().mean()), single


def run_dose_response(cfg: DemoConfig, score_model, clf, *, t_values=(0, 5, 25, 100),
                      log=print) -> dict:
    """White-box APGD-EOT through the purifier at several t*: defended robust
    accuracy must fall to the undefended level as t* -> 0 (t* = 0 is the
    bare classifier behind the same attack code), which is the evidence
    that the attack through the purifier works (ref measurement:
    eval_sde_adv.py:211-243)."""
    from diffpure_tpu_torch.attacks.apgd import APGDConfig, apgd_attack

    device = next(clf.parameters()).device
    key = fold_in(cfg.seed, 4)
    x01, y = _eval_batch(cfg, fold_in(key, 0), device)
    acfg = APGDConfig(norm="Linf", eps=cfg.eps, n_iter=cfg.apgd_iter,
                      eot_iter=cfg.eot_iter, loss="ce")
    curve = {}
    for t_star in t_values:
        t0 = time.time()
        if t_star == 0:
            defended = lambda x01_, k: clf(x01_)  # noqa: E731
        else:
            defended = build_demo_defended(cfg, score_model, clf, t_star=int(t_star))
        x_adv, _ = apgd_attack(defended, x01, y, fold_in(key, 100 + t_star), acfg)
        vote, single = _vote_acc(defended, x_adv, y, fold_in(key, 200 + t_star),
                                 cfg.defense_reps if t_star else 1)
        curve[int(t_star)] = {"robust_acc": vote, "robust_acc_single": single}
        log(f"[dose-response] t*={t_star}: defended robust {vote:.2%} "
            f"({time.time() - t0:.0f}s)")
    return curve


def run_demo_protocol(cfg: DemoConfig, score_model, clf, *, attacks=("apgd-eot", "bpda"),
                      diffusion_types=("sde",), log=print, checkpoint=None) -> dict:
    """Clean and robust accuracy of the classifier alone against
    purifier + classifier under the same attacks; a dict of accuracies per
    (diffusion type, attack). ``checkpoint(results)`` is called with the
    partial results after every finished phase."""
    from diffpure_tpu_torch.attacks import AutoAttack, AutoAttackConfig

    device = next(clf.parameters()).device
    key = fold_in(cfg.seed, 3)
    x01, y = _eval_batch(cfg, fold_in(key, 0), device)
    clf_fn = lambda x01_, k: clf(x01_)  # noqa: E731
    results: dict = {"config": dataclasses.asdict(cfg)}
    ckpt = checkpoint or (lambda r: None)

    with torch.no_grad():
        results["clean_acc_undefended"] = float((clf(x01).argmax(-1) == y).float().mean())
    log(f"clean acc (undefended): {results['clean_acc_undefended']:.2%}")

    # the undefended baseline (ref :114-133), beaten as hard as possible:
    # CE + DLR (the rand suite) + targeted DLR on every other class (JAX
    # asks for 9 targets and its gather clamps the ones past the last class
    # to the least likely one; the port's APGD-T takes no target it lacks)
    t0 = time.time()
    aa = AutoAttack(clf_fn, AutoAttackConfig(
        version="custom", attacks_to_run=("apgd-ce", "apgd-dlr", "apgd-t"),
        eps=cfg.eps, n_iter=100, apgd_t_n_target_classes=min(cfg.n_classes - 1, 9)),
        log_fn=lambda s: None)
    x_adv_base, rob_base = aa.run_standard_evaluation(x01, y, fold_in(key, 1))
    results["robust_acc_undefended"] = float(rob_base.float().mean())
    log(f"robust acc (undefended, eps={cfg.eps * 255:.0f}/255): "
        f"{results['robust_acc_undefended']:.2%} ({time.time() - t0:.0f}s)")
    ckpt(results)

    for dtype in diffusion_types:
        n_steps = 20 if dtype == "dpm" else None
        tag = dtype if dtype == "sde" else f"{dtype}{n_steps}"
        defended = build_demo_defended(cfg, score_model, clf, diffusion_type=dtype,
                                       n_steps=n_steps)
        res: dict = {}
        results[tag] = res  # filled in place; checkpoints see it

        t0 = time.time()
        if not cfg.skip_accounting:
            res["clean_acc"], res["clean_acc_single"] = _vote_acc(
                defended, x01, y, fold_in(key, 10), cfg.defense_reps)
            # transfer: does purification undo perturbations crafted
            # against the bare classifier? (a sanity check)
            res["robust_acc_transfer"], _ = _vote_acc(
                defended, x_adv_base, y, fold_in(key, 11), cfg.defense_reps)
            log(f"[{tag}] defended clean: {res['clean_acc']:.2%}, transfer-attack "
                f"robust: {res['robust_acc_transfer']:.2%} ({time.time() - t0:.0f}s)")
            ckpt(results)

        if "apgd-eot" in attacks:
            # white-box adaptive: APGD with EOT through the purifier (the
            # Rand protocol, ref eval_sde_adv.py:103-110)
            from diffpure_tpu_torch.attacks.apgd import APGDConfig, apgd_attack
            t0 = time.time()
            acfg = APGDConfig(norm="Linf", eps=cfg.eps, n_iter=cfg.apgd_iter,
                              eot_iter=cfg.eot_iter, loss="ce")
            x_adv, _found = apgd_attack(defended, x01, y, fold_in(key, 12), acfg)
            res["robust_acc_apgd_eot"], res["robust_acc_apgd_eot_single"] = _vote_acc(
                defended, x_adv, y, fold_in(key, 13), cfg.defense_reps)
            log(f"[{tag}] defended robust (APGD-CE EOT{cfg.eot_iter} white-box): "
                f"{res['robust_acc_apgd_eot']:.2%} ({time.time() - t0:.0f}s)")
            ckpt(results)

        if "aa-standard" in attacks:
            # the standard suite (APGD-CE, APGD-T, FAB-T, Square) through the
            # purifier with reduced budgets
            t0 = time.time()

            def _on_phase(phase_results, _res=res):
                _res["aa_per_attack"] = [
                    {"attack": n, "robust_acc": acc, "attacked": k, "wall_s": w}
                    for n, acc, k, w in phase_results]
                ckpt(results)

            aa_std = AutoAttack(defended, AutoAttackConfig(
                version="custom" if cfg.aa_attacks else "standard",
                attacks_to_run=cfg.aa_attacks or (), eps=cfg.eps,
                n_iter=cfg.aa_iter or cfg.apgd_iter, eot_iter=1, square_n_queries=300,
                fab_n_target_classes=min(cfg.n_classes - 1, 3),
                apgd_t_n_target_classes=min(cfg.n_classes - 1, 3)),
                log_fn=lambda s: log(f"  [aa-std] {s}"), on_phase=_on_phase)
            _, rob_std = aa_std.run_standard_evaluation(x01, y, fold_in(key, 15))
            res["robust_acc_aa_standard"] = float(rob_std.float().mean())
            if cfg.aa_attacks:
                res["aa_attacks_run"] = list(cfg.aa_attacks)
            log(f"[{tag}] defended robust (AA standard): "
                f"{res['robust_acc_aa_standard']:.2%} ({time.time() - t0:.0f}s)")
            ckpt(results)

        if "bpda" in attacks:
            from diffpure_tpu_torch.attacks.bpda_eot import BPDAEOTConfig, bpda_eot_attack
            t0 = time.time()
            bcfg = BPDAEOTConfig(adv_eps=cfg.eps, adv_eta=cfg.eps / 4, adv_steps=20,
                                 eot_defense_reps=16, eot_attack_reps=8, defense_batch=16)
            _x_adv_b, class_batch = bpda_eot_attack(defended.purify, defended.classify,
                                                    x01, y, fold_in(key, 14), bcfg)
            res["robust_acc_bpda"] = float(np.asarray(class_batch[-1]).mean())
            log(f"[{tag}] defended robust (BPDA+EOT): {res['robust_acc_bpda']:.2%} "
                f"({time.time() - t0:.0f}s)")
            ckpt(results)

    return results


# --- the entry point (scripts/defense_demo.py) -------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="The trained-weights defence demonstration.")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the models (default cuda; cuda with no card raises)")
    ap.add_argument("--platform", default=None,
                    help="the JAX script's platform flag: 'cpu' runs on the CPU, "
                         "'gpu' / 'cuda' on the card (overrides --device)")
    ap.add_argument("--out", default="defense_demo_out")
    ap.add_argument("--score_steps", type=int, default=None)
    ap.add_argument("--dpm", action="store_true",
                    help="also run DPM-Solver++@20 defence-equivalence")
    ap.add_argument("--dtypes", default=None,
                    help="comma list of purification diffusion types to run (sde,dpm); "
                         "overrides --dpm")
    ap.add_argument("--standard", action="store_true",
                    help="also run the AA standard suite (APGD-CE/T, FAB-T, Square) "
                         "through the purifier")
    ap.add_argument("--large", action="store_true",
                    help="the full CIFAR-config NCSN++ (107M, nf=128 ch_mult=(1,2,2,2) "
                         "8 blocks) trained at 32x32 as the purifier")
    ap.add_argument("--hard", action="store_true",
                    help="harder distribution (8 classes, freq 4, lower amplitude): "
                         "defended robust lands between undefended and clean")
    ap.add_argument("--sweep", default=None,
                    help="comma-separated t* values for the dose-response sweep "
                         "(e.g. '0,5,25,100') instead of the full protocol")
    ap.add_argument("--apgd_iter", type=int, default=None)
    ap.add_argument("--eot_iter", type=int, default=None)
    ap.add_argument("--n_eval", type=int, default=None)
    ap.add_argument("--aa_iter", type=int, default=None,
                    help="AA standard suite's iterations (default: apgd_iter)")
    ap.add_argument("--attacks", default=None,
                    help="comma list of protocol attacks (apgd-eot,bpda,aa-standard); "
                         "default: apgd-eot,bpda[,aa-standard with --standard]")
    ap.add_argument("--skip_accounting", action="store_true",
                    help="skip the defended clean / transfer vote accounting")
    ap.add_argument("--aa_attacks", default=None,
                    help="comma subset of the AA standard suite "
                         "(apgd-ce,apgd-t,fab-t,square), run as version 'custom'")
    # distribution / threat-model overrides, applied after --hard / --large
    ap.add_argument("--eps", type=float, default=None)
    ap.add_argument("--amp_min", type=float, default=None)
    ap.add_argument("--amp_max", type=float, default=None)
    ap.add_argument("--noise_std", type=float, default=None)
    ap.add_argument("--freq", type=float, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--score_nf", type=int, default=None,
                    help="score-model width override")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def config_from_args(args) -> DemoConfig:
    overrides = {"seed": args.seed}
    if args.hard:
        overrides.update(n_classes=8, freq=4.0, amp_min=0.15, amp_max=0.35, noise_std=0.06,
                         clf_steps=2000, clf_train_size=1024, score_steps=4000)
    if args.large:
        # the configs/cifar10.yml score net on the 32x32 gratings; attack
        # budgets cut for its cost
        overrides.update(size=32, score_nf=128, score_ch_mult=(1, 2, 2, 2), score_blocks=8,
                         score_attn=(16,), score_steps=3000, score_batch=128, clf_width=64,
                         clf_steps=1500, clf_train_size=1024, n_eval=32, eot_iter=3,
                         apgd_iter=20, defense_reps=8)
    if args.score_steps:
        overrides["score_steps"] = args.score_steps
    for k in ("apgd_iter", "eot_iter", "n_eval", "aa_iter", "eps", "amp_min", "amp_max",
              "noise_std", "freq", "size", "score_nf"):
        if getattr(args, k) is not None:
            overrides[k] = getattr(args, k)
    if args.aa_attacks:
        overrides["aa_attacks"] = tuple(a for a in args.aa_attacks.split(",") if a)
    if args.skip_accounting:
        overrides["skip_accounting"] = True
    return DemoConfig(**overrides)


def resolve_device(args) -> torch.device:
    name = args.device
    if args.platform is not None:
        name = "cpu" if args.platform == "cpu" else "cuda"
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           f"(pass --device cpu to run on the CPU)")
    # fp32 stays fp32: no TF32 in cuBLAS's or cuDNN's products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def _train_key(d: dict) -> dict:
    default = DemoConfig()
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in ((k, d.get(k, getattr(default, k))) for k in TRAIN_FIELDS)}


def trained_models(cfg: DemoConfig, out: str, device, log=print):
    """(classifier, score model): from ``out/trained_weights.pt`` when it was
    trained under the same training fields, else trained and cached."""
    cache = os.path.join(out, "trained_weights.pt")
    if os.path.exists(cache):
        blob = torch.load(cache, map_location="cpu", weights_only=True)
        if _train_key(blob["config"]) != _train_key(dataclasses.asdict(cfg)):
            raise ValueError(f"cache {cache} was trained under a different DemoConfig")
        clf, score = demo_classifier(cfg), demo_score_model(cfg)
        clf.load_state_dict(blob["clf"])
        score.load_state_dict(blob["score"])
        log(f"loaded trained weights from {cache}")
        return _frozen(clf.to(device)), _frozen(score.to(device))
    t0 = time.time()
    clf = train_demo_classifier(cfg, device=device)
    log(f"classifier trained ({time.time() - t0:.0f}s)")
    score = train_demo_score(cfg, log=log, device=device)
    os.makedirs(out, exist_ok=True)
    torch.save({"config": dataclasses.asdict(cfg), "clf": clf.state_dict(),
                "score": score.state_dict()}, cache)
    log(f"trained weights cached to {cache}")
    return clf, score


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args)
    cfg = config_from_args(args)
    say = lambda s: print(s, flush=True)  # noqa: E731
    say(f"config: {cfg}")
    say(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                               if device.type == "cuda" else ""))
    t0 = time.time()
    os.makedirs(args.out, exist_ok=True)
    clf, score = trained_models(cfg, args.out, device, log=say)

    if args.sweep:
        t_values = tuple(int(v) for v in args.sweep.split(","))
        results = {"config": dataclasses.asdict(cfg),
                   "dose_response": run_dose_response(cfg, score, clf, t_values=t_values,
                                                      log=say)}
    else:
        dtypes = ("sde", "dpm") if args.dpm else ("sde",)
        if args.dtypes:
            dtypes = tuple(a for a in args.dtypes.split(",") if a)
        if args.attacks is not None:
            attacks = [a for a in args.attacks.split(",") if a]
        else:
            attacks = ["apgd-eot", "bpda"] + (["aa-standard"] if args.standard else [])

        def _write_partial(partial):
            blob = dict(partial, partial=True, wall_s=round(time.time() - t0, 1),
                        platform=device.type)
            with open(os.path.join(args.out, "results.json"), "w") as f:
                json.dump(blob, f, indent=2)

        results = run_demo_protocol(cfg, score, clf, diffusion_types=dtypes,
                                    attacks=tuple(attacks), log=say,
                                    checkpoint=_write_partial)
    results["wall_s"] = round(time.time() - t0, 1)
    results["platform"] = device.type
    fname = "dose_response.json" if args.sweep else "results.json"
    with open(os.path.join(args.out, fname), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({k: v for k, v in results.items() if k != "config"}, indent=2))
    return results


if __name__ == "__main__":
    main()
