"""Robustness-evaluation drivers (port of diffpure_tpu/eval/drivers.py).

``eval_autoattack`` (ref eval_sde_adv.py:96-155) first attacks the
undefended classifier with the same suite (the paired-baseline check),
then attacks through the purifier, saving the adversarial images of each.
``eval_bpda`` (ref eval_sde_adv_bpda.py:121-174) does the same with
BPDA+EOT, and ``robustness_eval`` dispatches by attack version.
``eval_stadv`` waits for ROADMAP Slice 2 item 13.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from diffpure_tpu_torch.attacks import AutoAttack, AutoAttackConfig, \
    BPDAEOTConfig, bpda_eot_attack
from diffpure_tpu_torch.eval.defended import DefendedModel, UndefendedModel
from diffpure_tpu_torch.utils.prng import fold_in

Tensor = torch.Tensor


def _save(log_dir: Optional[str], name: str, t: Tensor) -> None:
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        np.save(os.path.join(log_dir, name), t.detach().float().cpu().numpy())


def eval_autoattack(defended: DefendedModel, x: Tensor, y: Tensor, seed: int,
                    aa_cfg: AutoAttackConfig, log_dir: Optional[str] = None,
                    log=print, on_phase=None) -> dict:
    """Robust accuracy of the classifier alone and of the defence under the
    suite ``aa_cfg``; returns {'classifier_robust_acc',
    'defended_robust_acc', 'x_adv'} (x_adv: the defended attack's points,
    which the JAX driver only saves). ``on_phase`` is the defended suite's
    ``AutoAttack`` hook: its (attack, robust accuracy after it, examples
    attacked, seconds) so far, after each phase."""
    results = {}

    # baseline: attack the undefended classifier (ref :114-133)
    t0 = time.time()
    aa_base = AutoAttack(lambda x01, s: defended.classify(x01), aa_cfg,
                         log_fn=lambda s: log(f"[clf] {s}"))
    x_adv_base, robust_base = aa_base.run_standard_evaluation(
        x, y, fold_in(seed, 0))
    results["classifier_robust_acc"] = robust_base.float().mean().item()
    _save(log_dir, f"x_adv_classifier_{aa_cfg.version}.npy", x_adv_base)
    log(f"x_adv_base produced in {time.time() - t0:.1f}s; "
        f"undefended robust acc {results['classifier_robust_acc']:.2%}")

    # attack through the purifier (ref :138-155)
    t0 = time.time()
    aa_def = AutoAttack(defended, aa_cfg, log_fn=lambda s: log(f"[sde] {s}"),
                        on_phase=on_phase)
    x_adv, robust = aa_def.run_standard_evaluation(x, y, fold_in(seed, 1))
    results["defended_robust_acc"] = robust.float().mean().item()
    _save(log_dir, f"x_adv_defended_{aa_cfg.version}.npy", x_adv)
    log(f"x_adv_sde produced in {time.time() - t0:.1f}s; "
        f"defended robust acc {results['defended_robust_acc']:.2%}")
    results["x_adv"] = x_adv
    return results


def eval_bpda(defended: DefendedModel, x: Tensor, y: Tensor, seed: int,
              cfg: BPDAEOTConfig, log_dir: Optional[str] = None, log=print,
              run_baseline: bool = True) -> dict:
    """BPDA+EOT through the purifier, after the same PGD on the undefended
    classifier (the ResNet_Adv_Model baseline, ref :129-150); returns
    {'classifier_init_acc', 'classifier_robust_acc', 'init_acc',
    'robust_acc', 'class_batch', 'x_adv'}."""
    results = {}

    if run_baseline:
        base = UndefendedModel(defended.classify)
        t0 = time.time()
        _, base_matrix = bpda_eot_attack(base.purify, base.classify, x, y,
                                         fold_in(seed, 999), cfg,
                                         log=lambda s: log(f"[clf] {s}"))
        results["classifier_init_acc"] = float(base_matrix[0].mean())
        results["classifier_robust_acc"] = float(base_matrix[-1].mean())
        log(f"[clf] init acc: {results['classifier_init_acc']:.2%}, "
            f"robust acc: {results['classifier_robust_acc']:.2%} "
            f"({time.time() - t0:.1f}s)")

    t0 = time.time()
    x_adv, class_batch = bpda_eot_attack(defended.purify, defended.classify,
                                         x, y, seed, cfg, log=log)
    _save(log_dir, "x_adv_bpda.npy", x_adv)
    results["init_acc"] = float(class_batch[0].mean())
    results["robust_acc"] = float(class_batch[-1].mean())
    results["class_batch"] = class_batch
    log(f"init acc: {results['init_acc']:.2%}, "
        f"robust acc: {results['robust_acc']:.2%} "
        f"({time.time() - t0:.1f}s)")
    results["x_adv"] = x_adv
    return results


def robustness_eval(defended: DefendedModel, x: Tensor, y: Tensor, seed: int,
                    attack_version: str, log_dir: Optional[str] = None,
                    log=print, **attack_kwargs) -> dict:
    """Dispatch by attack version (ref eval_sde_adv.py:211-242 and
    eval_sde_adv_bpda.py)."""
    if attack_version in ("standard", "rand", "custom"):
        aa_cfg = AutoAttackConfig(version=attack_version, **attack_kwargs)
        return eval_autoattack(defended, x, y, seed, aa_cfg, log_dir, log)
    if attack_version == "stadv":
        raise NotImplementedError(
            "attack_version='stadv' waits for ROADMAP Slice 2 item 13")
    if attack_version == "bpda":
        return eval_bpda(defended, x, y, seed, BPDAEOTConfig(**attack_kwargs),
                         log_dir, log)
    raise ValueError(f"unknown attack version {attack_version}")
