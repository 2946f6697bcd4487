"""Robustness-evaluation drivers (port of diffpure_tpu/eval/drivers.py).

``eval_autoattack`` (ref eval_sde_adv.py:96-155) first attacks the
undefended classifier with the same suite (the paired-baseline check),
then attacks through the purifier, saving the adversarial images of each.
``eval_bpda``, ``eval_stadv`` and ``robustness_eval`` wait for ROADMAP
Queue 1 item 8 and Slice 2.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from diffpure_tpu_torch.attacks import AutoAttack, AutoAttackConfig
from diffpure_tpu_torch.eval.defended import DefendedModel
from diffpure_tpu_torch.utils.prng import fold_in

Tensor = torch.Tensor


def _save(log_dir: Optional[str], name: str, t: Tensor) -> None:
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        np.save(os.path.join(log_dir, name), t.detach().float().cpu().numpy())


def eval_autoattack(defended: DefendedModel, x: Tensor, y: Tensor, seed: int,
                    aa_cfg: AutoAttackConfig, log_dir: Optional[str] = None,
                    log=print) -> dict:
    """Robust accuracy of the classifier alone and of the defence under the
    suite ``aa_cfg``; returns {'classifier_robust_acc',
    'defended_robust_acc', 'x_adv'} (x_adv: the defended attack's points,
    which the JAX driver only saves)."""
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
    aa_def = AutoAttack(defended, aa_cfg, log_fn=lambda s: log(f"[sde] {s}"))
    x_adv, robust = aa_def.run_standard_evaluation(x, y, fold_in(seed, 1))
    results["defended_robust_acc"] = robust.float().mean().item()
    _save(log_dir, f"x_adv_defended_{aa_cfg.version}.npy", x_adv)
    log(f"x_adv_sde produced in {time.time() - t0:.1f}s; "
        f"defended robust acc {results['defended_robust_acc']:.2%}")
    results["x_adv"] = x_adv
    return results
