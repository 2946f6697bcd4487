"""Resumable robustness evaluation (port of diffpure_tpu/eval/resume.py).

The reference has no resume for an interrupted evaluation (SURVEY.md
§5.3). Here each attack phase checkpoints (x_adv, robust flags) to disk;
running the same evaluation again skips the finished phases.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from diffpure_tpu_torch.utils.prng import fold_in


class EvalCheckpoint:
    """Per-phase (x_adv, robust) persistence under <log_dir>/eval_state/."""

    def __init__(self, log_dir: str):
        self.dir = os.path.join(log_dir, "eval_state")
        os.makedirs(self.dir, exist_ok=True)
        self._meta_path = os.path.join(self.dir, "meta.json")
        self.meta = {}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)

    def has_phase(self, name: str) -> bool:
        return name in self.meta.get("completed", [])

    def load_phase(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        x_adv = np.load(os.path.join(self.dir, f"{name}_x_adv.npy"))
        robust = np.load(os.path.join(self.dir, f"{name}_robust.npy"))
        return x_adv, robust

    def save_phase(self, name: str, x_adv, robust) -> None:
        np.save(os.path.join(self.dir, f"{name}_x_adv.npy"), np.asarray(x_adv))
        np.save(os.path.join(self.dir, f"{name}_robust.npy"), np.asarray(robust))
        completed = self.meta.setdefault("completed", [])
        if name not in completed:
            completed.append(name)
        with open(self._meta_path, "w") as f:
            json.dump(self.meta, f)


def resumable_autoattack(aa, x: torch.Tensor, y: torch.Tensor, seed: int,
                         log_dir: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run an AutoAttack suite (``attacks.AutoAttack``) with per-attack
    resume; returns (x_adv, robust flags). Without ``log_dir`` it is the
    plain run."""
    if log_dir is None:
        return aa.run_standard_evaluation(x, y, seed)

    ckpt = EvalCheckpoint(log_dir)
    with torch.no_grad():
        logits = aa.model_fn(x, fold_in(seed, 7))
    robust = (logits.argmax(-1) == y).cpu().numpy()
    x_adv = x.detach().float().cpu().numpy().copy()

    for i, name in enumerate(aa.attacks):
        if ckpt.has_phase(name):
            x_adv, robust = ckpt.load_phase(name)
            aa.log(f"{name}: resumed (robust accuracy {robust.mean():.2%})")
            continue
        if not robust.any():
            ckpt.save_phase(name, x_adv, robust)
            continue
        xa, found = aa._run_one(name, x, y, fold_in(seed, i))
        xa = xa.detach().float().cpu().numpy()
        found = found.cpu().numpy()
        newly = robust & found
        x_adv[newly] = xa[newly]
        robust = robust & ~found
        ckpt.save_phase(name, x_adv, robust)
        aa.log(f"{name}: robust accuracy {robust.mean():.2%} (checkpointed)")

    return torch.from_numpy(x_adv).to(x.device), torch.from_numpy(robust).to(x.device)
