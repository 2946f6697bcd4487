"""AutoAttack suite orchestration: standard / rand / custom versions (port
of diffpure_tpu/attacks/autoattack.py).

Mirrors the torch-only ``autoattack`` package's run_standard_evaluation and
the reference's version selection (ref eval_sde_adv.py:103-131):
  - 'standard': [apgd-ce, apgd-t, fab-t, square]
  - 'rand':     [apgd-ce, apgd-dlr] with EOT (eot_iter, for stochastic
                defences; ref eval_sde_adv.py:126-128)
  - 'custom':   a chosen subset via attacks_to_run
Each attack runs only on the examples still classified correctly (the
robust-flags protocol); robust accuracy is the fraction that survives all.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch

from diffpure_tpu_torch.attacks.apgd import APGDConfig, apgd_attack
from diffpure_tpu_torch.attacks.fab import FABConfig, fab_attack
from diffpure_tpu_torch.attacks.square import SquareConfig, square_attack
from diffpure_tpu_torch.utils.prng import fold_in

Tensor = torch.Tensor
ModelFn = Callable[[Tensor, int], Tensor]  # (x01, seed) -> logits

ATTACKS = ("apgd-ce", "apgd-dlr", "apgd-t", "fab-t", "square")


@dataclasses.dataclass(frozen=True)
class AutoAttackConfig:
    norm: str = "Linf"
    eps: float = 8 / 255
    version: str = "standard"  # 'standard' | 'rand' | 'custom'
    attacks_to_run: Tuple[str, ...] = ()
    eot_iter: int = 1
    n_iter: int = 100
    square_n_queries: int = 5000
    fab_n_target_classes: int = 9
    apgd_n_restarts: int = 1
    apgd_t_n_target_classes: int = 9
    seed: int = 0
    # dispatch bounds of the JAX package, kept so configs carry over; they
    # change nothing in eager PyTorch (see APGDConfig.iters_per_dispatch)
    apgd_iters_per_dispatch: int = 0
    fab_iters_per_dispatch: int = 0
    square_iters_per_dispatch: int = 0


class AutoAttack:
    """Suite runner. model_fn(x01, seed) -> logits. ``on_phase``, if given,
    is called with ``phase_results`` after each finished attack phase (a
    hook to persist a long suite's progress, JAX :56)."""

    def __init__(self, model_fn: ModelFn, cfg: AutoAttackConfig, log_fn=print,
                 on_phase=None):
        self.model_fn = model_fn
        self.cfg = cfg
        self.log = log_fn
        self.on_phase = on_phase
        if cfg.version == "standard":
            self.attacks = ["apgd-ce", "apgd-t", "fab-t", "square"]
        elif cfg.version == "rand":
            self.attacks = ["apgd-ce", "apgd-dlr"]
        elif cfg.version == "custom":
            self.attacks = list(cfg.attacks_to_run)
        else:
            raise ValueError(cfg.version)
        unknown = [a for a in self.attacks if a not in ATTACKS]
        if unknown:
            raise ValueError(f"unknown attacks {unknown}")

    def _run_one(self, name: str, x: Tensor, y: Tensor, seed: int):
        cfg = self.cfg
        if name == "fab-t":
            return fab_attack(self.model_fn, x, y, seed, FABConfig(
                norm=cfg.norm, eps=cfg.eps, n_iter=cfg.n_iter,
                n_target_classes=cfg.fab_n_target_classes,
                iters_per_dispatch=cfg.fab_iters_per_dispatch))
        if name == "square":
            return square_attack(self.model_fn, x, y, seed, SquareConfig(
                norm=cfg.norm, eps=cfg.eps, n_queries=cfg.square_n_queries,
                iters_per_dispatch=cfg.square_iters_per_dispatch))
        common = dict(norm=cfg.norm, eps=cfg.eps, n_iter=cfg.n_iter,
                      eot_iter=cfg.eot_iter,
                      iters_per_dispatch=cfg.apgd_iters_per_dispatch)
        if name == "apgd-t":
            a = APGDConfig(loss="dlr-targeted",
                           n_target_classes=cfg.apgd_t_n_target_classes, **common)
        else:
            a = APGDConfig(loss="ce" if name == "apgd-ce" else "dlr",
                           n_restarts=cfg.apgd_n_restarts, **common)
        return apgd_attack(self.model_fn, x, y, seed, a)

    def run_standard_evaluation(self, x: Tensor, y: Tensor, seed: int,
                                bs: Optional[int] = None
                                ) -> Tuple[Tensor, Tensor]:
        """Returns (x_adv, robust_flags).

        Each phase attacks only the still-robust subset, padded with
        duplicates to a power-of-two bucket capped at ``bs`` (JAX
        :104-157: there the bucket bounds recompiles; here it keeps the
        same batches, hence the same per-call noise, as the JAX suite).
        """
        with torch.no_grad():
            logits = self.model_fn(x, fold_in(seed, 7))
        robust = (logits.argmax(-1) == y).cpu()
        self.log(f"initial accuracy: {robust.float().mean().item():.2%}")
        x_adv = x.clone()
        n = x.shape[0]
        bs = bs or n
        self.phase_batch_sizes: List[int] = []  # per phase: examples attacked
        # per finished phase: (attack name, robust acc after it, attacked
        # count, seconds)
        self.phase_results: List[Tuple[str, float, int, float]] = []

        for i, name in enumerate(self.attacks):
            idx = torch.nonzero(robust)[:, 0]
            if idx.numel() == 0:
                break
            t0 = time.time()
            self.phase_batch_sizes.append(int(idx.numel()))
            bucket = min(bs, _next_pow2(idx.numel()))
            for start in range(0, idx.numel(), bucket):
                take = idx[start:start + bucket]
                pad = bucket - take.numel()  # pad the last chunk with duplicates
                sel = torch.cat([take, take[:1].repeat(pad)]) if pad else take
                sel_d = sel.to(x.device)
                xa, found = self._run_one(name, x[sel_d], y[sel_d],
                                          fold_in(seed, i * 1000 + start))
                found = found[:take.numel()].cpu()
                hit = take[found]
                x_adv[hit.to(x.device)] = xa[:take.numel()][found.to(x.device)]
                robust[hit] = False
            acc = robust.float().mean().item()
            self.log(f"{name}: robust accuracy {acc:.2%} "
                     f"(attacked {idx.numel()}, {time.time() - t0:.1f}s)")
            self.phase_results.append(
                (name, acc, int(idx.numel()), round(time.time() - t0, 1)))
            if self.on_phase is not None:
                self.on_phase(self.phase_results)

        return x_adv, robust.to(x.device)


def _next_pow2(k: int) -> int:
    p = 1
    while p < k:
        p *= 2
    return p
