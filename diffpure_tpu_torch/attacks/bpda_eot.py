"""BPDA+EOT attack: PGD where the purifier's backward pass is the identity
(port of diffpure_tpu/attacks/bpda_eot.py).

As the reference attack (ref bpda_eot/bpda_eot_attack.py):
  - the defended model splits into purify / classify stages
    (ref eval_sde_adv_bpda.py:108-118);
  - gradient: EOT over ``eot_attack_reps`` purifier samples, the CE loss
    with respect to the *purified* images (BPDA: the purifier's Jacobian is
    the identity, ref bpda_eot_attack.py:98-110). The purifier runs under
    ``torch.no_grad()``, the counterpart of JAX's ``stop_gradient``;
  - defence decision: mean softmax over ``eot_defense_reps`` purifier
    samples (ref :41-53);
  - an example that flips is verified with the full defence reps
    (ref :112-117), here on the full batch at a flip event, as JAX does
    (the same decisions as the reference's subset call);
  - l_inf / l_2 PGD update (ref :86-96).

``purify_fn(x01, seed)`` takes the port's integer seed; each call's seed is
``fold_in`` of the attack's at JAX's call sites: 10_000 for the clean
decision, the step for each PGD step, 555 for a flip's verification, the
chunk index for each defence chunk and 7000 + r for chunk r of the attack
reps when ``attack_batch`` splits them (a reference quirk kept on purpose,
ROADMAP Queue 3). The purifier's score evaluations reach the NFE ledger
through its solver (utils/profiling.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diffpure_tpu_torch.utils.prng import fold_in

Tensor = torch.Tensor
PurifyFn = Callable[[Tensor, int], Tensor]  # (x01, seed) -> purified x01
ClassifyFn = Callable[[Tensor], Tensor]     # x01 -> logits


@dataclasses.dataclass(frozen=True)
class BPDAEOTConfig:
    adv_eps: float = 8 / 255
    adv_eta: float = 2 / 255
    adv_steps: int = 50
    eot_defense_reps: int = 150
    eot_attack_reps: int = 15
    attack_norm: str = "l_inf"  # 'l_inf' | 'l_2'
    defense_batch: int = 30  # defence reps purified per call
    # attack-EOT reps purified per call; 0 = all reps in one call. Chunks
    # draw per-chunk folded seeds (7000 + r), as in JAX.
    attack_batch: int = 0


def _rep_predict(purify_fn: PurifyFn, classify_fn: ClassifyFn, x: Tensor,
                 seed: int, reps: int, chunk: int) -> Tensor:
    """Mean softmax over ``reps`` purifier samples, ``chunk`` reps a call,
    the reps tiled rep-major (ref :41-53)."""
    B = x.shape[0]
    acc = None
    done = r = 0
    with torch.no_grad():
        while done < reps:
            n = min(chunk, reps - done)
            purified = purify_fn(x.repeat(n, 1, 1, 1), fold_in(seed, r))
            p = F.softmax(classify_fn(purified).float(), -1).reshape(n, B, -1).sum(0)
            acc = p if acc is None else acc + p
            done += n
            r += 1
    return acc / reps


def defense_predict(purify_fn: PurifyFn, classify_fn: ClassifyFn, x: Tensor,
                    seed: int, cfg: BPDAEOTConfig) -> Tensor:
    probs = _rep_predict(purify_fn, classify_fn, x, seed,
                         cfg.eot_defense_reps, cfg.defense_batch)
    return probs.argmax(-1)


def _attack_grad_core(purify_fn: PurifyFn, classify_fn: ClassifyFn, x: Tensor,
                      y: Tensor, seed: int, n: int) -> Tuple[Tensor, Tensor]:
    """(softmax-probability SUM, BPDA-gradient SUM) over ``n`` purifier
    samples (ref :98-110): sums, so chunks add up and are normalised once."""
    B = x.shape[0]
    x_rep = x.detach().repeat(n, 1, 1, 1)
    with torch.no_grad():
        purified = purify_fn(x_rep, seed)  # the BPDA cut (ref :100)
    with torch.enable_grad():
        p = purified.detach().requires_grad_(True)
        logits = classify_fn(p).float()
        loss = -F.log_softmax(logits, -1).gather(
            1, y.long().repeat(n)[:, None]).sum()
        (g,) = torch.autograd.grad(loss, p)
        if purified.shape[1:3] != x_rep.shape[1:3]:
            # the purifier runs at another size (ImageNet: classifier 224,
            # diffusion 256, DefendedModel.purify's bilinear resize): pull
            # the gradient back through the resize's exact adjoint
            from diffpure_tpu_torch.eval.defended import bilinear_resize
            xr = x_rep.requires_grad_(True)
            (g,) = torch.autograd.grad(bilinear_resize(xr, purified.shape[1]), xr, g)
    grad_sum = g.reshape((n, B) + tuple(x.shape[1:])).sum(0)
    probs_sum = F.softmax(logits.detach(), -1).reshape(n, B, -1).sum(0)
    return probs_sum, grad_sum


def _attack_grad(purify_fn: PurifyFn, classify_fn: ClassifyFn, x: Tensor,
                 y: Tensor, seed: int, cfg: BPDAEOTConfig
                 ) -> Tuple[Tensor, Tensor]:
    """(correct mask, BPDA gradient) over ``eot_attack_reps``, in one call
    or in chunks of ``attack_batch`` reps."""
    reps = cfg.eot_attack_reps
    if not 0 < cfg.attack_batch < reps:
        probs_sum, grad_sum = _attack_grad_core(purify_fn, classify_fn, x, y,
                                                seed, reps)
    else:
        probs_sum = grad_sum = None
        done = r = 0
        while done < reps:
            n = min(cfg.attack_batch, reps - done)
            ps, gs = _attack_grad_core(purify_fn, classify_fn, x, y,
                                       fold_in(seed, 7000 + r), n)
            probs_sum = ps if probs_sum is None else probs_sum + ps
            grad_sum = gs if grad_sum is None else grad_sum + gs
            done += n
            r += 1
    correct = (probs_sum / reps).argmax(-1) == y
    return correct, grad_sum / reps


def _pgd_update(x_adv: Tensor, grad: Tensor, x0: Tensor,
                cfg: BPDAEOTConfig) -> Tensor:
    """ref bpda_eot_attack.py:86-96."""
    B = x_adv.shape[0]
    if cfg.attack_norm == "l_inf":
        x_adv = x_adv + cfg.adv_eta * torch.sign(grad)
        x_adv = torch.minimum(torch.maximum(x_adv, x0 - cfg.adv_eps), x0 + cfg.adv_eps)
    else:
        gn = grad.reshape(B, -1).pow(2).sum(-1).sqrt().reshape(-1, 1, 1, 1)
        x_adv = x_adv + cfg.adv_eta * grad / gn.clamp_min(1e-12)
        d = x_adv - x0
        dn = d.reshape(B, -1).pow(2).sum(-1).sqrt().reshape(-1, 1, 1, 1)
        x_adv = x0 + d * torch.clamp(cfg.adv_eps / dn.clamp_min(1e-12), max=1.0)
    return x_adv.clamp(0.0, 1.0)


def bpda_eot_attack(purify_fn: PurifyFn, classify_fn: ClassifyFn, x: Tensor,
                    y: Tensor, seed: int, cfg: BPDAEOTConfig,
                    log: Optional[Callable[[str], None]] = None
                    ) -> Tuple[Tensor, np.ndarray]:
    """Returns (x_adv, class_batch): class_batch is the (adv_steps + 2, B)
    bool matrix of examples still defended after each step (ref :127-167).
    ``log`` gets one line per PGD step."""
    t0 = time.time()
    x = x.detach()
    B = x.shape[0]
    class_batch = np.zeros((cfg.adv_steps + 2, B), dtype=bool)
    y_host = y.cpu()

    # step 0: the defence's decision on the clean inputs
    pred0 = defense_predict(purify_fn, classify_fn, x, fold_in(seed, 10_000), cfg)
    defended = (pred0.cpu() == y_host).numpy()
    class_batch[0] = defended

    x_adv = x
    for step in range(cfg.adv_steps + 1):
        k_step = fold_in(seed, step)
        correct, grad = _attack_grad(purify_fn, classify_fn, x_adv, y, k_step, cfg)
        correct = correct.cpu().numpy()
        if step == 0:
            class_batch[1] = defended
        else:
            # flip candidates: defended so far, wrong under the attack reps
            flipped = defended & ~correct
            if flipped.any():
                pred = defense_predict(purify_fn, classify_fn, x_adv,
                                       fold_in(k_step, 555), cfg)
                verified_wrong = (pred.cpu() != y_host).numpy()
                defended = defended & ~(flipped & verified_wrong)
            class_batch[step + 1] = defended
        if log is not None:
            log(f"[bpda] step {step}/{cfg.adv_steps}: defended "
                f"{int(defended.sum())}/{B} ({time.time() - t0:.0f}s)")
        if step < cfg.adv_steps:
            x_adv = _pgd_update(x_adv, grad, x, cfg)
    return x_adv, class_batch
