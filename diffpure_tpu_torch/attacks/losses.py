"""Attack loss functions (port of diffpure_tpu/attacks/losses.py).

The AutoAttack definitions (CE, DLR, targeted DLR), Square's margin and
mister_ed's CW-f6 (ref stadv_eot/recoloradv/mister_ed/loss_functions.py:
214-244). Per-example losses, to be maximised by the attack.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _pick(logits: Tensor, y: Tensor) -> Tensor:
    return logits.gather(-1, y[:, None].long())[:, 0]


def ce_loss(logits: Tensor, y: Tensor) -> Tensor:
    """Per-example cross-entropy."""
    return -_pick(torch.log_softmax(logits, dim=-1), y)


def dlr_loss(logits: Tensor, y: Tensor) -> Tensor:
    """APGD-DLR: -(z_y - max_{i!=y} z_i) / (z_p1 - z_p3 + 1e-12)."""
    z_y = _pick(logits, y)
    z = torch.sort(logits, dim=-1).values  # ascending
    zmax_other = torch.where(z[:, -1] == z_y, z[:, -2], z[:, -1])
    return -(z_y - zmax_other) / (z[:, -1] - z[:, -3] + 1e-12)


def dlr_loss_targeted(logits: Tensor, y: Tensor, y_target: Tensor) -> Tensor:
    """Targeted DLR: -(z_y - z_t) / (z_p1 - (z_p3 + z_p4)/2 + 1e-12)."""
    z = torch.sort(logits, dim=-1).values
    denom = z[:, -1] - 0.5 * (z[:, -3] + z[:, -4]) + 1e-12
    return -(_pick(logits, y) - _pick(logits, y_target)) / denom


def margin_loss(logits: Tensor, y: Tensor) -> Tensor:
    """z_y - max_{i!=y} z_i (negative == misclassified). Square's objective."""
    mask = torch.nn.functional.one_hot(y.long(), logits.shape[-1]).bool()
    masked = logits.masked_fill(mask, float("-inf"))
    return _pick(logits, y) - masked.max(dim=-1).values


def cw_f6_loss(logits: Tensor, y: Tensor, kappa: float = 0.0) -> Tensor:
    """Carlini-Wagner f6: max(z_other_max - z_y, -kappa), mister_ed's sign."""
    return torch.clamp(-margin_loss(logits, y), min=-kappa)
