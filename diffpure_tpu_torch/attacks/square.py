"""Square attack: gradient-free random search (Andriushchenko et al. 2020),
Linf and L2, as AutoAttack's 'standard' suite runs it (port of
diffpure_tpu/attacks/square.py).

Linf: a vertical-stripe init (+-eps per column and channel), then each
query rewrites one s x s window of the perturbation with a +-eps colour per
channel. L2: an init of dipole eta patterns on a grid of H // 5 cells
(centred at upstream's sp_init, each cell with its own sign per channel and
a random transpose), then each query places a dipole pattern, scaled to the
norm budget its window frees, and projects onto the ball. Both shrink the
window on the ``_p_selection`` schedule, accept a query only when it lowers
the margin loss, and freeze an example once it is fooled. As in JAX, a
window whose draw leaves the perturbation unchanged is not redrawn.

``draws`` injects the random sequence (parity tests pass JAX's, as
tests/test_square_parity.py holds JAX against upstream's loop): Linf keys
stripes (B,1,W,C), vh / vw (n,B), color (n,B,1,1,C); L2 keys signs0
(ncells,B,1,1,C), transpose0 (ncells,B), vh / vw (n,B), signs (n,B,1,1,C),
orient (n,B). Otherwise the draws come from generators with JAX's key
layout: the init from fold_in(seed, 0) (L2: its streams 0 and 1 for the
signs and the transposes), query i from k_i = fold_in(fold_in(seed, 1), i),
split as fold_in(k_i, j) into row, column, colour (and orientation); the
model sees fold_in(fold_in(seed, 1), 2**31 - 1) at the init and
fold_in(k_i, 7) at query i. Model calls run without a graph.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from diffpure_tpu_torch.attacks.losses import margin_loss
from diffpure_tpu_torch.utils.prng import fold_in, generator

Tensor = torch.Tensor
ModelFn = Callable[[Tensor, int], Tensor]  # (x01, seed) -> logits


@dataclasses.dataclass(frozen=True)
class SquareConfig:
    norm: str = "Linf"
    eps: float = 8 / 255
    n_queries: int = 5000
    p_init: float = 0.8
    seed: int = 0
    # kept so that configs carry over from the JAX package; changes nothing
    # in eager PyTorch (see APGDConfig.iters_per_dispatch)
    iters_per_dispatch: int = 0


def _p_selection(p_init: float, it: int, n_queries: int) -> float:
    """Piecewise square-size schedule (AutoAttack square.py; JAX :36)."""
    it = int(it / n_queries * 10000)
    for upper, div in ((10, 1), (50, 2), (200, 4), (500, 8), (1000, 16), (2000, 32),
                       (4000, 64), (6000, 128), (8000, 256)):
        if it <= upper:
            return p_init / div
    return p_init / 512


def _rect_mask(B: int, H: int, W: int, vh: Tensor, vw: Tensor, s: int) -> Tensor:
    """(B, H, W, 1) mask of an s x s window at per-example corner (vh, vw)."""
    rows = torch.arange(H, device=vh.device)[None, :, None]
    cols = torch.arange(W, device=vh.device)[None, None, :]
    vh, vw = vh[:, None, None], vw[:, None, None]
    mask = (rows >= vh) & (rows < vh + s) & (cols >= vw) & (cols < vw + s)
    return mask[..., None]


def _bcast(v: Tensor) -> Tensor:
    return v.reshape(-1, 1, 1, 1)


def _norm(v: Tensor) -> Tensor:
    return v.reshape(v.shape[0], -1).square().sum(-1).sqrt()


def _pm(gen: torch.Generator, shape, value: float, device) -> Tensor:
    """+-value with equal odds (jax.random.choice over [-value, value])."""
    r = torch.randint(0, 2, shape, generator=gen, device=device)
    return torch.where(r == 1, torch.tensor(value, device=device),
                       torch.tensor(-value, device=device))


def _margins(model_fn: ModelFn, x: Tensor, y: Tensor, seed: int) -> Tensor:
    with torch.no_grad():
        return margin_loss(model_fn(x, seed).float(), y)


def square_attack(model_fn: ModelFn, x: Tensor, y: Tensor, seed: int,
                  cfg: SquareConfig, draws: Optional[dict] = None
                  ) -> Tuple[Tensor, Tensor]:
    """Returns (x_adv, found_mask)."""
    if cfg.norm not in ("Linf", "L2"):
        raise ValueError(cfg.norm)
    d = None if draws is None else {k: torch.as_tensor(np.asarray(v)).to(x.device)
                                    for k, v in draws.items()}
    run = _square_linf if cfg.norm == "Linf" else _square_l2
    x_best, margins = run(model_fn, x, y.long(), seed, cfg, d)
    found = margins < 0
    return torch.where(_bcast(found), x_best, x), found


def _accept(model_fn, x_new, x_best, margins, y, seed):
    """Keep the query where it lowers the margin of a not yet fooled
    example (upstream's idx_to_fool = margin > 0)."""
    m_new = _margins(model_fn, x_new, y, seed)
    accept = (m_new < margins) & (margins > 0)
    return torch.where(_bcast(accept), x_new, x_best), torch.where(accept, m_new, margins)


def _square_linf(model_fn, x, y, seed, cfg: SquareConfig, d):
    B, H, W, C = x.shape
    eps, dev = cfg.eps, x.device
    key = fold_in(seed, 1)
    stripes = d["stripes"] if d is not None else _pm(
        generator(fold_in(seed, 0), device=dev), (B, 1, W, C), eps, dev)
    x_best = torch.clamp(x + stripes, 0.0, 1.0)
    margins = _margins(model_fn, x_best, y, fold_in(key, 2 ** 31 - 1))
    n_feat = C * H * W
    for i in range(cfg.n_queries):
        p = _p_selection(cfg.p_init, i, cfg.n_queries)
        s = min(max(int(round(np.sqrt(p * n_feat / C))), 1), H - 1)
        k_i = fold_in(key, i)
        if d is None:
            vh = torch.randint(0, H - s + 1, (B,), generator=generator(k_i, 0, device=dev),
                               device=dev)
            vw = torch.randint(0, W - s + 1, (B,), generator=generator(k_i, 1, device=dev),
                               device=dev)
            color = _pm(generator(k_i, 2, device=dev), (B, 1, 1, C), eps, dev)
        else:
            vh, vw, color = d["vh"][i], d["vw"][i], d["color"][i]
        mask = _rect_mask(B, H, W, vh, vw, s)
        new_delta = torch.where(mask, torch.clamp(color, -eps, eps), x_best - x)
        x_new = torch.clamp(torch.minimum(torch.maximum(x + new_delta, x - eps), x + eps),
                            0.0, 1.0)
        x_best, margins = _accept(model_fn, x_new, x_best, margins, y, fold_in(k_i, 7))
    return x_best, margins


def _pseudo_gaussian_rect(x: int, y: int) -> np.ndarray:
    """Concentric pseudo-Gaussian rings over an x*y rectangle, unit L2 norm
    (upstream pseudo_gaussian_pert_rectangles; JAX :145)."""
    delta = np.zeros((x, y), dtype=np.float64)
    x_c, y_c = x // 2 + 1, y // 2 + 1
    counter2 = [x_c - 1, y_c - 1]
    for counter in range(0, max(x_c, y_c)):
        lo_r = max(counter2[0], 0)
        hi_r = min(counter2[0] + (2 * counter + 1), x)
        lo_c = max(counter2[1], 0)
        hi_c = min(counter2[1] + (2 * counter + 1), y)
        delta[lo_r:hi_r, lo_c:hi_c] += 1.0 / (counter + 1) ** 2
        counter2[0] -= 1
        counter2[1] -= 1
    norm = np.sqrt(np.sum(delta ** 2))
    if norm > 0:
        delta /= norm
    return delta


def _eta_pattern(s: int) -> np.ndarray:
    """The L2 meta-pattern: a +/- dipole of pseudo-Gaussian halves, unit L2
    norm (upstream meta_pseudo_gaussian_pert without its transpose, which
    the orientation draw applies; JAX :165)."""
    delta = np.zeros((s, s), dtype=np.float64)
    if s // 2 > 0:
        delta[:s // 2] = _pseudo_gaussian_rect(s // 2, s)
        delta[s // 2:] = _pseudo_gaussian_rect(s - s // 2, s) * (-1.0)
    else:
        delta[:] = _pseudo_gaussian_rect(s, s)
    norm = np.sqrt(np.sum(delta ** 2))
    if norm > 0:
        delta /= norm
    return delta


def l2_sizes(H: int, C: int, W: int, n_queries: int, p_init: float):
    """Query i's odd window size s_i in [3, H - 1 or H - 2] (JAX :218-226)."""
    n_feat = C * H * W
    out = []
    for i in range(n_queries):
        s = max(int(round(np.sqrt(_p_selection(p_init, i, n_queries) * n_feat / C))), 3)
        if s % 2 == 0:
            s += 1
        s = max(min(s, H - 1 if (H - 1) % 2 == 1 else H - 2), 3)
        out.append(s)
    return out


def l2_init_cells(H: int, W: int):
    """(s0, [(row, col) of each init cell]): H // s0 x W // s0 cells of
    side s0 = max(H // 5, 1), anchored at upstream's sp_init =
    (H - s0 (H // s0)) // 2 (JAX :185-196)."""
    s0 = H // 5 if H // 5 >= 1 else 1
    sp_h = (H - s0 * (H // s0)) // 2
    sp_w = (W - s0 * (W // s0)) // 2
    return s0, [(sp_h + ih * s0, sp_w + iw * s0)
                for ih in range(H // s0) for iw in range(W // s0)]


def _square_l2(model_fn, x, y, seed, cfg: SquareConfig, d):
    B, H, W, C = x.shape
    eps, dev = cfg.eps, x.device
    k0, key = fold_in(seed, 0), fold_in(seed, 1)
    s0, cells = l2_init_cells(H, W)
    eta0 = torch.from_numpy(_eta_pattern(s0).astype(np.float32)).to(dev)
    if d is not None:
        cell_signs, cell_tr = d["signs0"], d["transpose0"].bool()
    else:
        cell_signs = _pm(generator(k0, 0, device=dev), (len(cells), B, 1, 1, C), 1.0, dev)
        cell_tr = torch.rand((len(cells), B), generator=generator(k0, 1, device=dev),
                             device=dev) < 0.5
    d0 = torch.zeros_like(x)
    for ci, (ih, iw) in enumerate(cells):
        pat = torch.where(_bcast(cell_tr[ci]), eta0.T[None, :, :, None], eta0[None, :, :, None])
        d0[:, ih:ih + s0, iw:iw + s0, :] += pat * cell_signs[ci]
    x_best = torch.clamp(x + d0 / _bcast(torch.clamp(_norm(d0), min=1e-12)) * eps, 0.0, 1.0)
    margins = _margins(model_fn, x_best, y, fold_in(key, 2 ** 31 - 1))

    sizes = l2_sizes(H, C, W, cfg.n_queries, cfg.p_init)
    uniq = sorted(set(sizes))
    smax = max(uniq)
    # both orientations of each size's pattern, zero-padded to smax
    bank = np.zeros((2, len(uniq), smax, smax), np.float32)
    for j, s in enumerate(uniq):
        bank[0, j, :s, :s] = _eta_pattern(s)
        bank[1, j, :s, :s] = _eta_pattern(s).T
    bank = torch.from_numpy(bank).to(dev)
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]
    for i in range(cfg.n_queries):
        s, eidx = sizes[i], uniq.index(sizes[i])
        k_i = fold_in(key, i)
        if d is None:
            vh = torch.randint(0, H - s + 1, (B,), generator=generator(k_i, 0, device=dev),
                               device=dev)
            vw = torch.randint(0, W - s + 1, (B,), generator=generator(k_i, 1, device=dev),
                               device=dev)
            signs = _pm(generator(k_i, 2, device=dev), (B, 1, 1, C), 1.0, dev)
            orient = (torch.rand((B,), generator=generator(k_i, 3, device=dev), device=dev)
                      < 0.5).long()
        else:
            vh, vw, signs, orient = d["vh"][i], d["vw"][i], d["signs"][i], d["orient"][i].long()
        mask = _rect_mask(B, H, W, vh, vw, s)
        # the pattern placed at (vh, vw): JAX rolls a zero-padded canvas; the
        # pattern never wraps (vh <= H - s), so this gather is the same
        r, c = rows - vh[:, None, None], cols - vw[:, None, None]
        inside = (r >= 0) & (r < smax) & (c >= 0) & (c < smax)
        placed = bank[orient[:, None, None], eidx, r.clamp(0, smax - 1), c.clamp(0, smax - 1)]
        pattern = torch.where(inside, placed, torch.zeros_like(placed))[..., None] * signs

        delta = x_best - x
        # the norm budget the window frees (AA redistributes its mass)
        win_norm = _norm(delta * mask)
        rest = torch.sqrt(torch.clamp(eps ** 2 - (_norm(delta) ** 2 - win_norm ** 2), min=0.0))
        new_delta = torch.where(mask, pattern * _bcast(rest), delta)
        new_delta = new_delta * _bcast(torch.clamp(
            eps / torch.clamp(_norm(new_delta), min=1e-12), max=1.0))
        x_new = torch.clamp(x + new_delta, 0.0, 1.0)
        x_best, margins = _accept(model_fn, x_new, x_best, margins, y, fold_in(k_i, 7))
    return x_best, margins
