"""The defended classifier of a configuration, twice: the program's
(``DefendedModel`` over ``diffpure_tpu_torch``'s models) and the
reference's (``reference.diffpure.Defence``), with the same weights, made
from the seed on the device."""
from __future__ import annotations

import gc
from typing import Optional

import torch

from gpubench.lib import seeding
from gpubench.models import family

SCORE, CLASSIFIER = 0, 1


def _weights(spec: dict, which: int, seed: int, device):
    fam = family(spec["family"])
    return seeding.state_dict(fam.reference(spec["args"]), seeding.mix(seed, which), device,
                              fam.fixed(spec["args"]))


def _load(module, sd):
    module.load_state_dict(sd, assign=True, strict=True)
    return module.eval().requires_grad_(False)


def program_models(cfg: dict, seed: int, device):
    """(score model, classifier) of the program, weights from ``seed``."""
    dtype = getattr(torch, cfg["dtype"])
    models = []
    for which, key in ((SCORE, "score_model"), (CLASSIFIER, "classifier")):
        spec = cfg[key]
        module = family(spec["family"]).port(spec["args"], dtype)
        models.append(_load(module, _weights(spec, which, seed, device)))
    return tuple(models)


def purify_config(cfg: dict, wl: dict, grad_mode: str, n_steps: Optional[int] = None):
    from diffpure_tpu_torch.purify import PurifyConfig
    return PurifyConfig(t=wl["t_star"], grad_mode=grad_mode, n_steps=n_steps,
                        score_type=cfg["purify"]["score_type"],
                        beta_min=cfg["purify"]["beta_min"], beta_max=cfg["purify"]["beta_max"])


def program_defence(cfg: dict, wl: dict, score, classifier, grad_mode: str,
                    n_steps: Optional[int] = None):
    from diffpure_tpu_torch.eval import DefendedModel
    return DefendedModel(score, classifier, purify_config(cfg, wl, grad_mode, n_steps),
                         log_every=0, resize_to=cfg["purify"].get("resize_to"))


def reference_defence(cfg: dict, wl: dict, seed: int, device, mode: str = "fp32"):
    """The reference's defence with the same weights (made again), its
    products in ``mode`` (reference/precision.py; ``fp64`` casts the models
    to float64)."""
    from gpubench.reference.diffpure import Defence

    models = []
    for which, key in ((SCORE, "score_model"), (CLASSIFIER, "classifier")):
        spec = cfg[key]
        module = family(spec["family"]).reference(spec["args"])
        models.append(_load(module, _weights(spec, which, seed, device)))
    for m in models:
        m.prec.mode = mode
        if mode == "fp64":
            m.double()
    p = cfg["purify"]
    return Defence(models[0], models[1], t_star=wl["t_star"], score_type=p["score_type"],
                   resize_to=p.get("resize_to"), beta_min=p["beta_min"], beta_max=p["beta_max"])


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def row_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| / |want| of each row (L2 over the row); inf where got
    is not finite."""
    d = (got.double() - want.double()).flatten(1).norm(dim=1)
    n = want.double().flatten(1).norm(dim=1).clamp_min(1e-30)
    bad = ~torch.isfinite(got.flatten(1)).all(dim=1)
    return torch.where(bad, torch.full_like(d, float("inf")), d / n)


def rel_rows(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's relative L2 error."""
    return float(row_errors(got, want).max())


def rel_all(got: torch.Tensor, want: torch.Tensor) -> float:
    """The relative L2 error of all rows together; inf where got is not
    finite."""
    if not torch.isfinite(got).all():
        return float("inf")
    d = (got.double() - want.double()).norm()
    return float(d / want.double().norm().clamp_min(1e-30))


def rel_rows_octile(got: torch.Tensor, want: torch.Tensor) -> float:
    """The relative L2 error of the row at the first octile (the
    (n // 8 + 1)-th best of n rows)."""
    errors = row_errors(got, want).sort().values
    return float(errors[len(errors) // 8])
