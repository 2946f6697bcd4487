"""The defended forward: ``DefendedModel.__call__`` (purify, then classify)
under ``torch.inference_mode()``, a fresh batch of images and fresh noise
each call. A unit is an image.

Checked after the window: one call and ``check_rows`` of its rows, drawn
from the seed, through the reference: the purified images (the
classifier's input) and the logits, each by its worst row's relative L2
error."""
from __future__ import annotations

import time

import numpy as np
import torch

from gpubench.lib import defence, seeding
from gpubench.lib.trace import Span

WARM_STEPS = 2


def synced(device) -> float:
    """The host clock once the device has finished."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class Session:
    def __init__(self, wl: dict, cfg: dict, seed: int, device):
        self.wl, self.cfg, self.seed, self.device = wl, cfg, seed, device
        self.batch = wl["batch"]
        self.shape = (self.batch, cfg["input_size"], cfg["input_size"], 3)
        self.outputs = {}

    # -- the program --
    def setup(self) -> None:
        t0 = time.perf_counter()
        score, clf = defence.program_models(self.cfg, self.seed, self.device)
        self.score = Span(score, "score", triggers=True)
        self.clf = Span(self._capture(clf), "classifier")
        self.defended = defence.program_defence(self.cfg, self.wl, self.score, self.clf, "none")
        warm = defence.program_defence(self.cfg, self.wl, self.score, self.clf, "none",
                                       n_steps=WARM_STEPS)
        t1 = synced(self.device)
        with torch.inference_mode():
            warm(seeding.images(self.seed, -1, self.shape, self.device), seeding.Noise(-1))
        self.setup_phases = {"models": t1 - t0, "warm": synced(self.device) - t1}
        self._seen = None

    def _capture(self, clf):
        def run(x):
            self._seen = x
            return clf(x)
        return run

    def trace(self, tracer) -> None:
        """Hand the spans a tracer (None: no more tracing)."""
        self.score.tracer = self.clf.tracer = tracer

    def trace_window(self):
        """(first evaluation, evaluation that closes, solver steps) of the
        traced window."""
        start, steps = self.wl["trace"]["start"], self.wl["trace"]["steps"]
        return start, start + steps, steps

    def call(self, k: int) -> int:
        x = seeding.images(self.seed, k, self.shape, self.device)
        self.score.evals = 0
        with torch.inference_mode():
            logits = self.defended(x, seeding.Noise(seeding.mix(self.seed, seeding.SAMPLE, k)))
        self.outputs[k] = (self._seen, logits)
        return self.batch

    def flops_per_unit(self) -> float:
        f = self.cfg["flops"]
        return self.wl["t_star"] * f["score_forward"] + f["classifier_forward"]

    def failed(self) -> int:
        return sum(1 for p, l in self.outputs.values()
                   if not (torch.isfinite(p).all() and torch.isfinite(l).all()))

    def free(self) -> None:
        del self.defended, self.score, self.clf, self._seen
        defence.free(self.device)

    # -- the check --
    def sample(self):
        rng = np.random.default_rng(seeding.mix(self.seed, seeding.SAMPLE))
        k = int(rng.integers(len(self.outputs)))
        rows = sorted(rng.choice(self.batch, self.wl["check_rows"], replace=False).tolist())
        return k, rows

    def reference(self, k: int, rows, mode: str = None):
        """The reference's outputs of call ``k``'s ``rows``, its products in
        ``mode`` (the workload's ``reference``, else fp32)."""
        ref = defence.reference_defence(self.cfg, self.wl, self.seed, self.device,
                                        mode or self.wl.get("reference", "fp32"))
        x = seeding.images(self.seed, k, self.shape, self.device)[rows]
        with torch.no_grad():
            out = ref(x, seeding.Noise(seeding.mix(self.seed, seeding.SAMPLE, k)),
                      self.batch, rows)
        del ref
        defence.free(self.device)
        return out

    def numbers(self, got, want) -> dict:
        """The compared numbers of ``got`` against ``want``: (purified
        images, logits) of the same rows."""
        return {"purified_rel_err": defence.rel_rows(2 * got[0] - 1, 2 * want[0] - 1),
                "logits_rel_err": defence.rel_rows(got[1], want[1])}

    def check(self) -> dict:
        """The program's outputs of the sampled call and rows against the
        reference's."""
        k, rows = self.sample()
        return self.numbers(tuple(t[rows] for t in self.outputs[k]), self.reference(k, rows))
