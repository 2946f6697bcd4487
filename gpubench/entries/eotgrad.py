"""EOT gradient samples: ``attacks/eot.eot_average`` of the input gradient of
the summed APGD-CE loss (``attacks/losses.ce_loss``) through
``DefendedModel`` with ``grad_mode="checkpoint"``, as APGD-EOT's gradient
function takes it; a fresh batch, labels and noise each call,
``eot_samples`` samples a call. A unit is a gradient-image: a row of one
sample.

Checked after the window: one call and ``check_rows`` of its rows, drawn
from the seed, through the reference (each step checkpointed too, in the
workload's ``reference`` precision): the last sample's logits by the
worst row's relative L2 error, the EOT-averaged input gradient by the
row's at the first octile and by the relative L2 error of all checked rows
together. WRN-28-10's ReLUs make the gradient jump where a pre-activation
crosses zero: any rounding (the float32 reference's own against float64
included) flips units in some rows, and such a row reads 1e-4 to 1e-2
however exact the rest. Against a float64 reference a sound program reads
~1e-6 on most rows, so the octile row measures the arithmetic, and all
rows together hold every row to the kinks' size: a row left out or wrong
reads 1."""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from gpubench.entries import purify
from gpubench.lib import defence, seeding
from gpubench.lib.trace import Span


class Session(purify.Session):
    def setup(self) -> None:
        from diffpure_tpu_torch.attacks.eot import eot_average
        from diffpure_tpu_torch.attacks.losses import ce_loss

        self._eot, self._ce = eot_average, ce_loss
        t0 = time.perf_counter()
        score, clf = defence.program_models(self.cfg, self.seed, self.device)
        self.score = Span(score, "score", triggers=True)
        self.clf = Span(self._capture(clf), "classifier")
        self.defended = defence.program_defence(self.cfg, self.wl, self.score, self.clf,
                                                 "checkpoint")
        warm = defence.program_defence(self.cfg, self.wl, self.score, self.clf, "checkpoint",
                                       n_steps=purify.WARM_STEPS)
        t1 = purify.synced(self.device)
        self._gradient(warm, -1)
        self.setup_phases = {"models": t1 - t0, "warm": purify.synced(self.device) - t1}

    def _gradient(self, defended, k: int):
        x = seeding.images(self.seed, k, self.shape, self.device)
        y = seeding.labels(self.seed, k, self.batch, self.cfg["classes"], self.device)
        last = {}

        def single(s: int):
            xx = x.detach().requires_grad_(True)
            logits = defended(xx, seeding.Noise(s))
            (g,) = torch.autograd.grad(self._ce(logits, y).sum(), xx)
            last["logits"] = logits.detach()
            return (g,)

        with torch.enable_grad():
            (g,) = self._eot(single, seeding.mix(self.seed, seeding.SAMPLE, k),
                             self.wl["eot_samples"])
        return g, last["logits"]

    def trace_window(self):
        """The whole traced call: its forward, the classifier's forward and
        backward, and the backward of every step (each recomputing its
        evaluation). The profiler may not stop inside a backward pass, so
        the window holds all of them and a step is the call over its
        ``t_star`` steps."""
        return 0, None, self.wl["t_star"]

    def call(self, k: int) -> int:
        self.score.evals = 0
        self.outputs[k] = self._gradient(self.defended, k)
        return self.batch * self.wl["eot_samples"]

    def flops_per_unit(self) -> float:
        """One forward and one input backward (as many FLOPs again); the
        checkpoint's recomputation is not counted."""
        return 2 * super().flops_per_unit()

    def reference(self, k: int, rows, mode: str = None):
        """The reference's outputs of call ``k``'s ``rows``, its products in
        ``mode`` (the workload's ``reference``, else fp32)."""
        ref = defence.reference_defence(self.cfg, self.wl, self.seed, self.device,
                                        mode or self.wl.get("reference", "fp32"))
        x = seeding.images(self.seed, k, self.shape, self.device)[rows]
        y = seeding.labels(self.seed, k, self.batch, self.cfg["classes"], self.device)[rows]
        n = self.wl["eot_samples"]
        grad = 0.0
        for j in range(n):
            s = seeding.fold_in(seeding.mix(self.seed, seeding.SAMPLE, k), j)
            xx = x.detach().requires_grad_(True)
            _, logits = ref(xx, seeding.Noise(s), self.batch, rows, checkpoint=True)
            (g,) = torch.autograd.grad(F.cross_entropy(logits, y, reduction="sum"), xx)
            grad = grad + g
        del ref
        defence.free(self.device)
        return grad / n, logits.detach()

    def numbers(self, got, want) -> dict:
        """(EOT-averaged input gradient, last sample's logits) of the same
        rows."""
        return {"grad_octile_rel_err": defence.rel_rows_octile(got[0], want[0]),
                "grad_rel_err": defence.rel_all(got[0], want[0]),
                "logits_rel_err": defence.rel_rows(got[1], want[1])}
