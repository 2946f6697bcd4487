"""Defended model: purify, then classify, as one differentiable function
(port of diffpure_tpu/eval/defended.py:35), with its ``debug_dir`` dumps,
and the classifier-only ``UndefendedModel`` (:114).

[0, 1] NHWC in -> (ImageNet: bilinear resize to ``resize_to``) -> [-1, 1]
-> forward-diffuse and reverse-integrate -> [0, 1] -> classifier logits.
The purified image goes to the classifier at the purifier's size, as in
JAX. Every call takes its own noise (an integer
seed or a noise source, see purify/runners.py): the defence is randomised
by design. Attacks differentiate through it as ``purify_cfg.grad_mode``
says; under ``torch.inference_mode()`` it runs forward only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from diffpure_tpu_torch.ops.resize import bilinear_resize
from diffpure_tpu_torch.purify.config import PurifyConfig
from diffpure_tpu_torch.purify.runners import Noise, purify
from diffpure_tpu_torch.utils.images import dump_purification_debug

Tensor = torch.Tensor


@dataclasses.dataclass
class DefendedModel:
    """purify + classify with the [0, 1] NHWC input contract."""

    score_model: Callable[[Tensor, Tensor], Tensor]  # (x_img, t_labels) -> eps
    classifier: Callable[[Tensor], Tensor]           # x01 -> logits
    purify_cfg: PurifyConfig
    log_every: int = 5
    tag: str = "defended"
    resize_to: Optional[int] = None  # ImageNet: classifier 224, purifier 256
    debug_dir: Optional[str] = None  # PNG dumps of the first two purifications

    def __post_init__(self):
        self.reset_counter()

    def purify(self, x01: Tensor, noise: Noise) -> Tensor:
        """[0, 1] -> purified [0, 1]. With ``debug_dir``, the first two
        calls dump their first 8 inputs and purified images in [-1, 1]
        (``utils.images.dump_purification_debug``; JAX's ``_host_dump``);
        without it nothing leaves the device."""
        if self.resize_to is not None and x01.shape[1] != self.resize_to:
            x01 = bilinear_resize(x01, self.resize_to)
        x = (x01 - 0.5) * 2.0
        x_pure = purify(self.score_model, x, noise, self.purify_cfg)
        if self.debug_dir is not None and self._dump_count < 2:
            dump_purification_debug(self.debug_dir, self._dump_count, self.tag,
                                    x_input=x[:8], x_purified=x_pure[:8])
            self._dump_count += 1
        return (x_pure + 1.0) * 0.5

    def classify(self, x01: Tensor) -> Tensor:
        return self.classifier(x01)

    def __call__(self, x01: Tensor, noise: Noise) -> Tensor:
        """purify_and_classify; counts calls and reports every
        ``log_every``-th (ref eval_sde_adv.py:57-91)."""
        if self._t0 is None:
            self._t0 = time.time()
        self._counter += 1
        if self.log_every and self._counter % self.log_every == 0:
            print(f"[{self.tag}] diffusion calls: {self._counter}, shape "
                  f"{tuple(x01.shape)}, {time.time() - self._t0:.1f}s elapsed")
        return self.classify(self.purify(x01, noise))

    def reset_counter(self):
        self._counter = 0
        self._dump_count = 0
        self._t0 = None


@dataclasses.dataclass
class UndefendedModel:
    """Classifier-only wrapper with the same three modes: purify is the
    identity (the BPDA driver's undefended baseline, ref
    eval_sde_adv_bpda.py:31-50)."""

    classifier: Callable[[Tensor], Tensor]

    def purify(self, x01: Tensor, noise: Noise) -> Tensor:
        return x01

    def classify(self, x01: Tensor) -> Tensor:
        return self.classifier(x01)

    def __call__(self, x01: Tensor, noise: Noise) -> Tensor:
        return self.classify(x01)
