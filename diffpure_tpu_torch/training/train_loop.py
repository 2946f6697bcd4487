"""Diffusion training loop with checkpoint and resume (port of
diffpure_tpu/training/train_loop.py; ref guided_diffusion/train_util.py:30-309).

Each step draws timesteps from the schedule sampler, takes
``GaussianDiffusion.training_losses`` through the model, and updates the
parameters with Adam (AdamW with ``weight_decay``) at a linearly annealed
learning rate, then one EMA per rate. Every draw of step s comes from the
counter-based streams (seed, s, 0) and (seed, s, 1) (utils/prng.py), so a
resumed loop takes the same draws as one that never stopped.

Checkpoints are ``torch.save`` files ``step_XXXXXXXX.pt`` holding
{params (the model's state dict), opt_state, emas (each EMA's shadow),
step}; JAX writes the same tree with orbax. Data parallelism waits for
ROADMAP item 20.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from diffpure_tpu_torch.diffusion.discrete import GaussianDiffusion
from diffpure_tpu_torch.models.ema import ExponentialMovingAverage
from diffpure_tpu_torch.training.losses import Adam, apply_updates, global_norm
from diffpure_tpu_torch.training.resample import UniformSampler
from diffpure_tpu_torch.utils import kvlogger
from diffpure_tpu_torch.utils.prng import generator


@dataclasses.dataclass
class TrainLoop:
    model: nn.Module
    diffusion: GaussianDiffusion
    data: Iterator  # yields (x NHWC in [-1, 1], model_kwargs)
    batch_size: int
    lr: float
    ema_rate: Sequence[float] = (0.9999,)
    log_interval: int = 10
    save_interval: int = 10000
    resume_checkpoint: str = ""
    weight_decay: float = 0.0
    lr_anneal_steps: int = 0
    schedule_sampler: Optional[object] = None
    checkpoint_dir: str = "checkpoints"
    seed: int = 0

    def __post_init__(self):
        self.step = 0
        self.schedule_sampler = (self.schedule_sampler
                                 or UniformSampler(self.diffusion.num_timesteps))
        self.params = list(self.model.parameters())
        self.opt = Adam(lr=self._lr_schedule, weight_decay=self.weight_decay)
        self.opt_state = self.opt.init(self.params)
        self.emas = [ExponentialMovingAverage(self.params, r, use_num_updates=False)
                     for r in self.ema_rate]
        if self.resume_checkpoint:
            self._load_checkpoint(self.resume_checkpoint)

    def _lr_schedule(self, step: int) -> float:
        """Linear anneal (ref train_util.py:260-268), float32 as in JAX."""
        if not self.lr_anneal_steps:
            return self.lr
        frac = min(np.float32(step) / np.float32(self.lr_anneal_steps), np.float32(1.0))
        return float(np.float32(self.lr) * (np.float32(1.0) - frac))

    def run_step(self, batch: torch.Tensor,
                 model_kwargs: Optional[dict] = None) -> torch.Tensor:
        """One step; its loss as a 0-d tensor. Nothing in the step waits
        for the device: the loss and the gradient norm are logged as
        tensors, read when the logger dumps them."""
        dev = batch.device
        t, weights = self.schedule_sampler.sample(
            generator(self.seed, self.step, 0, device=dev), batch.shape[0], device=dev)
        kwargs = model_kwargs or {}
        terms = self.diffusion.training_losses(
            lambda x, tt: self.model(x, tt, **kwargs), batch, t,
            generator=generator(self.seed, self.step, 1, device=dev))
        loss = (terms["loss"] * weights).mean()
        grads = torch.autograd.grad(loss, self.params)
        updates, self.opt_state = self.opt.update(grads, self.opt_state, self.params)
        apply_updates(self.params, updates)
        for e in self.emas:
            e.update(self.params)
        if hasattr(self.schedule_sampler, "update_with_losses"):
            self.schedule_sampler = self.schedule_sampler.update_with_losses(
                t, terms["loss"].detach())
        self.step += 1
        loss = loss.detach()
        kvlogger.logkv("step", self.step)
        kvlogger.logkv_mean("loss", loss)
        kvlogger.logkv_mean("grad_norm", global_norm(grads))
        return loss

    def run_loop(self, max_steps: Optional[int] = None) -> None:
        """ref train_util.py:129-160."""
        dev = self.params[0].device
        while not self.lr_anneal_steps or self.step < self.lr_anneal_steps:
            batch, model_kwargs = next(self.data)
            kwargs = {k: torch.as_tensor(v, device=dev) for k, v in model_kwargs.items()}
            self.run_step(torch.as_tensor(batch, device=dev), kwargs)
            if self.step % self.log_interval == 0:
                kvlogger.dumpkvs()
            if self.step % self.save_interval == 0:
                self.save()
            if max_steps is not None and self.step >= max_steps:
                break
        self.save()

    # --- checkpointing -------------------------------------------------------

    def _ckpt_path(self, step: int) -> str:
        return os.path.join(os.path.abspath(self.checkpoint_dir), f"step_{step:08d}.pt")

    def save(self) -> str:
        """ref train_util.py:270-300."""
        path = self._ckpt_path(self.step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(dict(params=self.model.state_dict(), opt_state=self.opt_state,
                        emas=[e.shadow_params for e in self.emas], step=self.step), path)
        kvlogger.log(f"saved checkpoint {path}")
        return path

    def _load_checkpoint(self, path: str) -> None:
        dev = self.params[0].device
        state = torch.load(os.path.abspath(path), map_location=dev, weights_only=True)
        with torch.no_grad():  # in place: the kernels' packs see the new version
            self.model.load_state_dict(state["params"])
        self.opt_state = state["opt_state"]
        for e, shadow in zip(self.emas, state["emas"], strict=True):
            e.shadow_params = list(shadow)
        self.step = int(state["step"])
        kvlogger.log(f"resumed from {path} at step {self.step}")
