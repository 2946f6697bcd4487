"""The defended forward served over a mesh of devices (port of
diffpure_tpu/parallel/serving.py).

JAX runs the whole defended step per shard under ``shard_map``, so that
its Pallas kernels see local batch tiles; here each shard's call runs on
its device's replica of the models, the shards in turn (their launches are
asynchronous, so the devices overlap as far as the call does not
synchronise), and the logits are concatenated in shard order. No
collective is needed: purify + classify is independent per example.

Randomness: ``shard_defended_call`` runs shard i = data_index * eot +
eot_index with fold_in(seed, i), as JAX folds the shard index into its
key, so identical inputs on two shards draw different defence noise, and
the noise depends on the mesh. ``ShardedDefendedModel``, the CLI's
multi-device path, keeps JAX's CLI semantics instead (there the batch is
sharded under one jit, and one draw covers the whole batch): each shard
takes its rows of the whole batch's noise (``purify.BatchSlice``), so the
result does not depend on the mesh, and any batch size splits, unevenly
where it must.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Callable

import torch

from diffpure_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from diffpure_tpu_torch.purify.runners import BatchSlice
from diffpure_tpu_torch.utils.prng import fold_in

Tensor = torch.Tensor


def _over_shards(mesh: Mesh, x01: Tensor, fn: Callable) -> Tensor:
    """``fn(i, device, shard)`` for each shard of x01's batch, the outputs
    concatenated in shard order on x01's device."""
    outs = [fn(i, d, xs) for i, (d, xs) in enumerate(zip(mesh.devices, shard_batch(x01, mesh)))]
    return torch.cat([o.to(x01.device) for o in outs])


def shard_defended_call(call: Callable, mesh: Mesh, *models) -> Callable:
    """Wrap ``call(*models, x01, seed) -> logits`` for ``mesh``: the models
    replicated once per device, the batch split into mesh.size shards.
    Returns ``fn(x01, seed)``, whose output lies on x01's device; x01's
    batch must divide by mesh.size."""
    replicas = [replicate(m, mesh) for m in models]
    return lambda x01, seed: _over_shards(mesh, x01, lambda i, d, xs: call(
        *(r[d] for r in replicas), xs, fold_in(seed, i)))


def _row_shards(mesh: Mesh, x01: Tensor, fn: Callable) -> Tensor:
    """``fn(device, shard, start, stop)`` for x01's rows split into mesh.size
    contiguous shards as even as they go (``tensor_split``: the first
    B % size shards one row longer; empty ones skipped), the outputs
    gathered in row order on x01's device. An output of k rows a row
    (purification's ``sample_step`` rounds, each a copy of the batch) is
    gathered round by round, as the unsharded call stacks them."""
    outs, start = [], 0
    for d, xs in zip(mesh.devices, x01.tensor_split(mesh.size)):
        stop = start + xs.shape[0]
        if stop > start:
            o = fn(d, xs.to(d), start, stop).to(x01.device)
            outs.append(o.reshape((-1, stop - start) + tuple(o.shape[1:])))
        start = stop
    return torch.cat(outs, dim=1).flatten(0, 1)


class ShardedDefendedModel:
    """A ``DefendedModel``'s three modes served over ``mesh`` (the CLI's
    multi-device path, JAX cli.py:174-185): one replica of its score model
    and classifier per device; a batch of any size in mesh.size shards;
    ``purify`` and the defended call give the shard of rows [a, b) those
    rows of the whole batch's noise, ``BatchSlice(seed, a, b, B)``, so that
    the output is the unsharded call's up to the rounding of a smaller
    batch. Seeds must be integers."""

    def __init__(self, defended, mesh: Mesh):
        self.mesh = mesh
        self.tile = defended.purify_cfg.fix_rand
        scores = replicate(defended.score_model, mesh)
        clfs = replicate(defended.classifier, mesh)
        self.replicas = {d: dataclasses.replace(defended, score_model=scores[d],
                                                classifier=clfs[d]) for d in scores}

    def _noise(self, seed: int, start: int, stop: int, batch: int) -> BatchSlice:
        return BatchSlice(operator.index(seed), start, stop, batch, self.tile)

    def purify(self, x01: Tensor, seed: int) -> Tensor:
        return _row_shards(self.mesh, x01, lambda d, xs, a, b: self.replicas[d].purify(
            xs, self._noise(seed, a, b, x01.shape[0])))

    def classify(self, x01: Tensor) -> Tensor:
        return _row_shards(self.mesh, x01, lambda d, xs, a, b: self.replicas[d].classify(xs))

    def __call__(self, x01: Tensor, seed: int) -> Tensor:
        return _row_shards(self.mesh, x01, lambda d, xs, a, b: self.replicas[d](
            xs, self._noise(seed, a, b, x01.shape[0])))
