"""Data parallelism over batch x EOT on a list of devices (port of
diffpure_tpu/parallel/mesh.py).

JAX lays a ('data', 'eot') mesh over its devices and lets sharding
annotations place the batch; here a ``Mesh`` is that grid of
``torch.device``s, and the placement is explicit: ``shard_batch`` splits
the batch into contiguous shards in the order of JAX's
``P(("data", "eot"))`` (shard data_index * eot + eot_index), ``replicate``
keeps one copy of a module per distinct device. The serving path that
runs on them is ``parallel/serving.py``.

Unlike JAX's ``make_mesh``, which falls back to virtual CPU devices (with a
warning) when asked for more devices than the default platform has, the
default mesh here is over the CUDA devices and asking for more raises. A
mesh over CPU devices is built by passing them.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

Tensor = torch.Tensor


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-process rendezvous (JAX's ``jax.distributed.initialize``; ref
    dist_util.py:29-50): ``torch.distributed`` over NCCL where there is a
    card, else gloo, at ``coordinator_address`` (tcp://host:port). A no-op
    for one process."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo",
                            init_method=coordinator_address, world_size=num_processes,
                            rank=process_id)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, eot) grid of devices; ``devices`` row-major (shard
    data_index * eot + eot_index)."""
    devices: tuple
    data: int
    eot: int

    @property
    def size(self) -> int:
        return self.data * self.eot

    @property
    def shape(self) -> dict:
        return {"data": self.data, "eot": self.eot}


def make_mesh(data: Optional[int] = None, eot: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, eot) mesh over ``devices`` (default: every CUDA device);
    ``data`` defaults to what the devices leave after ``eot``. Raises when
    the devices are not data x eot, or when the default is asked for more
    CUDA devices than there are."""
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if data is not None and data * eot > n_cuda:
            raise ValueError(f"make_mesh: {data} x {eot} devices asked for, {n_cuda} CUDA "
                             f"device(s) present (pass devices= for a CPU mesh)")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if data is None:
        if not n or n % eot:
            raise ValueError(f"{n} devices do not split into eot groups of {eot}")
        data = n // eot
    if data * eot != n:
        raise ValueError(f"mesh wants {data} x {eot} devices, {n} given")
    return Mesh(devices, data, eot)


def shard_batch(x: Tensor, mesh: Mesh) -> List[Tensor]:
    """x's batch in mesh.size contiguous shards, shard i on the mesh's i-th
    device."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"a batch of {x.shape[0]} does not split into {mesh.size} shards")
    return [s.to(d) for s, d in zip(x.chunk(mesh.size), mesh.devices)]


def replicate(module: nn.Module, mesh: Mesh) -> Dict[torch.device, nn.Module]:
    """One copy of ``module`` per distinct device of the mesh: the module
    itself on the device it lies on, a deep copy moved to each other. A
    callable that is not a module holds no tensors: it serves every
    device itself."""
    if not isinstance(module, nn.Module):
        return {d: module for d in mesh.devices}
    try:
        home = next(module.parameters()).device
    except StopIteration:
        home = None
    out = {}
    for d in mesh.devices:
        if d not in out:
            out[d] = module if d == home else copy.deepcopy(module).to(d)
    return out


def eot_fold(x: Tensor, eot: int) -> Tensor:
    """Tile the batch for EOT repetitions: (B, ...) -> (eot B, ...) (ref
    bpda_eot_attack.py:99 X.repeat)."""
    return x.repeat((eot,) + (1,) * (x.ndim - 1))


def eot_unfold(v: Tensor, eot: int) -> Tensor:
    """(eot B, ...) -> (eot, B, ...)."""
    return v.reshape((eot, -1) + tuple(v.shape[1:]))
