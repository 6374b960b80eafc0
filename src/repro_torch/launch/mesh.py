"""Device meshes: the training mesh over ranks, and the serving engine's
``kv`` mesh.

**The training mesh** (:func:`make_mesh`, :func:`make_production_mesh`,
:func:`make_debug_mesh`) is a ``torch.distributed`` ``DeviceMesh`` with
named dims, one process (rank) per mesh position, as ``torchrun`` starts
them. State and batch are DTensors placed by the JAX package's
PartitionSpec rules (``distributed.sharding``), and the unchanged train
step runs on them: DTensor's sharding propagation inserts the
collectives, as GSPMD does for the JAX package's ``jit`` with
``in_shardings``. Several ranks may share one device (gloo ranks on the
CPU, or on one card), the port's counterpart of the JAX tests'
``--xla_force_host_platform_device_count``.

**The kv mesh.** The JAX package builds a ``jax.sharding.Mesh`` and runs
one body per shard under ``shard_map`` from a single controlling process.
The port keeps that single-controller design: a :class:`KVMesh` is just
the ordered devices of the axis, and the code that shards over it
(``distributed.sharding.shard_apply``, the sharded pool step, the fused
kernel wrappers) launches each shard's work on that shard's device from
the one process and joins the results.

A kv mesh's ``devices`` list may repeat a device. That is the port's virtual-device
mode, its counterpart of the JAX tests'
``--xla_force_host_platform_device_count``: ``devices=["cpu"] * 4`` runs
four shards on the CPU, and ``devices=["cuda:0"] * 4`` four shards on one
card, each with its own storage and its own kernel launches over its own
rows, so the sharded path runs where there is one device.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class KVMesh:
    """A 1-D device mesh. ``shape`` maps the axis name to its size, so
    ``mesh.shape[kv_axis]`` reads as it does on a JAX mesh."""

    devices: tuple                     # torch.device per shard, in order
    axis_names: tuple = ("kv",)

    @property
    def shape(self) -> Mapping[str, int]:
        return {self.axis_names[0]: len(self.devices)}


def make_kv_mesh(n_shards: int, *, axis: str = "kv", devices=None) -> KVMesh:
    """1-D ``kv`` mesh over the first ``n_shards`` devices — the serving
    engine's data-parallel-KV surface (paged pool sharded page-aligned on
    its word axis; staged kernel batches sharded by home device).

    With no ``devices`` it takes the visible CUDA devices. An explicit list
    may repeat a device (the virtual-device mode of the module docstring).
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > len(devices):
        raise ValueError(
            f"kv mesh needs {n_shards} devices but only {len(devices)} are "
            f"visible — pass devices=[...] (a device may repeat, e.g. "
            f"devices=['cuda:0'] * {n_shards} or ['cpu'] * {n_shards}) to "
            f"run that many shards on fewer devices")
    return KVMesh(devices=tuple(devices[:n_shards]), axis_names=(axis,))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named ``DeviceMesh`` read as a JAX mesh: ``shape`` maps each axis
    name to its size, in the mesh's order."""

    device_mesh: object                # torch.distributed DeviceMesh

    @property
    def axis_names(self) -> tuple:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Mapping[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.shape))

    @property
    def size(self) -> int:
        return self.device_mesh.size()

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type


def _world_size() -> int:
    """The ranks of the running job: the process group's size, else
    ``torchrun``'s ``WORLD_SIZE``, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(shape, axes, *, devices=None) -> Mesh:
    """A mesh of ``shape`` with dims named ``axes`` over the ranks of the
    initialised process group, which must hold ``prod(shape)`` ranks.

    ``devices`` is the ranks' device type: the card (``"cuda"``) when
    None, or ``"cpu"`` for gloo ranks on the CPU. Each rank computes on
    its current device of that type, so ranks may share one card.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    need, have = math.prod(shape), _world_size()
    if need != have:
        raise ValueError(f"mesh {shape} {axes} needs {need} ranks but the "
                         f"job has {have}: start it with torchrun "
                         f"--nproc_per_node {need} (or across nodes)")
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {shape} {axes}: no process group; call "
                           f"torch.distributed.init_process_group first")
    dev = torch.device("cuda" if devices is None else devices)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mesh on the card requested but no CUDA device "
                           "is available (pass devices='cpu')")
    return Mesh(init_device_mesh(dev.type, shape, mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 (512 ranks, 2 pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


def make_debug_mesh(shape=(2, 4), axes=("data", "model"), *,
                    devices=None) -> Mesh:
    """Small mesh for multi-rank tests (8 ranks at the default shape)."""
    return make_mesh(shape, axes, devices=devices)
