"""The serving engine's ``kv`` mesh: the devices the paged pool and the
fused KV kernels shard over.

The JAX package builds a ``jax.sharding.Mesh`` and runs one body per shard
under ``shard_map`` from a single controlling process. The port keeps that
single-controller design: a :class:`KVMesh` is just the ordered devices of
the axis, and the code that shards over it (``distributed.sharding.
shard_apply``, the sharded pool step, the fused kernel wrappers) launches
each shard's work on that shard's device from the one process and joins
the results.

A ``devices`` list may repeat a device. That is the port's virtual-device
mode, its counterpart of the JAX tests'
``--xla_force_host_platform_device_count``: ``devices=["cpu"] * 4`` runs
four shards on the CPU, and ``devices=["cuda:0"] * 4`` four shards on one
card, each with its own storage and its own kernel launches over its own
rows, so the sharded path runs where there is one device.
"""
from __future__ import annotations

import dataclasses
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
