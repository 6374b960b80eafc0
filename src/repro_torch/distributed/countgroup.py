"""A process-group backend that counts collectives and moves no data: any
world size in one process, for the dry run (``launch/dryrun.py``).

One process joins a world of, say, 256 ranks as rank 0
(:func:`world`), builds the production ``DeviceMesh`` over it, and runs
the real step on fake DTensors: DTensor plans every redistribution for
that rank as it would in a job of 256 processes. Nothing is sent: each
collective that reaches the backend is counted and completes at once,
leaving its outputs as they are (on fake tensors there is nothing to
write).

The count uses ``hoststaged``'s key and byte rule (``"all_reduce bf16
x2"``: calls and the bytes of this rank's input operands, by collective,
dtype and group size), so that a dry run's tally and a job's
``hoststaged.STATS`` compare key by key. DTensor's functional
collectives on fake tensors run their meta kernels and never reach a
backend: ``launch.op_analysis`` counts those where they are dispatched,
with the same rule; ``STATS`` here holds the collectives called on the
groups directly (``torch.distributed.all_reduce`` and kin).
"""
from __future__ import annotations

import collections
import contextlib

import torch.distributed as dist

from repro_torch.distributed.hoststaged import NamedGroup, _count, _done

NAME = "counting"
# "op dtype xN" -> [calls, bytes of this rank's input operands]
STATS: dict[str, list[int]] = collections.defaultdict(lambda: [0, 0])


def reset_stats() -> None:
    STATS.clear()


class CountingGroup(NamedGroup):
    """The collectives ``hoststaged.HostStagedGroup`` serves, each counted
    in ``STATS`` and completed with its outputs untouched."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)

    def getBackendName(self) -> str:
        return NAME

    def _counted(self, op: str, inputs, outputs):
        _count(self, op, *inputs, into=STATS)
        return _done(outputs)

    def allreduce(self, tensors, opts=None):
        return self._counted("all_reduce", tensors, tensors)

    def reduce_scatter(self, outputs, input_lists, opts=None):
        return self._counted("reduce_scatter",
                             [x for xs in input_lists for x in xs], outputs)

    def _reduce_scatter_base(self, output, input, opts=None):
        return self._counted("reduce_scatter", [input], [output])

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    def allgather(self, output_lists, inputs, opts=None):
        return self._counted("all_gather", inputs, output_lists)

    def _allgather_base(self, output, input, opts=None):
        return self._counted("all_gather", [input], [output])

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i, opts)
        return _done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=None):
        return self._counted("all_to_all", [input], [output])

    all_to_all_single = alltoall_base

    def broadcast(self, tensors, opts=None):
        return self._counted("broadcast", tensors, tensors)

    def scatter(self, outputs, input_lists, opts=None):
        return self._counted("scatter", [x for xs in input_lists for x in xs],
                             outputs)

    def barrier(self, opts=None):
        return _done([])


def _create(store, rank: int, size: int, timeout) -> CountingGroup:
    return CountingGroup(store, rank, size, timeout)


def register() -> str:
    """Register the backend (once per process); returns its name."""
    if not hasattr(dist.Backend, NAME.upper()):
        dist.Backend.register_backend(NAME, _create, devices=["cpu", "cuda"])
    return NAME


@contextlib.contextmanager
def world(size: int, rank: int = 0):
    """This process as ``rank`` of a counting world of ``size`` ranks (an
    in-memory store, nothing to connect to); the process group is
    destroyed on exit, also when the body raises."""
    register()
    dist.init_process_group(NAME, store=dist.HashStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
