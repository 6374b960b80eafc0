"""A process-group backend that runs every collective through gloo on the
host, synchronously, and counts it: CUDA operands are staged through
pinned host memory, CPU operands go to gloo as they are.

No job on cards chooses it (``peermem.choose_backend`` gives them NCCL, or
the peer-memory group of ``distributed/peermem.py`` where ranks share a
card); CPU jobs name it to count their collectives. It was built for ranks
that share a card: gloo's own CUDA path runs the plain
``torch.distributed`` collectives, but the functional collectives that
DTensor issues crash it (4 ranks on one NVIDIA H100 80GB HBM3 in torch
2.11 segfault within a few ``_functional_collectives`` calls), and NCCL
refuses two ranks on one device. A process group written in Python, as
this one and ``peermem``'s are, serves both APIs.

``probe()`` checks every collective DTensor issues, through the plain and
the functional API, on the job's ranks (run it with
``launch.local_ranks``). ``register()`` makes the backend known as
``"hoststaged"``
(``init_process_group(backend="hoststaged", ...)``, every device type);
``STATS`` counts each collective's calls and the bytes of this rank's
input operands, by collective, dtype and group size (``"all_reduce int8
x2"``: an int8 all-reduce over a group of 2 ranks).
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import _create_work_from_future
from torch.futures import Future

NAME = "hoststaged"
# "op dtype xN" -> [calls, bytes of this rank's input operands]
STATS: dict[str, list[int]] = collections.defaultdict(lambda: [0, 0])


def reset_stats() -> None:
    STATS.clear()


def stat_key(op: str, dtype, group_size: int) -> str:
    """``STATS``'s key of a collective: ``"all_reduce int8 x2"``."""
    name = str(dtype).removeprefix("torch.") if dtype is not None else "-"
    return f"{op} {name} x{group_size}"


def _count(group, op: str, *tensors: torch.Tensor, into=None) -> None:
    """One call of ``op`` by ``group`` on ``tensors`` (this rank's input
    operands) counted in ``into`` (default ``STATS``)."""
    s = (STATS if into is None else into)[
        stat_key(op, tensors[0].dtype if tensors else None, group.size())]
    s[0] += 1
    s[1] += sum(t.numel() * t.element_size() for t in tensors)


def _host(t: torch.Tensor, copy: bool = True) -> torch.Tensor:
    """``t`` itself on the CPU, else a pinned host tensor of its shape (a
    copy of it when ``copy``)."""
    if t.device.type == "cpu":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if copy:
        h.copy_(t)
    return h


def _back(pairs) -> None:
    for t, h in pairs:
        if t is not h:
            t.copy_(h)


def _done(result):
    fut = Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


class NamedGroup(dist.ProcessGroup):
    """A process group written in Python: the name and description that
    c10d sets after creation, under both spellings torch's Python hook has
    used, so that a subclass serves several torch releases (2.11 on the
    card, 2.13 in the CPU tests)."""

    def __init__(self, rank: int, size: int):
        super().__init__(rank, size)
        self._group_name = self._group_desc = ""

    def setGroupName(self, name: str) -> None:
        self._group_name = name

    def getGroupName(self) -> str:
        return self._group_name

    def setGroupDesc(self, desc: str) -> None:
        self._group_desc = desc

    def getGroupDesc(self) -> str:
        return self._group_desc

    _set_group_name, _set_group_desc = setGroupName, setGroupDesc
    group_name = property(getGroupName)
    group_desc = property(getGroupDesc)


class HostStagedGroup(NamedGroup):
    """gloo on the host for the tensors of any device (see the module
    docstring): the collectives that DTensor and ``distribute_tensor``
    issue, each under both spellings torch's Python process-group hook
    has used."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

    def getBackendName(self) -> str:
        return NAME

    # -- reductions ----------------------------------------------------------
    def allreduce(self, tensors, opts=None):
        opts = opts or dist.AllreduceOptions()
        _count(self, "all_reduce", *tensors)
        hs = [_host(t) for t in tensors]
        self._gloo.allreduce(hs, opts).wait()
        _back(zip(tensors, hs))
        return _done(tensors)

    def reduce_scatter(self, outputs, input_lists, opts=None):
        opts = opts or dist.ReduceScatterOptions()
        _count(self, "reduce_scatter", *(x for xs in input_lists for x in xs))
        hout = [_host(t, copy=False) for t in outputs]
        hin = [[_host(x) for x in xs] for xs in input_lists]
        self._gloo.reduce_scatter(hout, hin, opts).wait()
        _back(zip(outputs, hout))
        return _done(outputs)

    def _reduce_scatter_base(self, output, input, opts=None):
        opts = opts or dist.ReduceScatterOptions()
        _count(self, "reduce_scatter", input)
        hout, hin = _host(output, copy=False), _host(input)
        self._gloo._reduce_scatter_base(hout, hin, opts).wait()
        _back([(output, hout)])
        return _done([output])

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    # -- gathers and exchanges -----------------------------------------------
    def allgather(self, output_lists, inputs, opts=None):
        opts = opts or dist.AllgatherOptions()
        _count(self, "all_gather", *inputs)
        hout = [[_host(x, copy=False) for x in xs] for xs in output_lists]
        self._gloo.allgather(hout, [_host(t) for t in inputs], opts).wait()
        _back((x, h) for xs, hs in zip(output_lists, hout)
              for x, h in zip(xs, hs))
        return _done(output_lists)

    def _allgather_base(self, output, input, opts=None):
        opts = opts or dist.AllgatherOptions()
        _count(self, "all_gather", input)
        hout = _host(output, copy=False)
        self._gloo._allgather_base(hout, _host(input), opts).wait()
        _back([(output, hout)])
        return _done([output])

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i, opts)
        return _done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=None):
        opts = opts or dist.AllToAllOptions()
        _count(self, "all_to_all", input)
        hout = _host(output, copy=False)
        self._gloo.alltoall_base(hout, _host(input),
                                 list(output_split_sizes or []),
                                 list(input_split_sizes or []), opts).wait()
        _back([(output, hout)])
        return _done([output])

    all_to_all_single = alltoall_base

    # -- from one rank, and the barrier ---------------------------------------
    def broadcast(self, tensors, opts=None):
        opts = opts or dist.BroadcastOptions()
        _count(self, "broadcast", *tensors)
        hs = [_host(t) for t in tensors]
        self._gloo.broadcast(hs, opts).wait()
        _back(zip(tensors, hs))
        return _done(tensors)

    def scatter(self, outputs, input_lists, opts=None):
        opts = opts or dist.ScatterOptions()
        _count(self, "scatter", *(x for xs in input_lists for x in xs))
        hout = [_host(t, copy=False) for t in outputs]
        self._gloo.scatter(hout, [[_host(x) for x in xs]
                                  for xs in input_lists], opts).wait()
        _back(zip(outputs, hout))
        return _done(outputs)

    def barrier(self, opts=None):
        self._gloo.barrier(opts or dist.BarrierOptions()).wait()
        return _done([])


def _create(store, rank: int, size: int, timeout) -> HostStagedGroup:
    return HostStagedGroup(store, rank, size, timeout)


def register() -> str:
    """Register the backend (once per process); returns its name."""
    if not hasattr(dist.Backend, NAME.upper()):
        dist.Backend.register_backend(NAME, _create,
                                      devices=["cpu", "cuda"])
    return NAME


def probe(device: str = "cuda") -> dict:
    """On each rank of a job: every collective DTensor issues, through the
    plain and the functional API, on ``device`` tensors over the job's
    ranks, against the same reduction computed locally from every rank's
    input (each rank can make them all). Returns {collective: equal}."""
    import torch.distributed._functional_collectives as fc

    r, n = dist.get_rank(), dist.get_world_size()
    dev, world = torch.device(device), dist.group.WORLD

    def mine(rank, dtype=torch.float32):
        # 8 values for each rank, small enough that an int8 sum is exact
        return ((torch.arange(8 * n, device=dev) % 13) + 3 * rank).to(dtype)

    ok = {}
    for dt in (torch.float32, torch.int8):
        total = sum(mine(i, dt) for i in range(n)).to(dt)
        name = str(dt).removeprefix("torch.")
        x = mine(r, dt)
        dist.all_reduce(x)
        ok[f"all_reduce {name}"] = torch.equal(x, total)
        ok[f"functional all_reduce {name}"] = torch.equal(
            fc.all_reduce(mine(r, dt), "sum", world), total)
    every = [mine(i) for i in range(n)]
    total, mine_r = sum(every), slice(8 * r, 8 * r + 8)
    out = torch.empty(8 * n * n, device=dev)
    dist.all_gather_into_tensor(out, mine(r))
    ok["all_gather_into_tensor"] = torch.equal(out, torch.cat(every))
    ok["functional all_gather"] = torch.equal(
        fc.all_gather_tensor(mine(r), 0, world), torch.cat(every))
    out = torch.empty(8, device=dev)
    dist.reduce_scatter_tensor(out, mine(r))
    ok["reduce_scatter_tensor"] = torch.equal(out, total[mine_r])
    ok["functional reduce_scatter"] = torch.equal(
        fc.reduce_scatter_tensor(mine(r), "sum", 0, world), total[mine_r])
    a2a = torch.cat([e[mine_r] for e in every])
    out = torch.empty(8 * n, device=dev)
    dist.all_to_all_single(out, mine(r))
    ok["all_to_all_single"] = torch.equal(out, a2a)
    ok["functional all_to_all"] = torch.equal(
        fc.all_to_all_single(mine(r), None, None, world), a2a)
    return ok
