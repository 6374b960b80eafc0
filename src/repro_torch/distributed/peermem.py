"""A process-group backend for ranks that share cards: each collective
meets the peers' operands in device memory that every rank maps, never in
host memory.

Each rank owns one slot buffer of ``SLOT_BYTES`` on its device, and every
peer maps it: on a card through CUDA IPC (``cudaIpcGetMemHandle`` /
``cudaIpcOpenMemHandle``, by way of ``torch.multiprocessing.reductions``,
which hands out the caching allocator's block with the slot's offset in
it), on the CPU as a shared-memory file under ``/dev/shm``, unlinked once
every peer has mapped it. The handles are exchanged once, through the
job's store, when the group is made. A process cannot open its own IPC
handle, so a rank reads its own slot directly.

A collective is: copy this rank's operand into its own slot; a fence; read
the peers' slots straight into the result; a fence. A fence is a sync of
the rank's device followed by a barrier of the group's own gloo group on
the host: no peer reads a slot before its writer's copy has finished, and
no writer overwrites a slot that a peer is still reading. Sums (and the
other reductions gloo has) are taken in rank order in the operand's dtype
(``acc = slot_0; acc += slot_1; ...``), so every rank gets the same bits;
an int8 sum wraps as gloo's does. An operand larger than the slot goes in
chunks, each a write, a fence, the reads and a fence.

One slot a rank serves every group the world makes (DTensor makes one for
each mesh dimension): a process issues one collective at a time and each
ends on a fence of every rank that read its slot, so the slot is free
again when the next collective of any group writes it. A group made with
``pg_options=Options(...)`` gets a slot set of its own.

``register()`` makes the backend known as ``"peermem"``; the collectives
and their count in ``hoststaged.STATS`` (the same key and byte rule, so a
job's tally compares with the dry run's) are those of
``hoststaged.HostStagedGroup``. :func:`choose_backend` picks the backend a
job of ranks joins.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
import pickle
import uuid

import torch
import torch.distributed as dist

from repro_torch.distributed import hoststaged
from repro_torch.distributed.hoststaged import NamedGroup, _count, _done

NAME = "peermem"
# chip_smoke.py 8b's largest collective: the 500 MiB bf16 reduce-scatter
# input (and all-gather output) of tinyllama-1.1b's logits over (data 2,
# model 2), traced on fake tensors; it fits one chunk
SLOT_BYTES = 512 * 2**20
# the collectives' count, shared with the host-staged backend
STATS = hoststaged.STATS
# bytes this rank copied into its slot, bytes it read from the ranks'
# slots (its own among them), and write-fence-read-fence rounds
MOVED: dict[str, int] = collections.Counter()
_SHM = "/dev/shm"
_WORLD = None          # the default group's slot set, shared by its subgroups


def reset_stats() -> None:
    """Clear ``STATS`` and ``MOVED``."""
    STATS.clear()
    MOVED.clear()


def choose_backend(device_type: str, local_world: int, cards: int,
                   world: int) -> str:
    """The backend of a job of ``world`` ranks, ``local_world`` of them on
    this host, which has ``cards`` cards: gloo on the CPU; NCCL when each
    rank has a card of its own; peer memory when the ranks of one host
    outnumber its cards. Ranks that share cards across several hosts
    raise: peer memory spans one host."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"no backend for ranks on {device_type!r}")
    if cards < 1:
        raise ValueError(f"{local_world} ranks on cuda, but the host has "
                         f"no card")
    if local_world <= cards:
        return "nccl"
    if world == local_world:
        return NAME
    raise ValueError(
        f"{world} ranks in hosts of {local_world} ranks with {cards} "
        f"card(s) each: ranks that share a card talk through peer memory, "
        f"which spans one host; give each rank a card of its own")


@dataclasses.dataclass(frozen=True)
class Options:
    """A slot set's device (default: the current card where there is one,
    else the CPU) and slot size."""
    device: str | None = None
    slot_bytes: int = SLOT_BYTES


def _device(name: str | None) -> torch.device:
    if name is not None:
        dev = torch.device(name)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class SlotSet:
    """This rank's slot and every peer's, mapped, by global rank."""

    def __init__(self, store, ranks: list, me: int, options: Options,
                 gloo) -> None:
        self.device, self.nbytes = _device(options.device), options.slot_bytes
        key = "peermem/slot/{}".format
        path = None
        if self.device.type == "cuda":
            from torch.multiprocessing.reductions import reduce_tensor
            own = torch.empty(self.nbytes, dtype=torch.uint8,
                              device=self.device)
            store.set(key(me), pickle.dumps(reduce_tensor(own)[1]))
        elif self.device.type == "cpu":
            path = os.path.join(_SHM, f"peermem-{uuid.uuid4().hex}-{me}")
            own = torch.from_file(path, shared=True, size=self.nbytes,
                                  dtype=torch.uint8)
            store.set(key(me), path.encode())
        else:
            raise ValueError(f"peermem: no slot on {self.device}")
        try:
            self.slots = {g: own if g == me else
                          self._map(g, me, store.get(key(g)))
                          for g in ranks}
            gloo.barrier().wait()
        finally:
            if path is not None:
                os.unlink(path)

    def _map(self, g: int, me: int, blob: bytes) -> torch.Tensor:
        try:
            if self.device.type == "cuda":
                from torch.multiprocessing.reductions import \
                    rebuild_cuda_tensor
                t = rebuild_cuda_tensor(*pickle.loads(blob))
            else:
                t = torch.from_file(blob.decode(), shared=True,
                                    size=self.nbytes, dtype=torch.uint8)
        except (RuntimeError, OSError) as e:
            raise RuntimeError(f"peermem: rank {me} cannot map rank {g}'s "
                               f"slot on {self.device}: {e}") from e
        if t.numel() != self.nbytes:
            raise RuntimeError(f"peermem: rank {me} mapped {t.numel()} bytes "
                               f"of rank {g}'s slot, not {self.nbytes}")
        return t


def _combine(op):
    """The in-place step ``acc = acc op x`` of a reduction gloo has (AVG
    sums, and :meth:`PeerMemGroup._reduce` divides by the ranks after, as
    gloo does)."""
    R = dist.ReduceOp
    for red, fn in ((R.SUM, torch.Tensor.add_), (R.AVG, torch.Tensor.add_),
                    (R.PRODUCT, torch.Tensor.mul_),
                    (R.MIN, lambda a, x: torch.minimum(a, x, out=a)),
                    (R.MAX, lambda a, x: torch.maximum(a, x, out=a)),
                    (R.BAND, torch.Tensor.bitwise_and_),
                    (R.BOR, torch.Tensor.bitwise_or_),
                    (R.BXOR, torch.Tensor.bitwise_xor_)):
        if op == red:
            return fn
    raise ValueError(f"peermem: reduction {getattr(op, 'op', op)} is not "
                     f"one gloo has")


class _Out:
    """A 1-D view of ``t`` to write (a contiguous copy when ``t`` is not
    contiguous, copied back by :meth:`done`)."""

    def __init__(self, t: torch.Tensor):
        self.t = t
        self.flat = (t.view(-1) if t.is_contiguous() else
                     torch.empty(t.numel(), dtype=t.dtype, device=t.device))

    def done(self) -> None:
        if not self.t.is_contiguous():
            self.t.copy_(self.flat.view(self.t.shape))


class PeerMemGroup(NamedGroup):
    """The collectives ``hoststaged.HostStagedGroup`` serves, through the
    ranks' mapped slots (see the module docstring)."""

    def __init__(self, store, rank: int, size: int, timeout,
                 global_ranks: list | None = None,
                 options: Options | None = None):
        global _WORLD
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)
        self._ranks = list(global_ranks) if global_ranks else list(range(size))
        if (options is None and global_ranks and _WORLD is not None
                and dist.get_backend() == NAME):
            self._set = _WORLD
        else:
            self._set = SlotSet(store, self._ranks, self._ranks[rank],
                                options or Options(), self._gloo)
            if not global_ranks:
                _WORLD = self._set

    def getBackendName(self) -> str:
        return NAME

    # -- the slots ------------------------------------------------------------
    def _elems(self, dtype) -> int:
        return self._set.nbytes // dtype.itemsize

    def _slot(self, j: int, dtype, n: int) -> torch.Tensor:
        """The first ``n`` elements of group rank ``j``'s slot as ``dtype``."""
        return self._set.slots[self._ranks[j]][:n * dtype.itemsize].view(dtype)

    def _fence(self) -> None:
        if self._set.device.type == "cuda":
            torch.cuda.synchronize(self._set.device)
        self._gloo.barrier().wait()

    def _write(self, dtype, n: int) -> torch.Tensor:
        MOVED["written"] += n * dtype.itemsize
        return self._slot(self.rank(), dtype, n)

    def _read(self, j: int, dtype, a: int, b: int) -> torch.Tensor:
        """Elements ``a:b`` of group rank ``j``'s slot as ``dtype``."""
        MOVED["read"] += (b - a) * dtype.itemsize
        return self._slot(j, dtype, b)[a:]

    def _round(self, write, read) -> None:
        """One chunk: ``write()`` into this rank's slot, a fence,
        ``read()`` from the slots, a fence."""
        write()
        self._fence()
        read()
        self._fence()
        MOVED["rounds"] += 1

    def _reduce(self, out: torch.Tensor, parts: list, seg: int, op) -> None:
        """``out`` = the reduction, in rank order, of every rank's
        ``parts[seg]`` (each rank gives ``len(parts)`` flat parts of
        ``out``'s size)."""
        step, k, n, dt = _combine(op), len(parts), self.size(), out.dtype
        o = _Out(out)
        m, c = out.numel(), self._elems(dt) // len(parts)
        if c < 1:
            raise ValueError(f"peermem: a slot of {self._set.nbytes} bytes "
                             f"holds no chunk of {k} parts of {dt}")
        for a in range(0, m, c):
            w = min(m, a + c) - a

            def write():
                mine = self._write(dt, k * w).view(k, w)
                for i, p in enumerate(parts):
                    mine[i].copy_(p[a:a + w])

            def read():
                dst = o.flat[a:a + w]
                for j in range(n):
                    src = self._read(j, dt, seg * w, (seg + 1) * w)
                    if j == 0:
                        dst.copy_(src)
                    else:
                        step(dst, src)
                if op == dist.ReduceOp.AVG:
                    dst.div_(n)

            self._round(write, read)
        o.done()

    def _gather(self, outs: list, x: torch.Tensor) -> None:
        """``outs[j]`` = rank ``j``'s ``x`` (the same size on every rank)."""
        x, dt = x.reshape(-1), x.dtype
        dsts = [_Out(t) for t in outs]
        m, c = x.numel(), self._elems(dt)
        for a in range(0, m, c):
            w = min(m, a + c) - a
            self._round(
                lambda: self._write(dt, w).copy_(x[a:a + w]),
                lambda: [o.flat[a:a + w].copy_(self._read(j, dt, 0, w))
                         for j, o in enumerate(dsts)])
        for o in dsts:
            o.done()

    def _from_root(self, out: torch.Tensor, parts: list, root: int,
                   scatter: bool) -> None:
        """``out`` = the root's ``parts[this rank]`` when ``scatter`` (the
        root holds one part per rank), else the root's ``parts[0]`` (a
        broadcast: the root's ``out`` is that part already)."""
        r, dt, k = self.rank(), out.dtype, len(parts)
        o = _Out(out)
        m = out.numel()
        c = self._elems(dt) // k
        seg = r if scatter else 0
        for a in range(0, m, c):
            w = min(m, a + c) - a

            def write():
                if r == root:
                    mine = self._write(dt, k * w).view(k, w)
                    for i, p in enumerate(parts):
                        mine[i].copy_(p[a:a + w])

            def read():
                if r != root or scatter:
                    o.flat[a:a + w].copy_(
                        self._read(root, dt, seg * w, (seg + 1) * w))

            self._round(write, read)
        o.done()

    # -- reductions ----------------------------------------------------------
    def allreduce(self, tensors, opts=None):
        opts = opts or dist.AllreduceOptions()
        _count(self, "all_reduce", *tensors)
        for t in tensors:
            self._reduce(t, [t.reshape(-1)], 0, opts.reduceOp)
        return _done(tensors)

    def reduce_scatter(self, outputs, input_lists, opts=None):
        opts = opts or dist.ReduceScatterOptions()
        _count(self, "reduce_scatter", *(x for xs in input_lists for x in xs))
        for o, xs in zip(outputs, input_lists):
            self._reduce(o, [x.reshape(-1) for x in xs], self.rank(),
                         opts.reduceOp)
        return _done(outputs)

    def _reduce_scatter_base(self, output, input, opts=None):
        opts = opts or dist.ReduceScatterOptions()
        _count(self, "reduce_scatter", input)
        self._reduce(output, list(input.reshape(-1).chunk(self.size())),
                     self.rank(), opts.reduceOp)
        return _done([output])

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    # -- gathers and exchanges -----------------------------------------------
    def allgather(self, output_lists, inputs, opts=None):
        _count(self, "all_gather", *inputs)
        for outs, x in zip(output_lists, inputs):
            self._gather(outs, x)
        return _done(output_lists)

    def _allgather_base(self, output, input, opts=None):
        _count(self, "all_gather", input)
        o = _Out(output)
        self._gather(list(o.flat.chunk(self.size())), input)
        o.done()
        return _done([output])

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i, opts)
        return _done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=None):
        """Rows of ``input`` (dim 0) to the ranks by ``input_split_sizes``
        (even when empty); the ranks' splits are exchanged on the host, so
        each rank finds its rows in every peer's slot."""
        _count(self, "all_to_all", input)
        n, r, dt = self.size(), self.rank(), input.dtype
        row = math.prod(input.shape[1:])
        splits = torch.tensor(list(input_split_sizes or []) or
                              [input.shape[0] // n] * n, dtype=torch.int64)
        every = [torch.empty_like(splits) for _ in range(n)]
        self._gloo.allgather([every], [splits]).wait()
        elems = [[int(s) * row for s in e] for e in every]   # [sender][to]
        want = list(output_split_sizes or []) or [output.shape[0] // n] * n
        if [e[r] for e in elems] != [int(s) * row for s in want]:
            raise ValueError(f"peermem all_to_all: rank {r} expects "
                             f"{want} rows, its peers send "
                             f"{[int(e[r]) for e in every]}")
        start = [sum(e[:r]) for e in elems]          # my rows in each sender
        at = [sum(e[r] for e in elems[:p]) for p in range(n)]  # in my output
        total = [sum(e) for e in elems]
        x, o = input.reshape(-1), _Out(output)
        c = self._elems(dt)
        for lo in range(0, max(total), c):
            mine = max(0, min(c, total[r] - lo))

            def read():
                for p in range(n):
                    a = max(start[p], lo)
                    b = min(start[p] + elems[p][r], lo + c, total[p])
                    if a < b:
                        o.flat[at[p] + a - start[p]:at[p] + b - start[p]] \
                            .copy_(self._read(p, dt, a - lo, b - lo))

            self._round(lambda: self._write(dt, mine).copy_(x[lo:lo + mine]),
                        read)
        o.done()
        return _done([output])

    all_to_all_single = alltoall_base

    # -- from one rank, and the barrier ---------------------------------------
    def broadcast(self, tensors, opts=None):
        opts = opts or dist.BroadcastOptions()
        _count(self, "broadcast", *tensors)
        for t in tensors:
            self._from_root(t, [t.reshape(-1)], opts.rootRank, False)
        return _done(tensors)

    def scatter(self, outputs, input_lists, opts=None):
        opts = opts or dist.ScatterOptions()
        _count(self, "scatter", *(x for xs in input_lists for x in xs))
        parts = ([x.reshape(-1) for x in input_lists[0]] if input_lists
                 else [None] * self.size())
        self._from_root(outputs[0], parts, opts.rootRank, True)
        return _done(outputs)

    def barrier(self, opts=None):
        self._gloo.barrier(opts or dist.BarrierOptions()).wait()
        return _done([])


def _create(backend_opts, options=None) -> PeerMemGroup:
    if options is not None and not isinstance(options, Options):
        raise TypeError(f"peermem: pg_options must be peermem.Options, not "
                        f"{type(options).__name__}")
    return PeerMemGroup(backend_opts.store, backend_opts.group_rank,
                        backend_opts.group_size, backend_opts.timeout,
                        list(backend_opts.global_ranks_in_group), options)


def register() -> str:
    """Register the backend (once per process); returns its name."""
    if not hasattr(dist.Backend, NAME.upper()):
        dist.Backend.register_backend(NAME, _create, extended_api=True,
                                      devices=["cpu", "cuda"])
    return NAME
