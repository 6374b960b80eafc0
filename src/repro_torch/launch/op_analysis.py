"""Per-rank op analysis: the port's counterpart of the JAX package's
``launch/hlo_analysis.py``.

The JAX dry run compiles a step and parses the per-device SPMD program's
HLO text, expanding its while loops by their trip counts. The port has no
HLO and no compiled program: eager torch runs every iteration of its
Python layer loops op by op, so there is no text to parse and no loop to
expand. Instead :func:`analyze` runs the step once under a
``TorchDispatchMode`` and counts what THIS RANK executes, at the
dispatcher, with the keys and meanings of ``hlo_analysis.analyze``:

  * ``dot_flops``           2 x the multiply-adds of every ``mm``, ``bmm``,
                            ``addmm``, ``baddbmm`` (and ``mv``/``dot``),
                            which is what ``einsum`` and ``linear`` reach
                            the dispatcher as;
  * ``traffic_bytes``       the refined model: views move 0; gathering
                            reads (``index``, ``index_select``, ``gather``,
                            ``embedding``, ``take``) count their result
                            bytes; updates into a tensor (``index_put_``,
                            ``index_copy_``, ``index_add_``, the
                            ``scatter`` family) count 2x their update
                            bytes; ``copy_`` counts what it reads and
                            writes; a ``_to_copy``/``copy_`` that changes
                            dtype goes to ``convert_bytes`` instead;
                            allocations move 0 and fills write once;
                            everything else counts operands plus result;
  * ``traffic_bytes_naive`` operands plus result of every op, views
                            included (JAX's crude number);
  * ``convert_bytes``       operands plus result of the dtype casts;
  * ``collective_bytes`` / ``collective_counts``  result bytes and calls by
                            JAX's collective names (``all-gather``,
                            ``all-reduce``, ``reduce-scatter``,
                            ``all-to-all``, ``collective-permute``).

**Per rank, not per global op.** Under DTensor a mode that handled the
DTensor op itself would see the GLOBAL op (``x @ w`` at the full
[1024, 4096] x [4096, 14336]). This mode returns ``NotImplemented`` for
any op on a DTensor, so DTensor plans the op and issues the rank's local
ops, which come back through the mode at local shapes. DTensor's sharding
propagation also runs each op once at global shapes, on fake tensors, to
read the output's shape; those ops are recognised by the propagator's
frames on the Python stack and not counted.

**Collectives.** DTensor's functional collectives are counted where they
are dispatched, by JAX's names and, in ``staged``, by
``hoststaged.STATS``'s key and byte rule (``"all_gather bf16 x2"``: calls
and this rank's input bytes), so that a trace's tally compares key by key
with a job's. Collectives called on a counting group directly
(``distributed/countgroup.py``) are added from its ``STATS``.

**Memory.** The counterpart of ``compiled.memory_analysis()``, from
storage lifetimes: ``argument_bytes`` the storages of the arguments
(DTensors by their local shards); ``temp_bytes`` the peak of the storages
allocated during the call and still alive (weak references end them),
outputs included; ``output_bytes`` the storages of the result;
``alias_bytes`` those of the result that are argument storages (updated
in place); ``peak_bytes`` = arguments + temps. On fake tensors
(``FakeTensorMode``) all of it is counted without allocating anything.
"""
from __future__ import annotations

import collections
import sys
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed import countgroup
from repro_torch.distributed import sharding as S
from repro_torch.distributed.hoststaged import stat_key

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# functional collective -> (hoststaged's name for it, JAX's name)
_FUNCTIONAL = {
    "all_reduce": ("all_reduce", "all-reduce"),
    "all_reduce_": ("all_reduce", "all-reduce"),
    "all_reduce_coalesced": ("all_reduce", "all-reduce"),
    "all_reduce_coalesced_": ("all_reduce", "all-reduce"),
    "all_gather_into_tensor": ("all_gather", "all-gather"),
    "all_gather_into_tensor_out": ("all_gather", "all-gather"),
    "all_gather_into_tensor_coalesced": ("all_gather", "all-gather"),
    "reduce_scatter_tensor": ("reduce_scatter", "reduce-scatter"),
    "reduce_scatter_tensor_coalesced": ("reduce_scatter", "reduce-scatter"),
    "all_to_all_single": ("all_to_all", "all-to-all"),
    "broadcast": ("broadcast", "broadcast"),
    "broadcast_": ("broadcast", "broadcast"),
    # DTensor's own op for a shard-to-shard move on cards (on the CPU it
    # gathers instead): one all-to-all of its input
    "shard_dim_alltoall": ("all_to_all", "all-to-all"),
}
_COLLECTIVE_NS = ("_c10d_functional", "_dtensor")
_DOTS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2),
         "mv": (0, 1), "dot": (0, 1)}
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "narrow_copy"}
# update ops -> position of the update operand
_UPDATES = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
            "index_copy": 3, "index_copy_": 3, "index_add": 3,
            "index_add_": 3, "scatter": 3, "scatter_": 3, "scatter_add": 3,
            "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3}
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided"}
_FILLS = {"fill_", "zero_"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    return S.local(t).untyped_storage()


def _issued_by_torch_distributed(depth: int = 16) -> bool:
    """Whether the op being handled was issued by torch.distributed's own
    Python code (DTensor's planning: the index arithmetic of a strided
    shard, the propagator's metadata run), past torch's private plumbing
    frames, rather than by the function analysed."""
    f = sys._getframe(1).f_back
    for _ in range(depth):
        if f is None:
            return False
        mod = f.f_globals.get("__name__", "")
        if not mod.startswith(("torch._", "torch.utils._")):
            return mod.startswith("torch.distributed")
        f = f.f_back
    return False


def _group_size(op: str, args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    if op in ("all_gather_into_tensor", "all_gather_into_tensor_out",
              "all_gather_into_tensor_coalesced"):
        return int(args[1])
    if op in ("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced"):
        return int(args[2])
    group = args[-1]
    return (_resolve_process_group(group) if isinstance(group, str)
            else group).size()


def _dot_flops(name: str, args) -> float:
    a, b = (args[i] for i in _DOTS[name])
    # [.., M, K] x [.., K, N]; mv and dot have no N
    return 2.0 * a.numel() * (b.shape[-1] if b.ndim > 1 else 1)


class _Counter(TorchDispatchMode):
    def __init__(self, args, fake_mode) -> None:
        super().__init__()
        self.fake_mode = fake_mode
        self.dot_flops = 0.0
        self.traffic = 0.0
        self.naive = 0.0
        self.convert = 0.0
        self.coll_bytes = {k: 0.0 for k in COLLECTIVES}
        self.coll_counts = {k: 0.0 for k in COLLECTIVES}
        self.staged: dict = collections.defaultdict(lambda: [0, 0])
        self.args = {}
        for t in _tensors(args):
            st = _storage(t)
            self.args[st._cdata] = st.nbytes()
        self.live: dict[int, int] = {}
        self.cur = self.peak = 0

    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def _track(self, func, outs) -> None:
        """Start the lifetime of each output storage this op allocated."""
        returns = func._schema.returns
        for i, t in enumerate(outs):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live or key in self.args:
                continue
            r = returns[min(i, len(returns) - 1)]   # one return: a list
            if r.alias_info is not None:
                continue                     # a view of an older storage
            n = st.nbytes()
            self.live[key] = n
            self.cur += n
            self.peak = max(self.peak, self.cur)
            weakref.finalize(st, self._free, key)

    def _collective(self, name: str, args, ins, outs) -> None:
        staged, jax_name = _FUNCTIONAL[name]
        n = _group_size(name, args)
        for t in ins:
            s = self.staged[stat_key(staged, t.dtype, n)]
            s[0] += 1
            s[1] += _nbytes(t)
        if jax_name not in self.coll_bytes:
            self.coll_bytes[jax_name] = self.coll_counts[jax_name] = 0.0
        self.coll_bytes[jax_name] += sum(_nbytes(t) for t in outs)
        self.coll_counts[jax_name] += 1

    def _own(self, tensors) -> bool:
        """Whether the op is the analysed rank's: on fake tensors, one of
        its tensors is of the analysis's fake mode (DTensor's metadata runs
        use another); on real tensors, none is fake."""
        if self.fake_mode is None:
            return not any(isinstance(t, FakeTensor) for t in tensors)
        return any(isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode
                   for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor issues the local ops
        kwargs = kwargs or {}
        if (self.fake_mode is not None
                and not any(issubclass(t, FakeTensor) for t in types)
                and not _issued_by_torch_distributed()):
            with self.fake_mode:             # a new tensor of the function's
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        ns = func.namespace
        if ns == "prim" or not self._own(ins + outs):
            return out
        name = func.overloadpacket.__name__
        self._track(func, outs)
        if ns in _COLLECTIVE_NS:
            if name in _FUNCTIONAL:
                self._collective(name, args, ins, outs)
            else:                            # wait_tensor: no traffic
                return out
        if name in _DOTS:
            self.dot_flops += _dot_flops(name, args)
        in_b, out_b = sum(map(_nbytes, ins)), sum(map(_nbytes, outs))
        self.naive += in_b + out_b
        returns = func._schema.returns
        if returns and all(r.alias_info is not None
                           and not r.alias_info.is_write for r in returns):
            return out                       # a view: metadata only
        if name in ("_to_copy", "copy_") and ins[-1].dtype != outs[0].dtype:
            self.convert += in_b + out_b
        elif name in _ALLOCS:
            pass
        elif name in _FILLS:
            self.traffic += out_b
        elif name == "copy_":
            self.traffic += 2 * _nbytes(ins[1])
        elif name in _GATHERS:
            self.traffic += out_b
        elif name in _UPDATES:
            i = _UPDATES[name]
            upd = args[i] if len(args) > i else None
            self.traffic += 2 * (_nbytes(upd) if isinstance(upd, torch.Tensor)
                                 else args[2].numel() * ins[0].element_size())
        else:
            self.traffic += in_b + out_b
        return out


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and count what this rank executes
    (module docstring). Returns (fn's result, the analysis dict: the keys
    of ``hlo_analysis.analyze`` plus ``staged``, ``argument_bytes``,
    ``output_bytes``, ``temp_bytes``, ``alias_bytes``, ``peak_bytes``).

    Arguments may be fake tensors (or DTensors of them): call it OUTSIDE
    their ``FakeTensorMode`` then. Every tensor the function makes is made
    in that mode, while DTensor's own planning, which computes indices
    with small real tensors, runs outside it."""
    before = {k: list(v) for k, v in countgroup.STATS.items()}
    fakes = {t.fake_mode for t in map(S.local, _tensors((args, kwargs)))
             if isinstance(t, FakeTensor)}
    if len(fakes) > 1:
        raise ValueError("analyze: arguments from several FakeTensorModes")
    counter = _Counter((args, kwargs), fakes.pop() if fakes else None)
    with counter:
        out = fn(*args, **kwargs)
    staged = {k: list(v) for k, v in counter.staged.items()}
    for k, (n, b) in countgroup.STATS.items():
        n0, b0 = before.get(k, (0, 0))
        if n > n0:
            s = staged.setdefault(k, [0, 0])
            s[0] += n - n0
            s[1] += b - b0
    outputs = {}
    for t in _tensors(out):
        st = _storage(t)
        outputs[st._cdata] = st.nbytes()
    return out, {
        "dot_flops": counter.dot_flops,
        "traffic_bytes": counter.traffic,
        "traffic_bytes_naive": counter.naive,
        "convert_bytes": counter.convert,
        "collective_bytes": counter.coll_bytes,
        "collective_counts": counter.coll_counts,
        "staged": dict(sorted(staged.items())),
        "argument_bytes": sum(counter.args.values()),
        "output_bytes": sum(outputs.values()),
        "temp_bytes": counter.peak,
        "alias_bytes": sum(n for k, n in outputs.items()
                           if k in counter.args),
        "peak_bytes": sum(counter.args.values()) + counter.peak,
    }
