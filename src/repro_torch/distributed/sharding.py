"""Sharding rules and the paged KV pool's shard geometry.

``param_pspecs`` and its kin are the JAX package's PartitionSpec rules
(FSDP x TP x EP over a ``("pod",) "data", "model"`` mesh): parameters
shard 2-D (Megatron TP on ``model``, FSDP on ``data``), the stack axis of
a layer scan never shards, and every rule is divisibility-guarded (a dim
that does not divide by its axes replicates). A spec is a
:class:`PartitionSpec` (one entry per tensor dim: ``None``, an axis name
or a tuple of names, major to minor) and compares equal to the tuple of
the JAX spec. The rules take any mesh with ``.shape`` (a name -> size
mapping) and ``.axis_names``, and any leaf with ``.shape`` (meta tensors
included); :func:`placements` turns a spec into DTensor placements on a
``launch.mesh.make_mesh`` mesh, and :func:`place` distributes a tensor so.

The pool's word axis IS its sequence/page axis (word ``w`` belongs to page
``w // page_tokens``). ``kv_shard_plan`` is the validated geometry (shards,
pages/words per shard) the pool's device-aware allocator consumes; a page
never straddles two shards. ``kv_pool_spec`` validates a pool's geometry
against a ``kv`` mesh (``launch.mesh.make_kv_mesh``), and ``shard_apply``
is the port's ``shard_map``: one process splits the leading axis into the
mesh's contiguous blocks and runs each block on its shard's device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Any, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig

PyTree = Any


@dataclasses.dataclass(frozen=True)
class KVShardPlan:
    """Validated page-aligned sharding geometry for the paged KV pool.

    The pool's word axis is its sequence/page axis: word ``w`` belongs to
    page ``w // page_tokens`` and shard ``w // words_per_shard``. The plan
    guarantees every shard boundary is a page boundary, so a page (and
    therefore every word of a token's KV) lives on exactly one device and
    the host-side page tables stay replicated control plane.
    """
    n_shards: int
    n_pages: int
    page_tokens: int

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.n_pages % self.n_shards:
            raise ValueError(
                f"kv sharding is page-aligned: {self.n_pages} pages do not "
                f"divide across {self.n_shards} shards — round the pool up "
                f"to a whole number of pages per shard")

    @property
    def pages_per_shard(self) -> int:
        return self.n_pages // self.n_shards

    @property
    def words_per_shard(self) -> int:
        return self.pages_per_shard * self.page_tokens

    @property
    def num_words(self) -> int:
        return self.n_pages * self.page_tokens

    def shard_of_page(self, page: int) -> int:
        return page // self.pages_per_shard

    def shard_of_word(self, word: int) -> int:
        return word // self.words_per_shard


def kv_shard_plan(n_shards: int, *, n_pages: int,
                  page_tokens: int) -> KVShardPlan:
    """Page-aligned shard plan, rounding the pool UP to a whole number of
    pages per shard (extra capacity is harmless; a straddling page is not)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    pages = -(-n_pages // n_shards) * n_shards
    return KVShardPlan(n_shards=n_shards, n_pages=pages,
                       page_tokens=page_tokens)


def shard_of_pages(plan: KVShardPlan, pages) -> int:
    """The ONE shard a page set lives on, raising when it spans several.

    Refcounted prefix sharing leans on this: shared pages pin to the shard
    where they were first written, a prefix chain therefore never crosses
    shards (each extension is carved from the attacher's home — the chain's
    shard — by construction), and an attaching sequence validates its
    adopted pages here before its home follows them. A multi-shard set is a
    bookkeeping corruption, not a capacity condition, hence ValueError
    rather than PoolCapacityError."""
    pages = list(pages)
    if not pages:
        raise ValueError("empty page set has no shard")
    shards = {plan.shard_of_page(int(p)) for p in pages}
    if len(shards) != 1:
        raise ValueError(
            f"page set {sorted(int(p) for p in pages)} spans shards "
            f"{sorted(shards)} — shared prefix pages must stay device-local")
    return shards.pop()


def kv_pool_spec(mesh, *, num_words: int, page_tokens: int,
                 axis: str = "kv") -> KVShardPlan:
    """The shard geometry of the paged pool storage ``[num_words,
    word_width]`` over ``axis``: its word (= sequence/page) axis shards
    across the axis with page-aligned boundaries. Raises when the mesh has
    no such axis, when the words do not divide, or when a shard boundary
    would straddle a page (the JAX package's checks; it returns the
    ``PartitionSpec`` ``P(axis, None)`` where the port returns the plan)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {axis!r} axis")
    n = int(mesh.shape[axis])
    if num_words % n:
        raise ValueError(
            f"pool of {num_words} words does not divide across the "
            f"{n}-way {axis!r} axis")
    if (num_words // n) % page_tokens:
        raise ValueError(
            f"shard boundary straddles a page: {num_words // n} words per "
            f"shard is not a multiple of page_tokens={page_tokens}")
    return KVShardPlan(n_shards=n, n_pages=num_words // page_tokens,
                       page_tokens=page_tokens)


def on_device(dev: torch.device):
    """Context that makes ``dev`` the current CUDA device (a no-op for the
    CPU). The kernels launch on the current stream of their tensors'
    device, and the runtime takes a launch only onto a stream of the
    current device, so each shard's work runs inside this."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def shard_apply(mesh, fn, *args: torch.Tensor, axis: str = "kv"):
    """Run ``fn`` once per shard of ``axis`` on that shard's block of every
    argument's leading axis, and join the results in block order.

    Shard ``s`` gets rows ``[s*r, (s+1)*r)`` of each argument (``r`` = rows
    / shards), moved to ``mesh.devices[s]`` (no copy where the argument
    already lies there). A result that is one of the shard's argument
    blocks (an operand ``fn`` updated in place, such as a fused kernel's
    caches) joins as that argument, updated wherever its block was a copy;
    every other result is concatenated onto the first argument's device.
    ``fn`` runs with its shard's device current. ``fn`` may return a tensor or a tuple of tensors."""
    n = int(mesh.shape[axis])
    rows = args[0].shape[0]
    if rows % n:
        raise ValueError(f"shard_apply: {rows} rows do not divide across "
                         f"the {n}-way {axis!r} axis")
    r = rows // n
    home = args[0].device
    blocks, outs = [], []
    for s, dev in enumerate(mesh.devices):
        blocks.append([a[s * r:(s + 1) * r].to(dev) for a in args])
        with on_device(dev):
            outs.append(fn(*blocks[s]))
    single = not isinstance(outs[0], tuple)
    if single:
        outs = [(o,) for o in outs]
    joined = []
    for i in range(len(outs[0])):
        pieces = [o[i] for o in outs]
        src = next((j for j, b in enumerate(blocks[0]) if pieces[0] is b),
                   None)
        if src is not None and all(p is blocks[s][src]
                                   for s, p in enumerate(pieces)):
            for s, p in enumerate(pieces):
                view = args[src][s * r:(s + 1) * r]
                if (p.device, p.data_ptr()) != (view.device,
                                                view.data_ptr()):
                    view.copy_(p)
            joined.append(args[src])
        else:
            joined.append(torch.cat([p.to(home) for p in pieces]))
    return joined[0] if single else tuple(joined)


# ---------------------------------------------------------------------------
# specs and rules
# ---------------------------------------------------------------------------

class PartitionSpec:
    """JAX's ``PartitionSpec``: one entry per tensor dim, ``None``
    (replicated), an axis name, or a tuple of names sharding that dim
    major to minor. As JAX's does, it keeps an axis group of one name as
    the name and an empty group as ``None``. Equal to any tuple (a JAX
    spec included) with the same entries. Not a tuple itself, so that
    ``repro_torch.tree`` takes a spec as a leaf of a spec tree."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return (None if not e else e[0] if len(e) == 1
                        else tuple(e))
            return e
        self.entries = tuple(norm(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, (PartitionSpec, tuple)):
            return self.entries == tuple(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Rules:
    """Axis assignment for one run."""
    tp: str = "model"                       # tensor/expert-parallel axis
    fsdp: tuple[str, ...] = ("data",)       # parameter/optimizer sharding axes
    dp: tuple[str, ...] = ("data",)         # batch axes (pod too if present)

    @staticmethod
    def for_mesh(mesh, *, fsdp_over_pod: bool = False) -> "Rules":
        if "pod" in mesh.axis_names:
            return Rules(tp="model",
                         fsdp=("pod", "data") if fsdp_over_pod else ("data",),
                         dp=("pod", "data"))
        return Rules()


def _axsize(mesh, axes) -> int:
    n = 1
    for a in _flat_axes(axes):
        n *= mesh.shape[a]
    return n


def _fit(mesh, axes, dim: int):
    """axes if dim divides by their product, else None (replicate)."""
    if axes is None:
        return None
    size = _axsize(mesh, axes)
    if size > 1 and dim % size == 0:
        return axes if isinstance(axes, str) else tuple(axes)
    # try shrinking a tuple of axes from the left (drop 'pod' first)
    if not isinstance(axes, str) and len(axes) > 1:
        return _fit(mesh, axes[1:], dim)
    return None


_COL = re.compile(r"(attn/(wq|wk|wv)|ffn/(w_gate|w_up)|shared/(w_gate|w_up)|"
                  r"tm/(wv|wg)|cm/wk|in_z|in_x)/w$")
_ROW = re.compile(r"(attn/wo|ffn/w_down|shared/w_down|tm/wo|cm/wv|"
                  r"out_proj)/w$")
_REP_OUT = re.compile(r"(tm/(wr|wk)|cm/wr|in_B|in_C|in_dt)/w$")
_MOE_COL = re.compile(r"moe/(w_gate|w_up)$")
_MOE_ROW = re.compile(r"moe/w_down$")
_ATTN_PROJ = re.compile(r"attn/(wq|wk|wv)/(w|b)$")


def _n_stack(path: str) -> int:
    if path.startswith("groups/"):
        return 2
    if path.startswith(("layers/", "tail/")):
        return 1
    return 0


def _base_spec(path: str, shape, mesh, r: Rules) -> tuple:
    nd = len(shape)
    if path == "embed/w":                       # [V, d]: d-sharded lookup
        return (_fit(mesh, r.fsdp, shape[0]), _fit(mesh, r.tp, shape[1]))
    if path == "lm_head/w":                     # [d, V]: column-parallel
        return (_fit(mesh, r.fsdp, shape[0]), _fit(mesh, r.tp, shape[1]))
    if _MOE_COL.search(path):                   # [E, d, f]
        return (_fit(mesh, r.tp, shape[0]), _fit(mesh, r.fsdp, shape[1]), None)
    if _MOE_ROW.search(path):                   # [E, f, d]
        return (_fit(mesh, r.tp, shape[0]), None, _fit(mesh, r.fsdp, shape[2]))
    if path.endswith("router/w"):               # [d, E]
        return (_fit(mesh, r.fsdp, shape[0]), None)
    if _COL.search(path):                       # [d, out]: column-parallel
        return (_fit(mesh, r.fsdp, shape[0]), _fit(mesh, r.tp, shape[1]))
    if _ROW.search(path):                       # [in, d]: row-parallel
        return (_fit(mesh, r.tp, shape[0]), _fit(mesh, r.fsdp, shape[1]))
    if _REP_OUT.search(path):                   # [d, small]: fsdp rows only
        return (_fit(mesh, r.fsdp, shape[0]), None)
    if path.endswith("/b"):                     # column biases [out]
        return (_fit(mesh, r.tp, shape[0]),)
    if path.endswith("w_lora_a"):
        return (_fit(mesh, r.fsdp, shape[0]), None)
    if path.endswith("w_lora_b"):
        return (None, _fit(mesh, r.fsdp, shape[1]))
    if path.endswith("conv_x/w"):               # [K, d_in]
        return (None, _fit(mesh, r.tp, shape[1]))
    if path.endswith(("dt_bias", "a_log", "d_skip")):
        return (_fit(mesh, r.tp, shape[0]),)
    if path.endswith("mamba/norm/scale"):       # mamba inner norm [d_in]
        return (_fit(mesh, r.tp, shape[0]),)
    return (None,) * nd                         # replicate smalls


def _head_aligned(sub: str, spec: tuple, mesh, r: Rules,
                  cfg: Optional[ArchConfig]) -> tuple:
    """Drop tp from attention K/V projections that would split a head.

    Megatron-style TP must shard q/k/v on the HEAD boundary: a tp axis
    that does not divide the head count would slice inside one head's
    ``head_dim`` columns, which breaks RoPE's half-dim pairing. The
    GQA-standard fallback (K/V columns replicate while Q still shards)
    applies when ``n_heads`` divides the tp axis but ``n_kv_heads`` does
    not (tp > n_kv_heads with grouped queries), as ``kv_cache_spec``
    guards the cached heads. When even the QUERY heads cannot shard
    (``n_heads % tp != 0``) the mesh/head mismatch is an error: every
    q/k/v column would silently replicate.
    """
    if cfg is None:
        return spec
    m = _ATTN_PROJ.search(sub)
    if not m:
        return spec
    tp_size = max(_axsize(mesh, r.tp), 1)
    if cfg.n_heads % tp_size != 0:
        raise ValueError(
            f"attention TP mesh/head mismatch for {sub!r}: tp axes "
            f"{tuple(_flat_axes(r.tp))} (size {tp_size}) do not divide "
            f"n_heads={cfg.n_heads} (n_kv_heads={cfg.n_kv_heads}) — every "
            f"q/k/v column would silently replicate, disabling attention "
            f"tensor parallelism. Shrink the tp axis to a divisor of "
            f"n_heads, or wait for the head-group resharding rule "
            f"(ROADMAP: attention TP for tp > head count).")
    heads = cfg.n_heads if m.group(1) == "wq" else cfg.n_kv_heads
    if heads % tp_size == 0:
        return spec
    tp_axes = set(_flat_axes(r.tp))

    def strip(axes):
        if axes is None:
            return None
        kept = tuple(a for a in _flat_axes(axes) if a not in tp_axes)
        return kept[0] if len(kept) == 1 else (kept or None)

    # only the output-column dim (last) carries tp for these projections
    return tuple(spec[:-1]) + (strip(spec[-1]),)


def path_str(path: tuple) -> str:
    """A leaf path of ``repro_torch.tree`` as the JAX package spells it
    (``"layers/attn/wq/w"``)."""
    return "/".join(str(k) for k in path)


def param_pspecs(params: PyTree, mesh, rules: Optional[Rules] = None,
                 cfg: Optional[ArchConfig] = None) -> PyTree:
    """PartitionSpec tree mirroring ``params`` (any leaves with a
    ``.shape``: meta tensors cost nothing). ``cfg``, when provided, enables
    head-aligned attention TP (see :func:`_head_aligned`); without it the
    raw divisibility guards apply."""
    r = rules or Rules.for_mesh(mesh)

    def assign(path, leaf):
        path = path_str(path)
        n = _n_stack(path)
        sub = "/".join(path.split("/")[n:]) if n else path
        base = _base_spec(sub, tuple(leaf.shape[n:]), mesh, r)
        base = _head_aligned(sub, tuple(base), mesh, r, cfg)
        return P(*((None,) * n + tuple(base)))

    return T.unflatten(params, [assign(p, x) for p, x in
                                T.leaves_with_path(params)])


def batch_axes(mesh, rules: Rules, global_batch: int):
    """Largest subset of dp axes whose product divides global_batch."""
    return _fit(mesh, rules.dp, global_batch)


def batch_specs(cfg: ArchConfig, mesh, rules: Rules, *, global_batch: int,
                with_positions: bool = True) -> dict:
    """Input specs for a train/prefill batch dict."""
    ba = batch_axes(mesh, rules, global_batch)
    specs = {"labels": P(ba, None)}
    if cfg.input_mode == "tokens":
        specs["inputs"] = P(ba, None)
    else:
        specs["inputs"] = P(ba, None, None)
    if cfg.pos_embed == "mrope" and with_positions:
        specs["positions"] = P(ba, None, None)
    return specs


def _flat_axes(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def kv_cache_spec(cfg: ArchConfig, mesh, rules: Rules, *, batch: int,
                  n_stack: int = 1) -> PartitionSpec:
    """Spec for a stacked KV cache [stack.., B, S, Hkv, hd].

    Heads shard on tp when divisible; otherwise the sequence dim takes tp.
    Batch takes dp when divisible; otherwise sequence also absorbs dp.
    """
    ba = batch_axes(mesh, rules, batch)
    tp_on_heads = _fit(mesh, rules.tp, cfg.n_kv_heads)
    seq_axes: list[str] = []
    if ba is None:
        seq_axes.extend(_flat_axes(rules.dp))
    if tp_on_heads is None:
        seq_axes.extend(a for a in _flat_axes(rules.tp)
                        if a not in seq_axes)
    else:
        seq_axes.extend(a for a in _flat_axes(rules.tp)
                        if a not in _flat_axes(tp_on_heads)
                        and a not in seq_axes)
    seq = tuple(seq_axes) if seq_axes else None
    return P(*(None,) * n_stack, ba, seq, tp_on_heads, None)


def decode_state_pspecs(cfg: ArchConfig, mesh, rules: Optional[Rules],
                        state: PyTree, *, batch: int) -> PyTree:
    """Spec tree for a decode state (matches ``init_decode_state``)."""
    r = rules or Rules.for_mesh(mesh)
    ba = batch_axes(mesh, r, batch)

    def assign(path, leaf):
        path = path_str(path)
        nd = len(leaf.shape)
        if path == "len":
            return P(ba)
        if path in ("cache_k", "cache_v", "attn_k", "attn_v"):
            return kv_cache_spec(cfg, mesh, r, batch=batch, n_stack=1)
        if path.startswith(("tm_shift", "cm_shift")):    # [L, B, d]
            return P(None, ba, _fit(mesh, r.tp, leaf.shape[-1]))
        if path.startswith("tm_state"):                  # [L, B, H, K, V]
            return P(None, ba, _fit(mesh, r.tp, leaf.shape[2]), None, None)
        if path.startswith(("conv/", "tail_conv/")):     # [..., B, K-1, C]
            return P(*(None,) * (nd - 3), ba, None,
                     _fit(mesh, r.tp, leaf.shape[-1]))
        if path in ("ssm", "tail_ssm"):                  # [..., B, H, N, Phd]
            lead = nd - 4
            return P(*(None,) * lead, ba,
                     _fit(mesh, r.tp, leaf.shape[lead + 1]), None, None)
        return P(*(None,) * nd)

    return T.unflatten(state, [assign(p, x) for p, x in
                               T.leaves_with_path(state)])


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------

def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim ``d`` names the mesh axis, else
    ``Replicate()``. A dim over several axes becomes one ``Shard`` of that
    dim on each; DTensor splits them in mesh-dim order, so the axes must
    be named in the mesh's order (JAX's major-to-minor)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        idx = [names.index(a) for a in _flat_axes(axes)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} names axes {axes} out of the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(x) -> PartitionSpec:
    """The spec a DTensor is placed by (the inverse of :func:`placements`);
    every dim ``None`` for a plain tensor. A ``Partial`` placement has no
    spec and raises."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return P(*(None,) * x.ndim)
    names = x.device_mesh.mesh_dim_names
    dims: list[list[str]] = [[] for _ in range(x.ndim)]
    for name, pl in zip(names, x.placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"{pl} has no PartitionSpec")
    return P(*(None if not a else a[0] if len(a) == 1 else tuple(a)
               for a in dims))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named(mesh, spec_tree: PyTree) -> PyTree:
    """A :class:`NamedSharding` on ``mesh`` for every spec of
    ``spec_tree``."""
    return T.tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def place(x: torch.Tensor, mesh, spec, *, from_rank: Optional[int] = 0
          ) -> torch.Tensor:
    """``x`` (the whole tensor) distributed over ``mesh`` as ``spec`` says,
    on the mesh's device type: from rank ``from_rank``'s copy, so that
    every rank ends up holding that rank's values whatever it passed, or,
    with ``from_rank=None``, each rank keeping its own block of its own
    ``x`` (no communication; for values every rank computes alike)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x.to(mesh.device_type), mesh.device_mesh,
                             placements(spec, mesh), src_data_rank=from_rank)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor itself."""
    return x.to_local() if is_dtensor(x) else x


def same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` view the same memory from the same offset
    (by storage, so that fake tensors and DTensors compare too)."""
    a, b = local(a), local(b)
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


def _split_rows(keep: list, mesh, rows: int) -> list:
    """Placements, one per mesh dim, for a per-row computation: a dim
    whose entry in ``keep`` is a placement keeps it; the others split the
    ``rows`` (tensor dim 0) in mesh order as far as they divide them, and
    replicate past that. Every rank then computes distinct rows."""
    from torch.distributed.tensor import Replicate, Shard

    out, n = [], 1
    for i, pl in enumerate(keep):
        if pl is None and rows % (n * mesh.size(i)) == 0:
            n *= mesh.size(i)
            pl = Shard(0)
        out.append(pl if pl is not None else Replicate())
    return out


def local_heads(fn, q, k, v):
    """``fn(q, k, v)`` (attention over q [B, S, H, D] and k, v [B, S, Hkv,
    D], returning [B, S, H, D]) on each rank's own rows and heads: DTensor
    has no rule for the per-head reshapes and f32-accumulating products
    inside, and none is needed, since attention is local to a row and a
    head. q keeps its head shards, and every other mesh dim splits the rows
    (``_split_rows``); k and v follow q's heads when the kv heads divide
    the same way, else each rank takes the kv head of each of its query
    heads from the whole kv heads (the GQA fallback of
    :func:`_head_aligned`, tp > n_kv_heads)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    # local_map reads a tuple as one placement list per output: lists here
    qpl = _split_rows([pl if pl == Shard(2) else None
                       for pl in q.placements], mesh, q.shape[0])
    head_dims = [i for i, pl in enumerate(qpl) if pl == Shard(2)]
    tp = 1
    for i in head_dims:
        tp *= mesh.size(i)
    h, hkv = q.shape[2], k.shape[2]
    if hkv % tp == 0:
        return local_map(fn, out_placements=qpl, in_placements=(qpl,) * 3,
                         redistribute_inputs=True)(q, k, v)
    # this rank's block of query heads, in the mesh order of the dims
    # that split them
    block = 0
    for i in head_dims:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    h_local = h // tp
    kv_of = (block * h_local
             + torch.arange(h_local, device=q.device)) // (h // hkv)
    kvpl = [Replicate() if pl == Shard(2) else pl for pl in qpl]
    # the ranks that share a kv head each hold a part of its gradient
    kvgrad = [Partial() if pl == Shard(2) else pl for pl in qpl]

    def fn_fallback(ql, kl, vl):
        return fn(ql, kl[:, :, kv_of], vl[:, :, kv_of])

    return local_map(fn_fallback, out_placements=qpl,
                     in_placements=(qpl, kvpl, kvpl),
                     in_grad_placements=(qpl, kvgrad, kvgrad),
                     redistribute_inputs=True)(q, k, v)


def _gather_dims(x, dims):
    """DTensor ``x`` with each of tensor ``dims`` whole on every rank
    (gathered where split), its other placements kept."""
    from torch.distributed.tensor import Replicate

    pls = [Replicate() if pl.is_shard() and pl.dim % x.ndim in dims else pl
           for pl in x.placements]
    if pls == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pls)


def _whole_middle(x):
    """``x`` with every dim between its first and its last whole; plain
    tensors and DTensors of fewer than 3 dims pass through."""
    if not is_dtensor(x) or x.ndim < 3:
        return x
    return _gather_dims(x, range(1, x.ndim - 1))


class _WholeMiddleGrad(torch.autograd.Function):
    """The identity, whose gradient has its middle dims gathered."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _whole_middle(g)


def matmul(x, w):
    """``x @ w`` (x [..., k], w [k, n]). The product folds x's leading dims
    into one, and its backward folds the result's gradient so; DTensor
    folds a dim split over the mesh only when it leads the fold (torch
    2.11 refuses the others, 2.13 strides them). So on a DTensor every dim
    between x's first and last is gathered before the product, and so is
    the gradient before the product's backward: a sequence split over tp
    (the dry run's ``hidden`` hint, Megatron sequence parallelism) is
    gathered there, as Megatron gathers it."""
    if not is_dtensor(x) or x.ndim < 3:
        return x @ w
    return _WholeMiddleGrad.apply(_whole_middle(x) @ w)


def whole_unless_even(x, dim: int, unit: int):
    """DTensor ``x`` with ``dim`` gathered unless every rank's share of it
    is a whole number of ``unit``-long pieces, the same for each (so that
    a reshape may cut the dim into pieces: DTensor cannot cut a piece
    across ranks); plain tensors pass through."""
    if not is_dtensor(x):
        return x
    d, n = dim % x.ndim, 1
    for i, pl in enumerate(x.placements):
        if pl.is_shard() and pl.dim % x.ndim == d:
            n *= x.device_mesh.size(i)
    return x if x.shape[d] % (n * unit) == 0 else _gather_dims(x, (d,))


def split_heads(x, heads: int, head_dim: int):
    """``x`` [..., heads * head_dim] as [..., heads, head_dim]. A DTensor
    whose last dim is split other than into whole heads (tp > n_kv_heads:
    the GQA fallback's kv heads, which replicate over tp anyway; tp not
    dividing RWKV6's or Mamba2's heads) gathers that dim first: a head is
    never cut across ranks."""
    return whole_unless_even(x, -1, head_dim).reshape(*x.shape[:-1], heads,
                                                      head_dim)


class _GradWholeUnlessEven(torch.autograd.Function):
    """The identity, whose gradient goes through :func:`whole_unless_even`
    on its last dim."""

    @staticmethod
    def forward(ctx, y, unit: int):
        ctx.unit = unit
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return whole_unless_even(g, -1, ctx.unit), None


def merge_heads(x, shape: tuple):
    """``x`` [..., H, K] as ``shape`` [..., H * K], the inverse of
    :func:`split_heads`. The fold's backward cuts the gradient's last dim
    into heads, so on a DTensor that gradient is gathered first unless it
    splits into whole heads evenly (a gradient split on the columns, from a
    column-parallel gate, while tp does not divide the heads)."""
    y = x.reshape(shape)
    if not is_dtensor(y):
        return y
    return _GradWholeUnlessEven.apply(y, x.shape[-1])


def _position_share(cache) -> tuple[list, int]:
    """(the mesh dims that split the positions of DTensor ``cache`` [B, S,
    Hkv, D], this rank's first position). Raises ``ValueError`` unless
    those dims split S evenly: DTensor gives uneven shares the sizes of
    ``torch.chunk``, whose offsets this does not follow."""
    from torch.distributed.tensor import Shard

    mesh = cache.device_mesh
    dims = [i for i, pl in enumerate(cache.placements) if pl == Shard(1)]
    n = math.prod(mesh.size(i) for i in dims)
    if cache.shape[1] % n:
        raise ValueError(f"a cache of {cache.shape[1]} positions does not "
                         f"split evenly over {n} position shards")
    block, share = 0, cache.shape[1] // n
    for i in dims:                      # mesh order: major to minor
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    return dims, block * share


def _rows_heads(cache, head_dim: int) -> list:
    """Placements, one per mesh dim, of a tensor whose dim 0 is the rows of
    DTensor ``cache`` [B, S, Hkv, D] and whose dim ``head_dim`` its (query
    or kv) heads: split as the cache splits them, whole elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if pl == Shard(0) else
            Shard(head_dim) if pl == Shard(2) else Replicate()
            for pl in cache.placements]


def write_prefix(cache, new) -> None:
    """``cache[:, :s] = new`` (``new`` [B, s, Hkv, D]), in place. On a
    DTensor cache each rank writes the positions of its own share: a
    slice across the shards of a DTensor is a gathered copy, and writing
    it would leave the cache as it was."""
    s = new.shape[1]
    if not is_dtensor(cache):
        cache[:, :s] = new.to(cache.dtype)
        return
    from torch.distributed.tensor.experimental import local_map

    _, first = _position_share(cache)

    def write(cl, nl):
        n = max(0, min(s - first, cl.shape[1]))
        cl[:, :n] = nl[:, first:first + n].to(cl.dtype)
        return cl

    local_map(write, out_placements=list(cache.placements),
              in_placements=(tuple(cache.placements),
                             _rows_heads(cache, 2)),
              redistribute_inputs=True)(cache, new)


def decode_attention(q, cache_k, cache_v, new_k, new_v, cache_len):
    """``kernels.ref.decode_attention_ref`` (append, then attend; the
    caches come back as new tensors) on DTensor caches [B, S, Hkv, D]
    placed by ``kv_cache_spec``: rows, positions or kv heads split over
    mesh dims. Each rank writes the new k, v of the rows whose position
    falls in its share of the positions, and attends its rows' and heads'
    queries over its own positions; the softmax's max and sum and the
    output are then summed up over the mesh dims that split the positions
    (all-reduces of [B, H] and [B, H, D] per rank, as GSPMD does for a
    sequence-sharded cache). Returns (out [B, H, D], k', v')."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = cache_k.device_mesh
    s, d = cache_k.shape[1], cache_k.shape[3]
    cpl = tuple(cache_k.placements)
    seq, first = _position_share(cache_k)
    qpl = _rows_heads(cache_k, 1)
    lenpl = [Shard(0) if pl == Shard(0) else Replicate() for pl in cpl]

    def summed(x, op: str):
        for i in seq:
            x = fc.all_reduce(x, op, (mesh, i))
        return x

    def attend(ql, ck, cv, nk, nv, lens):
        pos = lens.long()
        at = torch.where(pos < 0, pos + s, pos) - first   # the oracle's wrap
        mine = ((at >= 0) & (at < ck.shape[1]))[:, None, None]
        rows = torch.arange(ck.shape[0], device=ck.device)
        at = at.clamp(0, ck.shape[1] - 1)
        ck, cv = ck.clone(), cv.clone()
        ck[rows, at] = torch.where(mine, nk.to(ck.dtype), ck[rows, at])
        cv[rows, at] = torch.where(mine, nv.to(cv.dtype), cv[rows, at])
        f32 = torch.float32
        bl, hl = ql.shape[:2]
        qg = ql.reshape(bl, ck.shape[2], hl // ck.shape[2], d).to(f32)
        sc = torch.einsum("bhgd,bshd->bhgs", qg, ck.to(f32)) / (d ** 0.5)
        kpos = first + torch.arange(ck.shape[1], device=ck.device)
        valid = (kpos[None] <= pos[:, None])[:, None, None, :]
        sc = sc.masked_fill(~valid, float("-inf"))
        e = torch.exp(sc - summed(sc.amax(-1, keepdim=True), "max"))
        p = (e / summed(e.sum(-1, keepdim=True), "sum")).to(cv.dtype)
        out = torch.einsum("bhgs,bshd->bhgd", p.to(f32), cv.to(f32))
        return summed(out, "sum").reshape(bl, hl, d).to(ql.dtype), ck, cv

    return local_map(attend, out_placements=(qpl, list(cpl), list(cpl)),
                     in_placements=(qpl, cpl, cpl, qpl, qpl, lenpl),
                     redistribute_inputs=True)(
        q, cache_k, cache_v, new_k, new_v, on_mesh_of(cache_len, cache_k))


def on_mesh_of(x, ref):
    """``x`` as a DTensor on ``ref``'s mesh: as it is, or, for a plain
    tensor (the same on every rank), replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(x):
        return x
    return DTensor.from_local(x, ref.device_mesh,
                              [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def local_rows(fn, x, rows):
    """``fn(x, rows)`` on each rank's own rows: ``x`` [B, S, ...] and
    ``rows`` [B, S] are split by rows over every mesh dim that divides
    them (``_split_rows``) and whole along every other dim; ``fn`` returns
    a tuple of 3 [B, S] tensors, each row's from that row's values alone
    (the loss's per-token terms over the whole vocab: the vocab shards of
    the logits go to the ranks of their rows)."""
    from torch.distributed.tensor.experimental import local_map

    pl = _split_rows([None] * x.device_mesh.ndim, x.device_mesh, x.shape[0])
    return local_map(fn, out_placements=(pl,) * 3, in_placements=(pl, pl),
                     redistribute_inputs=True)(x, on_mesh_of(rows, x))


def row_placements(x) -> list:
    """Placements, one per mesh dim, of DTensor ``x``'s rows (dim 0): split
    where ``x`` splits them, whole on every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if pl == Shard(0) else Replicate() for pl in x.placements]


def local_row_sum(fn, x):
    """``fn(x)``, a sum over the rows of DTensor ``x`` (a tensor without
    them), computed by each rank on its own rows and summed over the ranks
    that split the rows: replicated on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rows = row_placements(x)
    out = [Partial() if pl == Shard(0) else Replicate() for pl in rows]
    return reduced(local_map(fn, out_placements=out, in_placements=(rows,),
                             redistribute_inputs=True)(x))


def local_recurrence(fn, q, k, v, log_w, state=None, bonus=None):
    """``fn(q, k, v, log_w, state, bonus) -> (y, state')``, a recurrence
    local to a (row, head) (``linear_scan``'s chunked form: q, k [B, T, H,
    K], log_w [B, T, H, K] or [B, T, H], v [B, T, H, V]; its step form:
    the same without T), with the carried state [B, H, K, V] and the bonus
    [H, K] optional (None), on each rank's own rows and heads. The rows
    and heads are split as ``v`` splits them, every other dim whole: a
    mesh dim that splits neither (tp over more ranks than heads, where the
    head projections gathered their columns) computes its ranks' heads
    alike. The state takes the rows' and heads' placements, the bonus the
    heads', and its gradient is summed over the ranks that split the
    rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    heads = v.ndim - 2
    xpl, spl, bpl, bgrad = [], [], [], []
    for pl in v.placements:
        if pl == Shard(0):
            xpl.append(pl), spl.append(pl)
            bpl.append(Replicate()), bgrad.append(Partial())
        elif pl.is_shard() and pl.dim % v.ndim == heads:
            xpl.append(Shard(heads)), spl.append(Shard(1))
            bpl.append(Shard(0)), bgrad.append(Shard(0))
        else:
            xpl.append(Replicate()), spl.append(Replicate())
            bpl.append(Replicate()), bgrad.append(Replicate())
    extra = [(x, p, g) for x, p, g in ((state, spl, spl), (bonus, bpl, bgrad))
             if x is not None]

    def body(ql, kl, vl, lwl, *rest):
        it = iter(rest)
        return fn(ql, kl, vl, lwl, next(it) if state is not None else None,
                  next(it) if bonus is not None else None)

    return local_map(
        body, out_placements=(xpl, spl),
        in_placements=((xpl,) * 4 + tuple(p for _, p, _ in extra)),
        in_grad_placements=((xpl,) * 4 + tuple(g for _, _, g in extra)),
        redistribute_inputs=True)(
        *(on_mesh_of(x, v) for x in (q, k, v, log_w)),
        *(on_mesh_of(x, v) for x, _, _ in extra))


def local_lookup(w, ids):
    """``w[ids]`` of a DTensor table [V, d] (rows split over the FSDP axes,
    columns over tp) and DTensor ids [B, S] (rows over the batch axes):
    each rank gathers the table's rows, keeps its columns, and looks up
    its own ids. The table's gradient is the sum over the ranks that split
    the batch of their rows' contributions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ids = on_mesh_of(ids, w)
    wpl, opl, gpl = [], [], []
    for pw, pi in zip(w.placements, ids.placements):
        cols = pw == Shard(1)
        wpl.append(Shard(1) if cols else Replicate())
        opl.append(Shard(0) if pi == Shard(0) else
                   Shard(2) if cols else Replicate())
        gpl.append(Partial() if pi == Shard(0) else wpl[-1])
    ipl = [Shard(0) if p == Shard(0) else Replicate() for p in ids.placements]
    return local_map(lambda t, i: t[i.long()], out_placements=opl,
                     in_placements=(wpl, ipl), in_grad_placements=(gpl, ipl),
                     redistribute_inputs=True)(w, ids)


def mesh_of(x):
    """The ``launch.mesh.Mesh`` a DTensor lives on."""
    from repro_torch.launch.mesh import Mesh

    return Mesh(x.device_mesh)


def zeros(shape, dtype, like, spec) -> torch.Tensor:
    """Zeros of ``shape``: on ``like``'s device for a plain ``like``, else a
    DTensor on ``like``'s mesh placed as ``spec`` says (each rank
    allocates its shard only)."""
    if not is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import zeros as dzeros

    mesh = mesh_of(like)
    return dzeros(tuple(shape), dtype=dtype, device_mesh=like.device_mesh,
                  placements=placements(spec, mesh))


def like(x, ref):
    """``x`` placed as DTensor ``ref`` is (plain tensors pass through): a
    gradient or update brought to its parameter's placements."""
    if not is_dtensor(x) or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def reduced(x):
    """``x`` with its pending sums (``Partial`` placements) reduced onto
    every rank, in ``x``'s dtype; plain tensors pass through."""
    from torch.distributed.tensor import Partial, Replicate

    if not is_dtensor(x) or not any(isinstance(pl, Partial)
                                    for pl in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(pl, Partial) else pl
        for pl in x.placements])


# optimizer and error-feedback states: each state leaf's spec from its
# parameter's (``launch.specs.opt_state_pspecs`` and the optimizers' inits
# both read these)

def quant_spec(param_spec, n_blocks: int, mesh) -> PartitionSpec:
    """A last-axis-blocked quantized state [*param_lead, nblocks, BLOCK]:
    the param's leading-dim sharding, the block dim sharded on the param's
    last-dim axes when they divide it."""
    base = tuple(param_spec)
    last = base[-1] if base else None
    return P(*base[:-1], _fit(mesh, last, n_blocks) if last else None, None)


def row_factor_spec(param_spec) -> PartitionSpec:
    """Adafactor's row factor (the param's last dim reduced)."""
    return P(*tuple(param_spec)[:-1])


def col_factor_spec(param_spec) -> PartitionSpec:
    """Adafactor's column factor (the param's second-to-last dim reduced)."""
    base = tuple(param_spec)
    return P(*base[:-2], base[-1])


def ef_spec(param_spec, mesh) -> PartitionSpec:
    """The error-feedback residual [n_pods, *param_shape]: a ``pod`` mesh
    axis shards the lead axis and leaves the param's dims."""
    dims = tuple(param_spec)
    if "pod" not in mesh.axis_names:
        return P(None, *dims)

    def strip(a):
        if a == "pod":
            return None
        if isinstance(a, tuple):
            rest = tuple(x for x in a if x != "pod")
            return rest if len(rest) > 1 else (rest[0] if rest else None)
        return a
    return P("pod", *(strip(a) for a in dims))


def plain_is_replicated(x):
    """A context in which plain tensors meeting DTensors count as
    replicated (the positions, masks and rotary tables the model makes
    inside a step), when ``x`` is a DTensor; else no context."""
    if not is_dtensor(x):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def per_pod(fn, params: PyTree, batch: dict, axis: str = "pod"):
    """``fn(params, batch) -> (metrics, grads)`` run by each ``axis`` slice
    of the mesh on its own shard of the batch: the JAX package's
    ``vmap(grad)`` over a pod-sharded leading axis. The parameters must
    be replicated over ``axis`` and the batch's rows split over it. Returns
    (grads [n_pods, ...] split over ``axis`` on their lead dim, metrics
    averaged over the pods)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm = T.leaves(params)[0].device_mesh
    names = tuple(dm.mesh_dim_names)
    a = names.index(axis)
    sub = dm[tuple(x for x in names if x != axis)]

    def down(x, want):
        pls = list(x.placements)
        if pls.pop(a) != want:
            raise ValueError(f"per-pod step: a {tuple(x.shape)} input is "
                             f"placed {x.placements}, not {want} on "
                             f"{axis!r}")
        return DTensor.from_local(x.to_local(), sub, pls, run_check=False)

    def up(x):
        if not is_dtensor(x):            # a constant of the step (moe_aux)
            x = DTensor.from_local(x, sub, [Replicate()] * sub.ndim,
                                   run_check=False)
        pls = [Shard(pl.dim + 1) if isinstance(pl, Shard) else pl
               for pl in x.placements]
        pls.insert(a, Shard(0))
        return DTensor.from_local(x.to_local()[None], dm, pls,
                                  run_check=False)

    metrics, grads = fn(T.tree_map(lambda p: down(p, Replicate()), params),
                        {k: down(v, Shard(0)) for k, v in batch.items()})
    metrics = {k: reduced(up(v.to(torch.float32)).mean(0))
               for k, v in metrics.items()}
    return T.tree_map(up, grads), metrics


def has_axis(tree: PyTree, axis: str) -> bool:
    """Whether ``tree``'s leaves are DTensors on a mesh with ``axis``."""
    x = T.leaves(tree)[0]
    return is_dtensor(x) and axis in x.device_mesh.mesh_dim_names


def gather_all(x):
    """DTensor ``x`` whole on every rank (replicated on every mesh dim)."""
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


