"""Page-aligned sharding geometry of the paged KV pool.

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

import torch


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
