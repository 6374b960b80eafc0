"""Page-aligned sharding geometry of the paged KV pool.

The pool's word axis IS its sequence/page axis (word ``w`` belongs to page
``w // page_tokens``). ``kv_shard_plan`` is the validated geometry (shards,
pages/words per shard) the pool's device-aware allocator consumes; a page
never straddles two shards. This slice of the port runs the pool on one
device, so the plan it uses has one shard; the multi-device data plane is
ROADMAP item A8.
"""
from __future__ import annotations

import dataclasses


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
