"""Paged KV cache on the multi-port memory — the paper's technique as the
serving memory manager.

The physical pool is ONE word-addressable MultiPortMemory (a word = one
token's full KV footprint: K and V vectors for every layer); sequences own
pages of ``page_tokens`` words through a page table, exactly like vLLM's
paged attention — except the pool is accessed through the paper's
configurable ports:

    port A (W): decode append     — one word per active sequence
    port B (R): attention reads   — gathers of page-resident words
    port C (W): prefill bulk fill — admitted prompts' pages in one shot
    port D (W): eviction scrub    — freed pages zeroed

One :meth:`cycle` call is ONE physical traversal of the pool servicing every
enabled port, in the engine's FSM order (priority ``A > D > C > B``): decode
appends land first, eviction scrubs reclaim pages before bulk prefill can
reuse them, and attention reads observe everything written earlier in the
same macro-cycle (the paper's same-cycle W->R visibility). ``traversals``
counts physical traversals — the serving engine benchmark divides it by
generated tokens to measure claim C1 at the system level. ``tile_reads`` /
``tile_writes`` additionally count the DISTINCT ``seq_tile``-word tiles each
traversal actually touches per port role, so a traversal over a short live
sequence is visibly cheaper than one over a full-capacity sequence — the
length-bounded-traversal discipline measured at the pool level.

Each port stream accepts a single ``{"seq": ...}`` dict or a LIST of them
(multi-sequence transactions): the pool packs all streams of a port into one
vectorized request queue, so e.g. every active slot's decode append is one
port-A transaction.

``use_kernel=True`` backs the data plane with ``core.step_banked`` (the
hand-written pool-step kernel on CUDA tensors, its plain torch version on
CPU tensors), ``use_kernel=False`` keeps the oracle ``core.step``. The
storage is a torch tensor on the pool's device; the page-table bookkeeping
stays host-side (python ints — it is control plane, like the engine's
scheduler).

**Device-aware allocation** (``kv_shards`` > 1): the pool's word axis — its
sequence/page axis — is split into page-aligned shards (the plan is
validated by :func:`repro_torch.distributed.sharding.kv_shard_plan`; a page
never straddles two shards). Each sequence gets a HOME shard on admission
(least-loaded by live-sequence count, then by free pages) and every one of
its pages is carved from that shard's own free list. A cycle whose page
demand overflows a home shard raises :class:`PoolCapacityError` BEFORE any
mutation, even when other shards still have free pages (cross-shard spill
would break locality; the scheduler can evict or re-admit instead). Page
tables stay replicated host-side control plane.

With a ``mesh`` (``launch.mesh.make_kv_mesh``) of more than one shard, the
data plane is sharded too: ``storage`` is a tuple of one ``[words_per_shard,
W]`` tensor per shard, each on its mesh device (the geometry is
``kv_pool_spec``'s), and each traversal services, on every shard, the
request lanes whose global word addresses fall inside that shard's window
(local re-addressing + mask); read ports sum their lane results across the
shards onto the first shard's device — exactly one shard owns each address,
so the sum IS the gather (the JAX package's ``psum``). One sharded cycle is
still ONE traversal of (now distributed) storage. ``kv_shards`` without a
mesh keeps the device-aware control plane over unsharded storage.

**Refcounted copy-on-write page sharing** (the prefix-cache substrate):
pages are no longer exclusively owned — ``refcounts`` tracks how many page
tables reference each physical page, :meth:`free` DECREMENTS (a page only
returns to its shard's free list, and only then may be scrubbed, when the
last reference dies; earlier releases just detach), and a
content-addressed prefix index keyed on token-hash chains at page
granularity (:meth:`register_prefix` / :meth:`match_prefix` /
:meth:`attach_prefix`) lets a new sequence adopt an already-committed
prompt prefix by refcount bump instead of recomputing it. Sharing is
READ-ONLY by construction: a write whose word would land in a shared page
copy-on-writes it first (fresh page carved on the WRITER's home shard, the
live words copied through the same traversal's W port, only the writer's
table remapped — see :meth:`_cow_prepare`), so hazard analysis can treat
shared pages as read-shared/write-private. Shared pages pin to the shard
where they were first written and an attaching sequence's home FOLLOWS the
matched prefix (its unmatched tail is carved there too) — a full
least-loaded shard sheds load by sharing instead of raising
:class:`PoolCapacityError`. With no registrations the pool behaves
bit-identically to exclusive ownership.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import (MemorySpec, PortConfig, READ, WRITE, PortRequest,
                              empty_request, step, step_banked)
from repro_torch.distributed.sharding import (KVShardPlan, kv_pool_spec,
                                              kv_shard_plan, on_device,
                                              shard_of_pages)
from repro_torch.spans import span

# pool port indices
APPEND, ATTN_READ, BULK_FILL, SCRUB = 0, 1, 2, 3
# service order: appends > scrubs > bulk fills > reads (see module docstring)
_PRIORITY = (APPEND, SCRUB, BULK_FILL, ATTN_READ)
_ROLES = (WRITE, READ, WRITE, WRITE)

Stream = Union[dict, Sequence[dict], None]


class PoolCapacityError(MemoryError):
    """An admission's page demand exceeds its home shard's free page supply.

    Raised BEFORE any page-table or length mutation: a failed transaction
    leaves the pool exactly as it was, so the scheduler can retry the
    admission after evictions free pages. Under device-aware allocation the
    error names the full home shard even when OTHER shards still hold free
    pages — a sequence's pages never spill across shards."""


# root of every prefix hash chain (see PagedPool.register_prefix)
_PREFIX_ROOT = -1


def _chain_key(parent: int, page_toks: tuple) -> int:
    """Content-address of a page-granular prefix chain node: the hash of
    (parent chain key, this page's token tuple). Python's tuple-of-int hash
    is deterministic (PYTHONHASHSEED only perturbs str/bytes), so the chain
    is stable across processes — trace replays and subprocess oracles see
    the same index."""
    return hash((parent, page_toks))


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """A non-mutating :meth:`PagedPool.match_prefix` result: the registered
    pages a prompt's head can adopt by refcount bump. ``tokens`` counts the
    matched prefix (the LAST page may be partial — the matcher's own writes
    copy-on-write around its remaining words); ``full_pages`` is how many
    matched pages the adopter will never write (``tokens // page_tokens``
    — the count admission subtracts from worst-case page demand, since a
    partial tail page is offset by its own CoW replacement). All matched
    pages live on ``shard`` — shared pages pin where first written."""

    pages: tuple                       # matched page ids, chain order
    tokens: int                        # matched prefix length in tokens
    shard: int                         # the one shard holding every page
    full_pages: int                    # fully-matched pages (never written)


def _bucket(n: int, lo: int = 8) -> int:
    """Round a queue length up to a power of two (bucketed launch shapes)."""
    b = lo
    while b < n:
        b *= 2
    return b


def seq_tile_buckets(max_len: int, seq_tile: int) -> tuple[int, ...]:
    """The staging-cache lengths the engine's length-bounded dispatch can
    stage (and so the shapes its decode / prefill-chunk steps are launched
    at): power-of-two counts of ``seq_tile`` tiles, the last PADDED up to
    ``ceil(max_len / seq_tile) * seq_tile`` so every staged length is a
    whole number of tiles (the kernels never fall back to degenerate
    tile-1 grids for awkward capacities).

    The single source of truth for the ladder: the engine's ``_stage_len``
    walks it and ``launch/serve.py`` validates ``--seq-tile`` against it at
    startup. Raises ValueError when ``seq_tile`` cannot tile a ``max_len``
    cache.
    """
    if seq_tile < 1:
        raise ValueError(f"seq_tile must be >= 1, got {seq_tile}")
    if seq_tile > max_len:
        raise ValueError(
            f"seq_tile ({seq_tile}) exceeds the model's S_max ({max_len}); "
            f"the smallest live bucket would overrun the cache")
    cap = -(-max_len // seq_tile) * seq_tile       # padded full capacity
    lens = []
    n = 1
    while n * seq_tile < cap:
        lens.append(n * seq_tile)
        n *= 2
    lens.append(cap)
    return tuple(lens)


def _pool_step(spec, config, storage, requests, *, use_kernel: bool):
    if use_kernel:
        return step_banked(spec, config, storage, requests)
    return step(spec, config, storage, requests)


def _sharded_pool_step(local_spec, config, storage: tuple, requests, *,
                       wps: int, use_kernel: bool):
    """One traversal of a sharded pool: shard ``s`` services the request
    lanes whose global addresses land in its ``wps``-word window
    ``[s*wps, (s+1)*wps)``, re-addressed to local (lanes owned by other
    shards are masked off, and masked read lanes return 0), on its own
    storage on its own device; then the read ports' lane results are summed
    across the shards onto the first shard's device. Exactly one shard owns
    each address, so the sum IS the gather, and write and scrub lanes
    commit on their owner only. Returns (the shards' storage, the results
    of the MAX_PORTS ports)."""
    new, outs = [], []
    for sid, st in enumerate(storage):
        lo = sid * wps
        local = tuple(
            PortRequest(addr=(r.addr - lo).to(st.device),
                        data=r.data.to(st.device),
                        mask=(r.mask & (r.addr >= lo)
                              & (r.addr < lo + wps)).to(st.device))
            for r in requests)
        with on_device(st.device):
            st, got = _pool_step(local_spec, config, st, local,
                                 use_kernel=use_kernel)
        new.append(st)
        outs.append(got)
    home = storage[0].device
    reads = []
    for p in range(len(requests)):
        if config.enabled[p] and config.roles[p] == READ:
            total = outs[0][p]
            for got in outs[1:]:
                total = total + got[p].to(home)
            reads.append(total)
        else:
            reads.append(outs[0][p])
    return tuple(new), reads


@dataclasses.dataclass
class PagedPool:
    """Physical pool + per-shard free lists + per-sequence page tables."""

    spec: MemorySpec
    page_tokens: int
    storage: Union[torch.Tensor, tuple]   # [num_words, W]; with a mesh of
                                       # > 1 shards, one [words_per_shard,
                                       # W] tensor per shard, on its device
    free_by_shard: list                # shard -> free page ids (device-aware)
    tables: dict                       # seq_id -> list[page_id]
    lengths: dict                      # seq_id -> tokens stored
    plan: KVShardPlan = None           # page-aligned shard geometry
    home: dict = dataclasses.field(default_factory=dict)  # seq_id -> shard
    spec_local: Optional[MemorySpec] = None   # per-shard geometry (mesh only)
    use_kernel: bool = False
    traversals: int = 0                # physical pool traversals serviced
    seq_tile: int = 0                  # words per accounting tile
    tile_reads: int = 0                # distinct R-port tiles touched
    tile_writes: int = 0               # distinct W-port tiles touched
    tile_reads_by_shard: list = dataclasses.field(default_factory=list)
    tile_writes_by_shard: list = dataclasses.field(default_factory=list)
    io_width: int = 0                  # caller-visible word width
    mix_counts: dict = dataclasses.field(default_factory=dict)
                                       # PortConfig.describe() -> traversals
                                       # serviced with that port mix
    quarantine_by_shard: list = dataclasses.field(default_factory=list)
                                       # shard -> pages withheld from
                                       # allocation by a chaos squeeze
    refcounts: dict = dataclasses.field(default_factory=dict)
                                       # page -> tables referencing it (every
                                       # mapped page has an entry >= 1; free
                                       # and quarantined pages have none)
    prefix_index: dict = dataclasses.field(default_factory=dict)
                                       # parent chain key -> {page token
                                       # tuple -> page id} (content-addressed
                                       # prefix chains, page granularity)
    page_reg: dict = dataclasses.field(default_factory=dict)
                                       # page -> (parent, token tuple): its
                                       # index slot, dropped on last release
    prefix_lookups: int = 0            # match_prefix calls
    prefix_hits: int = 0               # attaches (>= 1 token adopted)
    prefix_attached_tokens: int = 0    # tokens adopted without recompute
    prefix_attached_pages: int = 0     # pages adopted by refcount bump
    cow_copies: int = 0                # shared tail pages remapped on write
    cow_words: int = 0                 # live words those remaps copied
    h2d_bytes: int = 0                 # host->device: the port requests'
                                       # addr/data/mask, read indices
    d2h_bytes: int = 0                 # device->host: CoW source and
                                       # prefix words read to the host

    @classmethod
    def create(cls, *, n_pages: int, page_tokens: int, word_width: int,
               dtype=torch.float32, num_banks: int = 8,
               use_kernel: bool = False, seq_tile: int = 0,
               kv_shards: int = 1, mesh=None, kv_axis: str = "kv",
               device="cuda") -> "PagedPool":
        """The pool, on ``device`` (the card unless ``device="cpu"``); with
        a ``mesh`` of more than one shard, one storage shard on each mesh
        device instead (``kv_shards`` must then be 1 or the mesh's size,
        and every mesh device of ``device``'s type: the mesh does not move
        the pool to another kind of device than its caller's)."""
        if mesh is not None:
            if kv_axis not in mesh.axis_names:
                raise ValueError(
                    f"mesh {mesh.axis_names} has no {kv_axis!r} axis")
            kind = torch.device(device).type
            if any(d.type != kind for d in mesh.devices):
                raise ValueError(
                    f"kv mesh devices {[str(d) for d in mesh.devices]} are "
                    f"not all {kind} devices like the pool's {device!r}")
            mesh_n = int(mesh.shape[kv_axis])
            if kv_shards not in (1, mesh_n):
                raise ValueError(
                    f"kv_shards={kv_shards} disagrees with the mesh's "
                    f"{mesh_n}-way {kv_axis!r} axis")
            kv_shards = mesh_n
        # page-aligned shard plan: rounds the pool UP to whole pages/shard
        plan = kv_shard_plan(kv_shards, n_pages=n_pages,
                             page_tokens=page_tokens)
        num_words = plan.num_words
        while num_words % num_banks:
            num_banks //= 2                       # geometry guard
        num_banks = max(num_banks, 1)
        spec = MemorySpec(num_words=num_words, word_width=word_width,
                          dtype=dtype, num_banks=num_banks)
        spec_local = None
        if mesh is not None and kv_shards > 1:
            kv_pool_spec(mesh, num_words=num_words, page_tokens=page_tokens,
                         axis=kv_axis)
            wps = plan.words_per_shard
            nb_local = num_banks
            while wps % nb_local:
                nb_local //= 2
            spec_local = MemorySpec(num_words=wps, word_width=word_width,
                                    dtype=dtype, num_banks=max(nb_local, 1))
            storage = tuple(spec_local.init_storage(device=d)
                            for d in mesh.devices)
        else:
            storage = spec.init_storage(device=_device.resolve(device))
        return cls(spec=spec, page_tokens=page_tokens, storage=storage,
                   free_by_shard=[list(range(s * plan.pages_per_shard,
                                             (s + 1) * plan.pages_per_shard))
                                  for s in range(kv_shards)],
                   tables={}, lengths={}, plan=plan, spec_local=spec_local,
                   use_kernel=use_kernel,
                   seq_tile=seq_tile or page_tokens,
                   tile_reads_by_shard=[0] * kv_shards,
                   tile_writes_by_shard=[0] * kv_shards,
                   io_width=word_width,
                   quarantine_by_shard=[[] for _ in range(kv_shards)])

    @property
    def sharded(self) -> bool:
        """True when the storage is split over a mesh's devices."""
        return self.spec_local is not None

    @property
    def device(self) -> torch.device:
        """Where the pool's results land: the first shard's device."""
        return self.storage[0].device if self.sharded else self.storage.device

    def _read_words(self, addr: np.ndarray) -> torch.Tensor:
        """Words at global addresses ``addr`` ([n, W] on :attr:`device`),
        each read from the shard that owns it."""
        idx = torch.from_numpy(np.asarray(addr, np.int64))
        self.h2d_bytes += idx.numel() * idx.element_size()
        if not self.sharded:
            return self.storage[idx.to(self.device)]
        out = torch.empty((len(idx), self.spec.word_width),
                          dtype=self.spec.dtype, device=self.device)
        wps = self.words_per_shard
        for sid, st in enumerate(self.storage):
            sel = (idx // wps) == sid
            if bool(sel.any()):
                got = st[(idx[sel] - sid * wps).to(st.device)]
                out[sel.to(self.device)] = got.to(self.device)
        return out

    # ---- shard geometry ------------------------------------------------------
    @property
    def kv_shards(self) -> int:
        return self.plan.n_shards

    @property
    def words_per_shard(self) -> int:
        return self.plan.words_per_shard

    @property
    def free_pages(self) -> list:
        """All free page ids (shard-major) — the legacy single-list view."""
        return [p for fl in self.free_by_shard for p in fl]

    @property
    def free_page_count(self) -> int:
        return sum(len(fl) for fl in self.free_by_shard)

    @property
    def quarantined_pages(self) -> tuple:
        """Pages withheld from allocation by a fault-injection squeeze
        (sorted; empty outside chaos runs)."""
        return tuple(sorted(p for q in self.quarantine_by_shard for p in q))

    def quarantine(self, n_per_shard: int,
                   keep_free: Optional[Sequence[int]] = None) -> list:
        """Fault injection: withhold up to ``n_per_shard`` FREE pages per
        shard from allocation (an admission-time capacity squeeze — the
        chaos harness's knob). Only free pages are taken, and a
        ``keep_free`` floor (per shard) protects pages the engine has
        conservatively reserved for in-flight sequences' worst-case
        growth, so a squeeze pressures ADMISSION — parked/retried/shed at
        the queue — without ever making an already-admitted sequence's
        append fail mid-stream. Returns the page ids actually taken;
        :meth:`release_quarantine` gives them back."""
        if n_per_shard < 0:
            raise ValueError(f"n_per_shard must be >= 0, got {n_per_shard}")
        keep = list(keep_free) if keep_free is not None \
            else [0] * self.kv_shards
        if len(keep) != self.kv_shards:
            raise ValueError(
                f"keep_free has {len(keep)} entries for {self.kv_shards} "
                f"shards")
        taken = []
        for s, fl in enumerate(self.free_by_shard):
            n = min(n_per_shard, max(0, len(fl) - keep[s]))
            for _ in range(n):
                p = fl.pop()
                if self.refcounts.get(p, 0):
                    # free lists never hold mapped pages; a refcounted page
                    # here means the pool's books are corrupt — refuse the
                    # squeeze rather than withhold words sequences still read
                    fl.append(p)
                    raise ValueError(
                        f"quarantine refused page {p}: refcount "
                        f"{self.refcounts[p]} > 0 (tables still reference "
                        f"it, yet it sat on shard {s}'s free list)")
                self.quarantine_by_shard[s].append(p)
                taken.append(p)
        return taken

    def release_quarantine(self) -> list:
        """Return every quarantined page to its owning shard's free list
        (the squeeze's scheduled end). Returns the released page ids."""
        released = []
        for s, q in enumerate(self.quarantine_by_shard):
            self.free_by_shard[s].extend(q)
            released.extend(q)
            q.clear()
        return released

    def home_of(self, seq: int) -> Optional[int]:
        """The shard a sequence's pages live on (None before admission)."""
        return self.home.get(seq)

    def _home_loads(self) -> list:
        loads = [0] * self.kv_shards
        for s in self.home.values():
            loads[s] += 1
        return loads

    def _pick_home(self, loads: list, free_counts: list) -> int:
        """THE home-selection policy — least live sequences, then most free
        pages, then lowest shard id. The transactional precheck simulates
        admissions through this same function, so the shard it validates is
        always the shard the commit path assigns."""
        return min(range(self.kv_shards),
                   key=lambda s: (loads[s], -free_counts[s], s))

    def assign_home(self, seq: int) -> int:
        """Pick (or return) a sequence's home shard. Idempotent; callers may
        pre-assign at admission so the engine can group compute by shard
        before the first page is carved."""
        got = self.home.get(seq)
        if got is not None:
            return got
        shard = self._pick_home(self._home_loads(),
                                [len(fl) for fl in self.free_by_shard])
        self.home[seq] = shard
        return shard

    def peek_home(self, seq: int) -> int:
        """The shard :meth:`assign_home` WOULD pick (or has picked) for a
        sequence, without committing anything — the admission precheck's
        view."""
        got = self.home.get(seq)
        if got is not None:
            return got
        return self._pick_home(self._home_loads(),
                               [len(fl) for fl in self.free_by_shard])

    def admission_precheck(self, seq: int, total_tokens: int,
                           reserved_by_shard: Optional[Sequence[int]] = None,
                           *, prefix: Optional[PrefixMatch] = None) -> int:
        """Raise :class:`PoolCapacityError` unless a sequence's WORST-CASE
        page demand (``total_tokens`` words over its whole lifetime) fits
        its home shard's free list right now, minus ``reserved_by_shard``
        pages the caller has already promised to other in-flight
        sequences. Non-mutating — no home assignment, no page pops — so
        the engine can probe at admission time, PARK the request on
        failure, and retry after evictions free pages (the recovery path
        that replaces an uncatchable mid-cycle capacity failure). Returns
        the home shard the probe validated against.

        With a ``prefix`` match (a fresh sequence adopting shared pages),
        the probe moves to the PREFIX's shard — the sequence's home will
        follow the matched pages — and demand shrinks to the unmatched
        tail: ``ceil(total_tokens / page_tokens) - prefix.full_pages``.
        Only FULLY-matched pages subtract; a partially-matched tail page
        is offset by the fresh page its copy-on-write replacement will
        carve. This is how a request that would overflow the least-loaded
        shard still admits against a fuller shard that already holds its
        prompt."""
        if prefix is not None and self.tables.get(seq):
            raise ValueError(
                f"seq {seq} already holds pages — prefix-aware prechecks "
                f"are for fresh admissions only")
        if prefix is not None:
            shard = prefix.shard
            need = max(0, -(-total_tokens // self.page_tokens)
                       - prefix.full_pages)
        else:
            shard = self.peek_home(seq)
            held = len(self.tables.get(seq, []))
            need = max(0, -(-(self.lengths.get(seq, 0) + total_tokens)
                            // self.page_tokens) - held)
        reserved = reserved_by_shard[shard] if reserved_by_shard is not None \
            else 0
        avail = len(self.free_by_shard[shard]) - reserved
        if need > avail:
            quarantined = len(self.quarantine_by_shard[shard])
            matched = f", {prefix.tokens} prefix tokens matched" \
                if prefix is not None else ""
            raise PoolCapacityError(
                f"admission precheck: seq {seq} needs {need} pages on home "
                f"shard {shard} for its worst-case {total_tokens} tokens"
                f"{matched} but only {max(avail, 0)} of the shard's "
                f"{len(self.free_by_shard[shard])} free pages are "
                f"unreserved ({reserved} reserved for in-flight sequences, "
                f"{quarantined} quarantined) — park and retry after "
                f"evictions, or shed")
        return shard

    def _tile_shard(self, tile: int) -> int:
        """Shard owning an accounting tile, attributed by its FIRST word.

        Exact whenever ``seq_tile`` divides ``words_per_shard`` (true for
        the power-of-two shard counts and tile sizes the launchers and CI
        use); for geometries where a ``seq_tile``-word window can straddle
        a boundary, the straddling tile counts toward the lower shard —
        an observability approximation only, never a data-placement one
        (pages, and therefore words, still never straddle)."""
        if self.kv_shards == 1:
            return 0
        return min((tile * self.seq_tile) // self.words_per_shard,
                   self.kv_shards - 1)

    def _count_tiles(self, tiles: set, counters: list) -> int:
        for t in tiles:
            counters[self._tile_shard(int(t))] += 1
        return len(tiles)

    # ---- control plane ------------------------------------------------------
    def _ensure_capacity(self, seq: int, new_tokens: int) -> None:
        table = self.tables.setdefault(seq, [])
        self.lengths.setdefault(seq, 0)
        need = -(-(self.lengths[seq] + new_tokens) // self.page_tokens)
        shard = self.assign_home(seq)
        free = self.free_by_shard[shard]
        while len(table) < need:
            if not free:
                raise PoolCapacityError(
                    f"seq {seq}: growing to {self.lengths[seq] + new_tokens} "
                    f"tokens needs {need} pages but only {len(table)} are "
                    f"mapped and home shard {shard}'s free list is empty "
                    f"({self.free_page_count} pages free pool-wide — pages "
                    f"never straddle shards)")
            p = free.pop()
            self.refcounts[p] = 1
            table.append(p)

    def _check_capacity(self, write_streams: Sequence[dict],
                        read_streams: Sequence[dict]) -> None:
        """Transactional admission check, run BEFORE any table mutation:
        each sequence's page demand must fit its HOME shard's free list
        (simulated per shard, in stream order, so multi-sequence admissions
        see the same home-assignment the commit path will make), and every
        read position must fall inside the words its sequence will have
        mapped once this cycle's writes land (reads are serviced after
        writes, so same-cycle append+read of a fresh page is legal)."""
        demand: dict = {}
        for s in write_streams:
            seq = s["seq"]
            demand[seq] = demand.get(seq, 0) + int(s["vectors"].shape[0])
        sim_free = [len(fl) for fl in self.free_by_shard]
        loads = self._home_loads()
        staged_homes: dict = {}
        projected = {}
        for seq, new_tokens in demand.items():
            held = len(self.tables.get(seq, []))
            pages = max(held,
                        -(-(self.lengths.get(seq, 0) + new_tokens)
                          // self.page_tokens))
            projected[seq] = pages
            need = pages - held
            if new_tokens:
                # a shared tail page is write-private: this cycle's commit
                # will copy-on-write it, carving ONE page beyond table growth
                need += self.pending_cow_pages(seq)
            shard = self.home.get(seq)
            if shard is None:
                shard = self._pick_home(loads, sim_free)
                staged_homes[seq] = shard
                loads[shard] += 1
            if need > sim_free[shard]:
                elsewhere = sum(sim_free) - sim_free[shard]
                raise PoolCapacityError(
                    f"admission of {demand[seq]} tokens for seq {seq} needs "
                    f"{need} new pages on home shard {shard} but only "
                    f"{sim_free[shard]} of its {self.plan.pages_per_shard} "
                    f"are free ({elsewhere} free pages on other shards are "
                    f"unusable — pages never straddle shards; evict "
                    f"sequences or raise the pool size)")
            sim_free[shard] -= need
        for s in read_streams:
            seq = s["seq"]
            pages = projected.get(seq, len(self.tables.get(seq, [])))
            pos = np.asarray(s["positions"])
            if not pages:
                raise IndexError(f"seq {seq} has no pages mapped")
            if pos.size and (pos.min() < 0
                             or pos.max() >= pages * self.page_tokens):
                raise IndexError(
                    f"seq {seq}: positions [{pos.min()}, {pos.max()}] outside "
                    f"the {pages * self.page_tokens} words its page table "
                    f"maps this cycle")
        # the WHOLE cycle validated (capacity and reads): commit the staged
        # home assignments (metadata only — the page mutations follow in
        # _write_req via _ensure_capacity, which reuses exactly these homes).
        # Committing last keeps the transactional contract: a refused cycle
        # leaves the pool, home map included, exactly as it was.
        self.home.update(staged_homes)

    def _addr(self, seq: int, token_idx: np.ndarray) -> np.ndarray:
        table = self.tables.get(seq)
        if not table:
            raise IndexError(f"seq {seq} has no pages mapped")
        token_idx = np.asarray(token_idx)
        mapped = len(table) * self.page_tokens
        if token_idx.size and (token_idx.min() < 0
                               or token_idx.max() >= mapped):
            raise IndexError(
                f"seq {seq}: positions [{token_idx.min()}, {token_idx.max()}]"
                f" outside the {mapped} words mapped by its page table")
        table = np.asarray(table)
        return (table[token_idx // self.page_tokens] * self.page_tokens
                + token_idx % self.page_tokens)

    def free(self, seq: int) -> list:
        """Release a sequence's CLAIM on its pages: each page's refcount
        drops by one, and only pages reaching ZERO return to their owning
        shards' free lists. Returns exactly those dead pages (so the caller
        scrubs only physically-unreferenced words through port D in the
        same macro-cycle); pages other sequences still reference DETACH —
        their words survive untouched for the tables, and prefix-index
        entries, still mapping them. A dead page also leaves the prefix
        index, so matches never resolve to recycled storage."""
        pages = self.tables.pop(seq, [])
        self.lengths.pop(seq, None)
        self.home.pop(seq, None)
        dead = []
        for p in pages:
            rc = self.refcounts.get(p, 1) - 1
            if rc > 0:
                self.refcounts[p] = rc
                continue
            self.refcounts.pop(p, None)
            self._deregister_page(p)
            self.free_by_shard[self.plan.shard_of_page(p)].append(p)
            dead.append(p)
        return dead

    # ---- prefix sharing (refcounted copy-on-write) ---------------------------
    def page_refcount(self, page: int) -> int:
        """How many page tables reference a page (0 = free/quarantined)."""
        return self.refcounts.get(page, 0)

    def _deregister_page(self, page: int) -> None:
        reg = self.page_reg.pop(page, None)
        if reg is None:
            return
        parent, key = reg
        kids = self.prefix_index.get(parent)
        if kids and kids.get(key) == page:
            del kids[key]
            if not kids:
                del self.prefix_index[parent]

    def pending_cow_pages(self, seq: int) -> int:
        """1 when the sequence's NEXT write must copy-on-write a shared
        tail page — one extra page its home shard must hold beyond plain
        table growth — else 0. Admission reservations and the transactional
        capacity checks both consult this, so a squeeze or a crowded shard
        can never strand an attached sequence mid-append. Always 0 when
        nothing is shared (exclusive-ownership behavior unchanged)."""
        length = self.lengths.get(seq, 0)
        off = length % self.page_tokens
        if not off:
            return 0
        table = self.tables.get(seq, [])
        idx = length // self.page_tokens
        if idx >= len(table):
            return 0
        return 1 if self.refcounts.get(table[idx], 1) > 1 else 0

    def register_prefix(self, seq: int, tokens: Sequence[int]) -> int:
        """Index a sequence's COMMITTED prompt KV for future admissions:
        each page covered by ``tokens`` joins the content-addressed chain
        under the hash of (parent chain key, the page's token tuple), plus
        at most one sub-page tail entry ending the chain. First
        registration wins — an identical chain already indexed keeps its
        pages (that is the dedup), and the walk continues along the
        existing chain so extensions converge. Returns how many pages this
        call newly indexed. The words must already be in the pool
        (``lengths`` covers ``tokens``) — the engine registers at prefill
        completion, inside the macro-cycle that commits the final chunk."""
        toks = tuple(int(t) for t in tokens)
        committed = self.lengths.get(seq, 0)
        if committed < len(toks):
            raise ValueError(
                f"seq {seq}: cannot register a {len(toks)}-token prefix — "
                f"only {committed} tokens committed")
        table = self.tables.get(seq, [])
        parent = _PREFIX_ROOT
        new = 0
        for i in range(0, len(toks), self.page_tokens):
            key = toks[i:i + self.page_tokens]
            kids = self.prefix_index.setdefault(parent, {})
            page = table[i // self.page_tokens]
            if key not in kids and page not in self.page_reg:
                kids[key] = page
                self.page_reg[page] = (parent, key)
                new += 1
            if not kids:
                del self.prefix_index[parent]      # keep the index sparse
            if len(key) < self.page_tokens:
                break                              # partial tail ends chains
            parent = _chain_key(parent, key)
        return new

    def match_prefix(self, tokens: Sequence[int],
                     limit: Optional[int] = None) -> Optional[PrefixMatch]:
        """Walk the prefix index down a prompt's hash chain: full
        registered pages match page-at-a-time, then the walk may end on ONE
        partial match — the longest registered page head agreeing with the
        remaining tokens (valid because word ``i`` of a page depends only
        on tokens ``0..i`` of the whole prefix under causal attention; the
        matcher's own writes copy-on-write around the rest). Matching never
        crosses shards (chains are home-pinned by construction; a foreign
        page ends the walk). Non-mutating; returns None when nothing
        matched. ``limit`` caps matched tokens — the engine passes
        ``len(prompt) - 1`` so at least one prompt position is always
        recomputed (the first generated token needs its logits)."""
        toks = tuple(int(t) for t in tokens)
        lim = len(toks) if limit is None else min(limit, len(toks))
        self.prefix_lookups += 1
        pages: list = []
        matched = 0
        parent = _PREFIX_ROOT
        shard = None
        while matched + self.page_tokens <= lim:
            key = toks[matched:matched + self.page_tokens]
            page = self.prefix_index.get(parent, {}).get(key)
            if page is None:
                break
            s = self.plan.shard_of_page(page)
            if shard is None:
                shard = s
            elif s != shard:
                break
            pages.append(page)
            matched += self.page_tokens
            parent = _chain_key(parent, key)
        rest = toks[matched:lim]
        if rest:
            best = None                            # (match len, page id)
            for key, page in self.prefix_index.get(parent, {}).items():
                if shard is not None \
                        and self.plan.shard_of_page(page) != shard:
                    continue
                j = 0
                while j < len(rest) and j < len(key) and key[j] == rest[j]:
                    j += 1
                # longest head wins; page id breaks ties deterministically
                if j and (best is None or (-j, page) < (-best[0], best[1])):
                    best = (j, page)
            if best is not None:
                j, page = best
                if shard is None:
                    shard = self.plan.shard_of_page(page)
                pages.append(page)
                matched += j
        if not matched:
            return None
        return PrefixMatch(pages=tuple(pages), tokens=matched, shard=shard,
                           full_pages=matched // self.page_tokens)

    def attach_prefix(self, seq: int, match: PrefixMatch) -> int:
        """Attach a FRESH sequence to matched prefix pages by refcount bump
        — no words move, no pages pop. The sequence's home becomes the
        shard holding the prefix (shared pages pin where first written, and
        the unmatched tail will be carved there too), which is what lets a
        full least-loaded shard shed load by sharing. Returns that shard.
        Must precede any allocation for the sequence."""
        if self.tables.get(seq):
            raise ValueError(f"seq {seq} already holds pages — prefix "
                             f"attach must precede allocation")
        if not match.pages:
            raise ValueError(f"seq {seq}: empty prefix match")
        shard = shard_of_pages(self.plan, match.pages)
        if shard != match.shard:
            raise ValueError(
                f"seq {seq}: match claims shard {match.shard} but its pages "
                f"live on shard {shard}")
        self.tables[seq] = list(match.pages)
        self.lengths[seq] = match.tokens
        self.home[seq] = shard
        for p in match.pages:
            self.refcounts[p] = self.refcounts.get(p, 0) + 1
        self.prefix_hits += 1
        self.prefix_attached_tokens += match.tokens
        self.prefix_attached_pages += len(match.pages)
        return shard

    def gather_words(self, seq: int, positions) -> np.ndarray:
        """Host-side staging gather of a sequence's committed words,
        cropped to the caller-visible ``io_width``. This is how the engine
        refills a prefill staging cache from ATTACHED prefix pages whose
        KV it never computed — control-plane staging like the CoW source
        read, not a ported traversal (the pool's ports only carry words
        the model is writing or attending this macro-cycle)."""
        got = self._read_words(self._addr(seq, np.asarray(positions)))
        return self._to_host(got)[:, :self.io_width]

    def _to_host(self, words: torch.Tensor) -> np.ndarray:
        """A counted f32 host copy of words read from the pool."""
        out = words.float().cpu().numpy()
        self.d2h_bytes += out.nbytes
        return out

    def _cow_prepare(self, seq: int, new_tokens: int):
        """Copy-on-write remap for a write stream: when the sequence's next
        word would land in a page OTHER tables still reference (refcount >
        1), carve a fresh page from the FRONT of its home shard's free list
        — growth pops the BACK, and the split keeps page identities stable
        between the scheduler's footprint projection and this commit
        whatever the traversal grouping — move this sequence's refcount to
        the fresh page, and remap ONLY its table entry. Returns the
        ``(old_words, new_words)`` address arrays whose live words the
        caller copies through the same traversal's W port, or None when no
        copy is needed. The shared page itself is never written again:
        sharing is read-only by construction, which is exactly the
        write-private contract the scheduler's hazard analysis assumes."""
        if new_tokens <= 0:
            return None
        length = self.lengths.get(seq, 0)
        off = length % self.page_tokens
        idx = length // self.page_tokens
        table = self.tables.get(seq, [])
        if not off or idx >= len(table):
            return None
        old = table[idx]
        if self.refcounts.get(old, 1) <= 1:
            return None
        shard = self.assign_home(seq)
        free = self.free_by_shard[shard]
        if not free:
            raise PoolCapacityError(
                f"seq {seq}: copy-on-write of shared page {old} needs a "
                f"fresh page on home shard {shard} but its free list is "
                f"empty — the capacity checks should have counted "
                f"pending_cow_pages")
        fresh = free.pop(0)
        self.refcounts[old] -= 1
        self.refcounts[fresh] = 1
        table[idx] = fresh
        self.cow_copies += 1
        self.cow_words += off
        words = np.arange(off)
        return (old * self.page_tokens + words,
                fresh * self.page_tokens + words)

    # ---- footprint projection (scheduler support) ----------------------------
    def mapped_pages(self, seq: int) -> tuple:
        """The pages a sequence currently owns (empty before admission)."""
        return tuple(self.tables.get(seq, ()))

    def project_write_pages(self, demands: Sequence[tuple]) -> list:
        """Non-mutating page-footprint projection for ordered write demands.

        ``demands`` is ``[(seq, n_tokens), ...]`` in the order the commit
        path will service them (prefills before appends, stream order within
        each — the same order :meth:`cycle` grows tables in). Returns one
        ``frozenset`` of touched page ids per demand: the partially-filled
        tail page plus any pages the demand would pop from the sequence's
        home-shard free list (simulated against a copy, so table, length and
        free-list state are untouched). Exact because eviction's
        :meth:`free` has already run by the time the scheduler projects —
        the free lists the simulation copies are the ones the commit pops
        from. A demand that would exhaust its simulated free list stops
        popping (the real commit's capacity precheck raises first, before
        any traversal issues).

        Share-aware: a demand whose tail page is SHARED (refcount > 1)
        projects the fresh page its copy-on-write will carve — from the
        FRONT of the free list, mirroring :meth:`_cow_prepare` — and NOT
        the shared page, so the scheduler sees the PHYSICAL write
        footprint: shared pages are read-shared/write-private, and their
        readers co-schedule with the CoW writer hazard-free."""
        sim_free = [list(fl) for fl in self.free_by_shard]
        sim_table: dict = {}
        sim_len: dict = {}
        out = []
        for seq, t in demands:
            table = sim_table.setdefault(seq, list(self.tables.get(seq, ())))
            length = sim_len.setdefault(seq, self.lengths.get(seq, 0))
            # idempotent: the engine pre-assigns homes at admission, so this
            # only reads (and matches the shard the commit path will pop)
            shard = self.assign_home(seq)
            pages = set()
            off = length % self.page_tokens
            idx = length // self.page_tokens
            if (t and off and idx < len(table)
                    and self.refcounts.get(table[idx], 1) > 1
                    and sim_free[shard]):
                p = sim_free[shard].pop(0)
                table[idx] = p
                pages.add(p)
            need = -(-(length + t) // self.page_tokens)
            while len(table) < need and sim_free[shard]:
                p = sim_free[shard].pop()
                table.append(p)
                pages.add(p)
            lo = length // self.page_tokens
            hi = min(need, len(table))
            pages.update(table[lo:hi])
            sim_len[seq] = length + t
            out.append(frozenset(pages))
        return out

    # ---- data plane: one macro-cycle -----------------------------------------
    def cycle(self, *, append: Stream = None, read: Stream = None,
              prefill: Stream = None,
              scrub: Optional[Sequence[int]] = None,
              priority: Optional[Sequence[int]] = None) -> dict:
        """Service up to four logical streams in ONE pool traversal.

        append:  {"seq": int, "vectors": [T, W]} or list — decode appends
        read:    {"seq": int, "positions": int array} or list — attn gathers
        prefill: {"seq": int, "vectors": [T, W]} or list — bulk prompt fills
        scrub:   page ids to zero (port D — eviction)
        priority: full port-priority permutation for THIS traversal (the
                  schedule's per-cycle decision); defaults to the legacy
                  fixed service order ``_PRIORITY``.
        Returns {"read": [Q, W] | list thereof | None} mirroring the input
        shape of ``read``.

        A sharded pool (a mesh of more than one shard) services the
        traversal on every shard, each over its own address window, and
        sums the read lanes — still ONE traversal of (now distributed)
        storage.
        """
        read_was_dict = isinstance(read, dict)
        appends = self._as_streams(append)
        reads = self._as_streams(read)
        prefills = self._as_streams(prefill)
        scrub = list(scrub) if scrub else []
        priority = _PRIORITY if priority is None else tuple(priority)

        # program order: bulk prefills grow tables before decode appends,
        # matching the scheduler's footprint projection
        self._check_capacity(prefills + appends, reads)

        # copy-on-write remaps commit here (prefills before appends, the
        # projection's order): each shared tail page a write stream would
        # touch is replaced by a fresh home-shard page whose live words
        # ride the SAME traversal's W port as extra lanes
        cow_fill = [c for c in (self._cow_prepare(s["seq"],
                                                  int(s["vectors"].shape[0]))
                                for s in prefills) if c is not None]
        cow_app = [c for c in (self._cow_prepare(s["seq"],
                                                 int(s["vectors"].shape[0]))
                               for s in appends) if c is not None]

        lanes = [0, 0, 0, 0]
        lanes[APPEND] = (sum(s["vectors"].shape[0] for s in appends)
                         + sum(len(o) for o, _ in cow_app))
        lanes[ATTN_READ] = sum(len(s["positions"]) for s in reads)
        lanes[BULK_FILL] = (sum(s["vectors"].shape[0] for s in prefills)
                            + sum(len(o) for o, _ in cow_fill))
        lanes[SCRUB] = len(scrub) * self.page_tokens
        if not any(lanes):
            # no traffic: still mirror the read input shape (one result per
            # stream) so stream->result pairing survives empty gathers
            if not reads:
                return {"read": None}
            empty = torch.zeros((0, self.io_width), dtype=self.spec.dtype,
                                device=self.device)
            return {"read": empty if read_was_dict
                    else [empty for _ in reads]}
        q = _bucket(max(lanes))

        with span("staging.pool"):
            dev = self.device
            reqs = [empty_request(q, self.spec.word_width, self.spec.dtype,
                                  dev) for _ in range(4)]

            def _dev(a: np.ndarray, dtype=None) -> torch.Tensor:
                self.h2d_bytes += a.nbytes
                t = torch.from_numpy(a)
                return t.to(device=dev, dtype=dtype if dtype is not None
                            else t.dtype)
            w_tiles: set = set()           # distinct W-port tiles this cycle
            r_tiles: set = set()           # distinct R-port tiles this cycle

            def _write_req(streams, cow=()):
                addr = np.zeros(q, np.int32)
                data = np.zeros((q, self.spec.word_width), np.float32)
                mask = np.zeros(q, bool)
                at = 0
                for old, new in cow:
                    # CoW copy lanes: the shared page's live words, gathered
                    # host-side (it cannot be a ported read — the copy must
                    # land in the same traversal), written to the fresh page.
                    # Disjoint from the stream's own words (those start at
                    # the copied offset), so lane order never matters.
                    vals = self._to_host(self._read_words(old))
                    n = len(new)
                    addr[at:at + n] = new
                    data[at:at + n] = vals
                    mask[at:at + n] = True
                    at += n
                for s in streams:
                    seq, vec = s["seq"], np.asarray(s["vectors"], np.float32)
                    t = vec.shape[0]
                    self._ensure_capacity(seq, t)
                    idx = np.arange(self.lengths[seq], self.lengths[seq] + t)
                    addr[at:at + t] = self._addr(seq, idx)
                    data[at:at + t, :vec.shape[1]] = vec  # pad lanes stay 0
                    mask[at:at + t] = True
                    self.lengths[seq] += t
                    at += t
                w_tiles.update(np.unique(addr[:at] // self.seq_tile).tolist())
                return PortRequest(addr=_dev(addr),
                                   data=_dev(data, self.spec.dtype),
                                   mask=_dev(mask))

            if prefills:
                reqs[BULK_FILL] = _write_req(prefills, cow_fill)
            if appends:
                reqs[APPEND] = _write_req(appends, cow_app)
            if scrub:
                addr = np.zeros(q, np.int32)
                mask = np.zeros(q, bool)
                words = (np.asarray(scrub)[:, None] * self.page_tokens
                         + np.arange(self.page_tokens)[None, :]).reshape(-1)
                addr[: len(words)] = words
                mask[: len(words)] = True
                w_tiles.update(np.unique(words // self.seq_tile).tolist())
                reqs[SCRUB] = PortRequest(
                    addr=_dev(addr),
                    data=torch.zeros((q, self.spec.word_width),
                                     dtype=self.spec.dtype, device=dev),
                    mask=_dev(mask))
            slices = []
            if reads:
                addr = np.zeros(q, np.int32)
                mask = np.zeros(q, bool)
                at = 0
                for s in reads:
                    pos = np.asarray(s["positions"])
                    addr[at:at + len(pos)] = self._addr(s["seq"], pos)
                    mask[at:at + len(pos)] = True
                    slices.append((at, at + len(pos)))
                    at += len(pos)
                r_tiles.update(np.unique(addr[:at] // self.seq_tile).tolist())
                reqs[ATTN_READ] = PortRequest(
                    addr=_dev(addr),
                    data=torch.zeros((q, self.spec.word_width),
                                     dtype=self.spec.dtype, device=dev),
                    mask=_dev(mask))

        cfg = PortConfig(enabled=(bool(appends), bool(reads), bool(prefills),
                                  bool(scrub)),
                         roles=_ROLES, priority=priority)
        self.mix_counts[cfg.describe()] = self.mix_counts.get(
            cfg.describe(), 0) + 1
        with span("pool.step"):
            if self.sharded:
                self.storage, out = _sharded_pool_step(
                    self.spec_local, cfg, self.storage, tuple(reqs),
                    wps=self.words_per_shard, use_kernel=self.use_kernel)
            else:
                self.storage, out = _pool_step(self.spec, cfg, self.storage,
                                               tuple(reqs),
                                               use_kernel=self.use_kernel)
        self.traversals += 1
        self.tile_writes += self._count_tiles(w_tiles,
                                              self.tile_writes_by_shard)
        self.tile_reads += self._count_tiles(r_tiles,
                                             self.tile_reads_by_shard)
        if not reads:
            return {"read": None}
        got = [out[ATTN_READ][a:b, :self.io_width] for a, b in slices]
        return {"read": got[0] if read_was_dict else got}

    def cycle_batch(self, groups: Sequence[tuple]) -> list:
        """Issue one macro-cycle's SCHEDULE of traversals: ``groups`` is an
        ordered sequence of ``(streams, priority)`` pairs — each ``streams``
        a dict of :meth:`cycle` keyword streams, each ``priority`` that
        traversal's full port permutation (or None for the legacy order).

        The capacity/read precheck is TRANSACTIONAL ACROSS THE WHOLE BATCH:
        every co-scheduled write (prefills then appends, group order) and
        every read is validated against simulated free lists BEFORE the
        first traversal commits, so a refused macro-cycle leaves the pool
        untouched even when the failing demand sits in a later traversal.
        The traversals then issue through :func:`repro_torch.core.fsm.walk_schedule`
        — the schedule-driven generalization of the old fixed walk — each
        with its own :class:`~repro_torch.core.PortConfig`. Returns one
        :meth:`cycle` result dict per group, in order."""
        from repro_torch.core import fsm

        groups = [(dict(streams), None if prio is None else tuple(prio))
                  for streams, prio in groups]
        writes: list = []
        reads: list = []
        for streams, _ in groups:
            writes += self._as_streams(streams.get("prefill"))
            writes += self._as_streams(streams.get("append"))
            reads += self._as_streams(streams.get("read"))
        if not groups:
            return []
        self._check_capacity(writes, reads)

        schedule = []
        for streams, prio in groups:
            cfg = PortConfig(
                enabled=(bool(streams.get("append")),
                         bool(streams.get("read")),
                         bool(streams.get("prefill")),
                         bool(streams.get("scrub"))),
                roles=_ROLES,
                priority=_PRIORITY if prio is None else prio)
            schedule.append((cfg, streams))

        def service(outs, streams, cfg):
            outs.append(self.cycle(priority=cfg.priority, **streams))
            return outs

        return fsm.walk_schedule(schedule, [], service)

    @staticmethod
    def _as_streams(stream: Stream) -> list:
        if stream is None:
            return []
        if isinstance(stream, dict):
            return [stream]
        return list(stream)

    @property
    def utilization(self) -> float:
        total = self.spec.num_words // self.page_tokens
        return 1.0 - self.free_page_count / total
