"""Multi-port serving engine: the paper's wrapper as a request scheduler
whose data plane IS a paged multi-port memory pool.

The engine's KV storage is not a dense per-slot buffer — it is allocated
from ONE physical :class:`~repro_torch.memory.paged_kv.PagedPool` (a word = one
token's K,V for every layer; sequences own pages through page tables, vLLM
style). Each engine macro-cycle (one external "CLK") walks the paper's FSM
(Fig. 2) over four logical ports, in priority order:

    port A (W, priority 1): EVICT    — free finished slots; freed pages are
                                       scrubbed through the pool's port D
    port B (W, priority 2): PREFILL  — admit queued requests and advance every
                                       mid-prefill slot by ONE fixed-size
                                       token chunk: chunks from different
                                       requests are stacked into one padded
                                       batch, run through a single chunked
                                       prefill step, and ALL chunks' K,V land
                                       as one bulk-write port transaction
                                       (pool port C)
    port C (R/W, priority 3): DECODE — one token for every active slot: the
                                       previous token's K,V append (pool
                                       port A) and this step's attention
                                       gathers (pool port B)
    port D (R, priority 4): STATUS   — scoreboard snapshot (lengths, slots)

Continuous batching: the slot table starts at ``slots`` entries and grows on
demand up to ``max_slots``. Both the decode batch and the prefill chunk
batch are padded to power-of-two buckets, so the staged shapes change only
at bucket boundaries, never per request. A request's FIRST generated
token comes from its prefill logits (the last valid position of its final
chunk) — decode never re-feeds
``prompt[-1]``, so each KV word lands in the pool exactly once.

The phase walk above COLLECTS traffic; how it commits is a per-cycle
PORT-MIX DECISION made by the dependency scheduler (``serve/scheduler.py``).
Each phase's page-granular footprint is projected against the post-eviction
free lists, and under the default ``schedule_mode="ooo"`` phases touching
DISJOINT pages co-schedule into the SAME pool traversal (e.g. prefill W
ports alongside decode W+R ports — any validated 1-4 port mix), while
RAW/WAR overlaps split conservatively and WAW overlaps share a traversal
under program-order priority (eviction's scrub serviced before a write
reusing the freed page). ``schedule_mode="static"`` keeps the rigid walk as
the oracle: one traversal per phase, never co-scheduled. ``max_ports``
(1-4, the paper's B1B0 knob) caps a traversal's port count; a 1-port
budget also degrades the COMPUTE to the two-pass oracle
(``compute_port_mix="w+r"``) since the fused kernels' 1W+1R contract is no
longer schedulable. ``coschedule_frac`` / ``schedule_log`` expose the
decisions; ``PagedPool.mix_counts`` histograms the traversal mixes served.

In the default ``kernel_mode="pallas"`` a decode macro-cycle's traffic is
ONE physical pool traversal (``PagedPool.cycle`` services the scheduled
ports in the schedule's priority order with same-cycle W->R visibility,
through the hand-written pool-step kernel), and the decode compute services
all active slots through the fused append+attend kernel
(``kernels/kv_multiport``) — one traversal for the W and R ports, claim C1
end-to-end. ``kernel_mode="reference"`` keeps the oracle ``core.step``
under the pool and two-pass (append-traversal then read-traversal) port
transactions. ``single_port=True`` additionally services ONE engine port
per macro-cycle (the paper's bare-macro comparison).

Traversals are LENGTH-BOUNDED (``length_bound=True``, pallas mode): each
row of the fused kernels services only its own live ``seq_tile`` tiles.
With ``dynamic_grid=True`` (default) the staging caches keep ONE shape —
the padded full capacity; ``dynamic_grid=False`` stages the batch's live
length rounded up to a power-of-two count of tiles (the ladder launchers
validate ``--seq-tile`` against via ``final_stage_ladder``).
``decode_tile_reads`` / ``prefill_tile_reads`` count the tiles touched;
``steady_decode_tile_bound`` is the ideal ``ceil((cache_len+1)/seq_tile)``
budget.

**Async host loop**: host-side admission/scheduling is decoupled from
device macro-cycles. Admission lives in its own
:class:`~repro_torch.serve.admission.AdmissionQueue` (arrival-ordered FIFO),
and ``step()`` is a two-stage software pipeline: the decode compute of
macro-cycle N is LAUNCHED on the device's stream but not waited for, and its
results are RETIRED at the start of macro-cycle N+1 — the device-to-host
copy of the new tokens and KV words is the sync point — after the host has
already made the next cycle's admission decisions. Staging buffers are
DOUBLE-BUFFERED host buffers (pinned on CUDA, copied to the device with
``non_blocking=True``): filling cycle N+1's stage never overwrites the
buffer cycle N's copy may still be reading, and the tensor handed to the
model is always a device copy, never a view of the host buffer (the fused
kernels update their caches in place). State evolution is bit-identical to
a synchronous loop; ``flush()`` retires a trailing in-flight cycle and
``run()`` calls it.

**Virtual clock**: ``vclock`` counts POOL TRAVERSALS (one tick = one
physical pool traversal; a macro-cycle that commits none — idle/status
only — costs one tick). Latency is measured against this clock, so SLO
numbers are deterministic on CI and directly reflect what the paper
prices: a scheduler spending more traversals per macro-cycle burns more
ticks for the same work. Requests carry arrival/admit/first-token/finish
stamps in both ticks and macro-cycles (plus opt-in wall-clock
timestamps); ``slot_contention_cycles`` counts cycles where a ready
arrival waited on a full slot table and ``evict_pressure_admissions``
counts admissions that only proceeded because a slot was freed that same
cycle — the open-loop bench (``benchmarks/serve_bench.py``) turns these
into TTFT/per-token percentiles, goodput, and queue-depth curves.

"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import fsm
from repro_torch.core.clockgen import build_schedule
from repro_torch.core.ports import MAX_PORTS, READ, WRITE, PortConfig
from repro_torch.kernels.tiling import fit_seq_tile
from repro_torch.memory.paged_kv import (APPEND, ATTN_READ, BULK_FILL, SCRUB,
                                         PagedPool, PoolCapacityError,
                                         _bucket, seq_tile_buckets)
from repro_torch.models import KV_FAMILIES, decode_step, prefill_chunk
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.admission import (AdmissionQueue, OverloadController,
                                         prefix_admission_plan)
from repro_torch.serve.scheduler import PhaseTxn, PortTxn

EVICT, PREFILL, DECODE, STATUS = 0, 1, 2, 3

# pool-port stream keyword for each physical port a scheduled transaction
# can issue on (the engine's phase -> pool-port wiring)
_STREAM_KEY = {SCRUB: "scrub", BULK_FILL: "prefill",
               APPEND: "append", ATTN_READ: "read"}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    # open-loop latency stamps (virtual-clock ticks = pool traversals, plus
    # the macro-cycle index; wall-clock seconds recorded alongside as the
    # opt-in column — never the deterministic gate)
    arrival_tick: float = 0.0
    arrival_cycle: int = 0
    # overload-safety state: an optional absolute admission deadline
    # (arrival + TTL, virtual ticks — expired heads are shed, never
    # admitted), why/when the request was shed (None = served), how many
    # cycles it was parked retrying a full home shard, and whether a chaos
    # fault cancelled it mid-stream (cancelled/shed requests are excluded
    # from the survivor token-identity checks)
    deadline_tick: Optional[float] = None
    shed_reason: Optional[str] = None
    shed_tick: Optional[int] = None
    capacity_retries: int = 0
    cancelled: bool = False
    admit_tick: Optional[int] = None
    admit_cycle: Optional[int] = None
    first_token_tick: Optional[int] = None
    first_token_cycle: Optional[int] = None
    finish_tick: Optional[int] = None
    finish_cycle: Optional[int] = None
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_finish: Optional[float] = None

    @property
    def ttft_ticks(self) -> Optional[float]:
        """Time to first token in virtual ticks (None until it exists)."""
        if self.first_token_tick is None:
            return None
        return self.first_token_tick - self.arrival_tick

    @property
    def tpot_ticks(self) -> Optional[float]:
        """Per-token decode latency in virtual ticks — the mean tick cost
        of tokens AFTER the first; None until finished or for single-token
        requests (which never enter decode)."""
        if self.finish_tick is None or self.first_token_tick is None:
            return None
        if len(self.generated) < 2:
            return None
        return ((self.finish_tick - self.first_token_tick)
                / (len(self.generated) - 1))


@dataclasses.dataclass
class _PrefillState:
    """A slot mid-prefill: chunks consumed so far + the staged K,V of those
    chunks (the chunk compute's running cache; the pool stays the decode-side
    source of truth)."""
    consumed: int
    stage_k: np.ndarray                 # [L, max_len, Hkv, D]
    stage_v: np.ndarray


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unretired decode macro-cycle: the launched step's
    device results (not yet copied back) plus the host metadata needed to
    retire them. Created at the end of ``step()``, consumed at the START of
    the next ``step()`` (or by ``flush()``), so the device executes cycle N
    while the host plans cycle N+1."""
    cycle: int                     # macro-cycle index the work belongs to
    vclock_end: int                # virtual clock after that cycle's commit
    active: list                   # slots the decode step served
    row_of: dict                   # slot -> staged batch row
    lens: np.ndarray               # per-row pre-append cache lengths
    state: dict                    # device outputs (cache_k/cache_v)
    logits: object                 # device next-token logits
    rids: dict = dataclasses.field(default_factory=dict)
                                   # slot -> rid at dispatch time: retirement
                                   # skips rows whose slot was reassigned
                                   # while the dispatch was outstanding
                                   # (possible when a chaos stall lets
                                   # evict/admit run between dispatch and
                                   # retire)


class _DoubleBuffer:
    """Two alternating preallocated host staging buffers per key (pinned
    when the engine runs on CUDA): the in-flight cycle's copy source is
    never overwritten by the next cycle's fill, and the hot loop stops
    paying a fresh allocation per cycle. ``get`` returns the zeroed buffer
    as a numpy view to fill; :meth:`to_device` makes the device copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: dict = {}

    def get(self, key, shape) -> np.ndarray:
        slot = self._bufs.setdefault(key, [None, None, 0])
        idx = slot[2]
        slot[2] ^= 1
        buf = slot[idx]
        if buf is None or tuple(buf.shape) != tuple(shape):
            buf = torch.zeros(shape, dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
            slot[idx] = buf
        else:
            buf.zero_()
        return buf.numpy()

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a filled buffer — never a view of it."""
        t = torch.from_numpy(arr)
        if self.device.type == "cpu":
            return t.clone()
        return t.to(self.device, non_blocking=True)


class MultiPortEngine:
    def __init__(self, params, cfg: ArchConfig, *, slots: int = 4,
                 max_slots: Optional[int] = None, max_len: int = 256,
                 prefill_bucket: int = 32, chunk_tokens: Optional[int] = None,
                 kernel_mode: str = "pallas", single_port: bool = False,
                 greedy: bool = True, page_tokens: int = 8,
                 seq_tile: int = 128, length_bound: bool = True,
                 dynamic_grid: bool = True, num_kv_splits: int = 1,
                 schedule_mode: str = "ooo", max_ports: int = MAX_PORTS,
                 max_queue_depth: Optional[int] = None,
                 default_ttl_ticks: Optional[float] = None,
                 capacity_retry_limit: int = 16,
                 overload: Optional[OverloadController] = None,
                 prefix_cache: bool = False, device="cuda"):
        if cfg.family not in KV_FAMILIES:
            raise ValueError("engine currently serves KV-cache families")
        self.device = _device.resolve(device)
        if kernel_mode not in ("pallas", "reference"):
            raise ValueError(f"unknown kernel_mode: {kernel_mode!r}")
        if schedule_mode not in ("static", "ooo"):
            raise ValueError(f"unknown schedule_mode: {schedule_mode!r}")
        if not 1 <= max_ports <= MAX_PORTS:
            raise ValueError(
                f"max_ports must be in 1..{MAX_PORTS}, got {max_ports}")
        if seq_tile < 1:
            raise ValueError(f"seq_tile must be >= 1, got {seq_tile}")
        if num_kv_splits < 1:
            raise ValueError(
                f"num_kv_splits must be >= 1, got {num_kv_splits}")
        self.params, self.cfg = params, cfg
        # per-cycle port-mix scheduling (see serve/scheduler.py): "ooo"
        # packs non-hazarding phases into shared pool traversals; "static"
        # keeps the rigid one-traversal-per-phase walk as the oracle
        self.schedule_mode = schedule_mode
        self.max_ports = max_ports
        # compute-side port-mix decision: a 1-port budget cannot schedule
        # the fused kernels' 1W+1R traversal, so the attention compute
        # degrades to the two-pass (W traversal, then R traversal) oracle
        self.compute_port_mix = "wr" if max_ports >= 2 else "w+r"
        self._fused_compute = (kernel_mode == "pallas"
                               and self.compute_port_mix == "wr")
        # pool-side two-pass discipline: the reference engine and the bare
        # macro split every traversal into writes-then-reads
        self._split_roles = (kernel_mode != "pallas") or single_port
        self.max_slots = slots if max_slots is None else max_slots
        if self.max_slots < slots:
            raise ValueError(f"max_slots ({self.max_slots}) < slots ({slots})")
        self._init_slots = slots
        self.max_len = max_len
        # chunked prefill: admissions advance chunk_tokens per macro-cycle
        self.chunk_tokens = chunk_tokens or prefill_bucket
        self.kernel_mode = kernel_mode
        self.single_port = single_port
        # length-bounded traversals: the fused kernels service each row's
        # live seq_tile tiles only. The stage-length ladder is the one
        # launch/serve validates --seq-tile against; every entry is a whole
        # number of tiles (the last padded past max_len if needed) so the
        # kernels never fall back to degenerate fit-down tile sizes.
        self.seq_tile = min(seq_tile, max_len)
        self.length_bound = length_bound
        # dynamic-grid traversal (pallas + length_bound): the staging caches
        # always cover the full padded capacity and each kernel row bounds
        # its own traversal by its runtime length — ONE staged shape for
        # every cache length. dynamic_grid=False stages a bucketed live
        # prefix instead.
        self.dynamic_grid = (dynamic_grid and self._fused_compute
                             and length_bound)
        # split-KV decode: each row's decode traversal runs as
        # num_kv_splits grid-parallel partial-softmax chains plus one
        # combine — only meaningful on the fused compute (the two-pass
        # reference has no traversal to split)
        self.num_kv_splits = num_kv_splits if self._fused_compute else 1
        self._stage_buckets = self.final_stage_ladder(max_len, seq_tile)
        self.stage_lens_seen: set = set()
        # padded batch rows carry the fused kernels' dead-row sentinel
        # (cache_len/offset -1: zero tiles serviced) so tile accounting
        # stays exact under padding; the two-pass compute (reference, or a
        # pallas engine degraded to a 1-port compute budget) keeps 0 — its
        # dense read needs finite positions
        self._dead_row = -1 if self._fused_compute else 0

        # physical pool: word = one token's (K, V) across all layers, sized
        # for the FULL grown slot table
        self._kv_dims = (cfg.n_layers, 2, cfg.n_kv_heads, cfg.head_dim_)
        word_width = int(np.prod(self._kv_dims))
        n_pages = self.max_slots * (-(-max_len // page_tokens))
        self.pool = PagedPool.create(
            n_pages=n_pages, page_tokens=page_tokens, word_width=word_width,
            dtype=torch.float32, use_kernel=(kernel_mode == "pallas"),
            seq_tile=self.seq_tile, device=self.device)

        self.slot_req: list[Optional[Request]] = [None] * slots
        self.slot_len: list[int] = [0] * slots      # tokens committed to pool
        self._pending: dict[int, np.ndarray] = {}   # slot -> KV word to append
        self._prefilling: dict[int, _PrefillState] = {}
        # host-side admission: arrival-ordered FIFO, decoupled from the
        # device macro-cycle (see serve/admission.py); bounded when the
        # caller sets max_queue_depth (overload safety: explicit rejection
        # beats unbounded queue delay)
        self.admission = AdmissionQueue(max_depth=max_queue_depth)
        # overload-safe serving state: the default admission TTL stamped on
        # submissions (deadline = arrival + TTL, virtual ticks), the
        # capacity-retry budget for a head parked on a full home shard, the
        # optional graceful-degradation controller, and the shed record
        if capacity_retry_limit < 1:
            raise ValueError(
                f"capacity_retry_limit must be >= 1, got "
                f"{capacity_retry_limit}")
        self.default_ttl_ticks = default_ttl_ticks
        self.capacity_retry_limit = capacity_retry_limit
        self.overload = overload
        # refcounted prefix caching: admission matches each prompt against
        # the pool's content-addressed prefix index BEFORE the capacity
        # precheck (matched pages attach by refcount bump; only the
        # unmatched tail counts as demand and prefill compute), and every
        # completed prefill registers its prompt pages for future matches.
        # Default OFF: the oracle engines stay bit-identical to exclusive
        # ownership — with it ON, greedy tokens are still identical (the
        # adopted words are the words prefill would have recomputed).
        self.prefix_cache = prefix_cache
        self.shed: list[Request] = []       # all shed requests, any reason
        self.shed_deadline = 0              # expired before admission
        self.shed_queue_full = 0            # rejected by the bounded queue
        self.shed_capacity = 0              # capacity-retry budget exhausted
        self.capacity_parked_cycles = 0     # cycles a head waited on pages
        self.capacity_recoveries = 0        # parked heads later admitted
        self.cancelled = 0                  # chaos mid-stream cancellations
        # chaos delayed-retirement state: cycles the in-flight decode must
        # stay unretired (the host keeps admitting/prefilling/evicting but
        # cannot dispatch new decode work until the stall drains)
        self.retire_stall_cycles = 0
        self.stalled_retirements = 0
        self.finished: list[Request] = []
        self.cycles = 0
        # virtual clock: pool traversals + idle macro-cycles (1 tick each);
        # all latency stamps are measured against this
        self.idle_ticks = 0
        # open-loop pressure counters: cycles where a ready arrival waited
        # on a full slot table, and admissions that only went through
        # because an eviction freed their slot that same cycle
        self.slot_contention_cycles = 0
        self.evict_pressure_admissions = 0
        self.evictions = 0
        # async pipeline state: the dispatched-but-unretired decode cycle,
        # double-buffered staging, and this cycle's stamp/bookkeeping sets
        self._inflight: Optional[_InFlight] = None
        self._stage_bufs = _DoubleBuffer(self.device)
        self._freed_slots_this_cycle: set = set()
        # prompts whose prefill completed this cycle, registered into the
        # pool's prefix index after the cycle's traversals commit
        self._register_pending: list = []
        self._token_events: list[Request] = []
        self.decode_steps = 0           # macro-cycles that carried decode traffic
        self.decode_traversals = 0      # pool traversals those cycles needed
        # steady state = decode cycles carrying both an append and a read
        # (a slot's FIRST decode has no pending append yet)
        self.steady_decode_steps = 0
        self.steady_decode_traversals = 0
        self.prefill_steps = 0          # macro-cycles that carried chunk traffic
        self.prefill_traversals = 0     # pool traversals those cycles needed
        self.prefill_tokens = 0         # prompt tokens committed to the pool
        self.prefill_chunks = 0         # per-slot chunk computations
        # tile accounting: seq_tile-sized staging-cache tiles the attention
        # kernels' R ports touch (per slot per layer-normalized traversal)
        self.decode_tile_reads = 0
        self.steady_decode_tile_reads = 0
        self.steady_decode_tile_bound = 0   # sum of ceil((len+1)/seq_tile)
        # critical-path chain: per step, the longest single dependent
        # accumulation chain (longest row's tiles; / num_kv_splits + 1
        # under split-KV) — the steady-step LATENCY proxy the bench's
        # split-speedup gate reads, vs tile_reads' total-traffic proxy
        self.decode_critical_tiles = 0
        self.steady_decode_critical_tiles = 0
        self.prefill_tile_reads = 0
        self.port_log: list[tuple[int, ...]] = []
        # per-cycle schedule observability: which phases shared which pool
        # traversal (one tuple of phase-id tuples per cycle), how many
        # cycles carried >1 pool phase, and how many of those the scheduler
        # packed into a shared traversal
        self.schedule_log: list[tuple] = []
        self.multi_phase_cycles = 0
        self.coscheduled_cycles = 0
        self._next_rid = 0
        self._sp_rotate = 0

        attn_mode = "multiport" if kernel_mode == "pallas" else "reference"
        pmix = self.compute_port_mix
        tile, dyn = self.seq_tile, self.dynamic_grid
        nsp = self.num_kv_splits
        self._decode = (
            lambda p, s, b: decode_step(p, cfg, s, b, kernel_mode=attn_mode,
                                        seq_tile=tile,
                                        length_mask=length_bound,
                                        dynamic_grid=dyn,
                                        num_kv_splits=nsp, port_mix=pmix))
        self._prefill_chunk = (
            lambda p, s, b: prefill_chunk(p, cfg, s, b, kernel_mode=attn_mode,
                                          seq_tile=tile, dynamic_grid=dyn,
                                          port_mix=pmix))

    # ---- client API --------------------------------------------------------
    @classmethod
    def final_stage_ladder(cls, max_len: int, seq_tile: int) -> tuple:
        """The stage-length ladder the engine uses for its whole lifetime,
        slot growth to ``max_slots`` included — the surface ``--seq-tile``
        must be validated against. The ladder's geometry inputs (max_len,
        CLAMPED seq_tile) are growth-invariant, so the final ladder is
        computable up front; but a launcher that hand-rolls the startup
        ladder instead of calling THIS silently diverges from the engine
        the moment the clamp or bucketing changes (the validation bug this
        replaces: raw ``seq_tile_buckets(max_len, seq_tile)`` skipped the
        engine's ``seq_tile = min(seq_tile, max_len)`` clamp)."""
        if seq_tile < 1:
            raise ValueError(f"seq_tile must be >= 1, got {seq_tile}")
        return seq_tile_buckets(max_len, min(seq_tile, max_len))

    @property
    def n_slots(self) -> int:
        """Current slot-table size (grows on demand up to ``max_slots``)."""
        return len(self.slot_req)

    def submit(self, prompt: list[int], max_new: int = 16,
               arrival_tick: Optional[float] = None,
               ttl_ticks: Optional[float] = None) -> Request:
        """Enqueue a request and return it (latency stamps land on the
        returned object as the request moves through admission/serving).
        ``arrival_tick`` is its open-loop arrival time on the virtual
        clock; omitted (closed loop) it arrives NOW, so it is immediately
        admissible — the pre-harness behavior. ``ttl_ticks`` (default: the
        engine's ``default_ttl_ticks``) sets an admission deadline of
        ``arrival + ttl`` on the virtual clock: a request whose deadline
        passes while it is still queued is SHED, never admitted. When a
        ``max_queue_depth`` bound is set and the queue is full, the
        request is shed immediately (``shed_reason == "queue_full"``) —
        callers must check ``req.shed_reason`` rather than assume
        enqueue."""
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"max_len ({self.max_len})")
        if not prompt:
            raise ValueError("empty prompt")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(
            rid, list(prompt), max_new,
            arrival_tick=(self.vclock if arrival_tick is None
                          else arrival_tick),
            arrival_cycle=self.cycles, t_submit=time.perf_counter())
        ttl = self.default_ttl_ticks if ttl_ticks is None else ttl_ticks
        if ttl is not None:
            if ttl <= 0:
                raise ValueError(f"ttl_ticks must be > 0, got {ttl}")
            req.deadline_tick = req.arrival_tick + ttl
        if not self.admission.push(req):
            self._shed(req, "queue_full")
        return req

    def _shed(self, req: Request, reason: str) -> None:
        """Record a load-shedding decision: stamp the request with why and
        when (virtual tick) it was dropped and bump the per-reason
        counter. Shed requests never occupy a slot, a page, or a pool
        traversal past this point."""
        req.shed_reason = reason
        req.shed_tick = self.vclock
        self.shed.append(req)
        if reason == "deadline":
            self.shed_deadline += 1
        elif reason == "queue_full":
            self.shed_queue_full += 1
        elif reason == "capacity":
            self.shed_capacity += 1
        else:
            raise ValueError(f"unknown shed reason: {reason!r}")

    def cancel(self, rid: int) -> bool:
        """Cancel a request mid-stream: mark it done so the next EVICT
        phase frees its slot and scrubs its pages through the pool's
        normal port-D path (no bespoke teardown — cancellation IS an
        eviction). The request lands in ``finished`` flagged
        ``cancelled=True`` so token-identity checks exclude it. Returns
        False when ``rid`` is not live in a slot (already finished,
        queued, or unknown)."""
        for r in self.slot_req:
            if r is not None and r.rid == rid and not r.done:
                r.cancelled = True
                r.done = True
                self.cancelled += 1
                return True
        return False

    def stall_retirement(self, cycles: int) -> None:
        """Chaos hook: delay retirement of the async-dispatched decode by
        ``cycles`` macro-cycles. While stalled the engine keeps evicting,
        admitting and prefilling, but the in-flight decode is neither
        forced nor is new decode work dispatched (per-slot decode compute
        is independent, so the stall is token-identical — only WHEN
        results are folded back moves)."""
        if cycles < 1:
            raise ValueError(f"cycles must be >= 1, got {cycles}")
        self.retire_stall_cycles += cycles

    def pending_work(self) -> bool:
        return bool(self.admission) or any(r is not None
                                           for r in self.slot_req)

    @property
    def vclock(self) -> int:
        """Virtual-clock ticks elapsed: one per pool traversal, plus one
        per idle macro-cycle — the deterministic time base every latency
        stamp and SLO gate is measured in."""
        return self.pool.traversals + self.idle_ticks

    def advance_idle(self, ticks: int) -> None:
        """Fast-forward the virtual clock through a known-idle stretch
        (the open-loop driver calls this instead of spinning status-only
        macro-cycles while waiting for the next scheduled arrival)."""
        if ticks < 0:
            raise ValueError(f"ticks must be >= 0, got {ticks}")
        self.idle_ticks += ticks

    @property
    def has_inflight(self) -> bool:
        """True while a dispatched decode macro-cycle awaits retirement."""
        return self._inflight is not None

    def flush(self) -> None:
        """Retire a trailing in-flight decode cycle (forces its device
        results). ``run()`` calls this; drivers that step manually must
        too before reading final per-request state."""
        if self._inflight is not None:
            self._retire(self._inflight)
            self._inflight = None

    @property
    def pool_traversals(self) -> int:
        return self.pool.traversals

    @property
    def prefix_stats(self) -> dict:
        """Prefix-cache observability: index lookups/hits at admission,
        tokens and pages adopted without recompute, and the copy-on-write
        traffic those adoptions later cost. All zero with
        ``prefix_cache=False``."""
        p = self.pool
        return {"lookups": p.prefix_lookups, "hits": p.prefix_hits,
                "attached_tokens": p.prefix_attached_tokens,
                "attached_pages": p.prefix_attached_pages,
                "cow_copies": p.cow_copies, "cow_words": p.cow_words}

    @property
    def coschedule_frac(self) -> float:
        """Fraction of multi-phase macro-cycles (cycles whose pool traffic
        spans >1 engine phase) the scheduler packed into a shared traversal
        — 0.0 before any multi-phase cycle ran, and always 0.0 under
        ``schedule_mode="static"``."""
        if not self.multi_phase_cycles:
            return 0.0
        return self.coscheduled_cycles / self.multi_phase_cycles

    # ---- port collection routines -------------------------------------------
    def _free_slot(self) -> Optional[int]:
        """Lowest free slot index; grows the slot table (bounded by
        ``max_slots``) when every existing slot is occupied."""
        slot = next((i for i, r in enumerate(self.slot_req) if r is None),
                    None)
        if slot is None and len(self.slot_req) < self.max_slots:
            self.slot_req.append(None)
            self.slot_len.append(0)
            slot = len(self.slot_req) - 1
        return slot

    def _port_enables(self) -> PortConfig:
        finished = any(r is not None and r.done for r in self.slot_req)
        can_place = (any(r is None for r in self.slot_req)
                     or len(self.slot_req) < self.max_slots)
        admit = ((self.admission.head_ready(self.vclock) and can_place)
                 or bool(self._prefilling))
        active = any(r is not None and not r.done and i not in self._prefilling
                     for i, r in enumerate(self.slot_req))
        enabled = (finished, admit, active, True)
        if not any(enabled[:3]):
            enabled = (False, False, False, True)
        return PortConfig(enabled=enabled,
                          roles=(WRITE, WRITE, WRITE, READ))

    def _collect_evict(self) -> list:
        """Port A: retire finished requests; return freed pool pages."""
        freed: list[int] = []
        for i, r in enumerate(self.slot_req):
            if r is not None and r.done:
                self.finished.append(r)
                freed.extend(self.pool.free(r.rid))
                self.slot_req[i] = None
                self.slot_len[i] = 0
                self._pending.pop(i, None)
                self._prefilling.pop(i, None)
                self.evictions += 1
                self._freed_slots_this_cycle.add(i)
        return freed

    def _stage_len(self, need: int) -> int:
        """Length-bounded staging-cache size for this cycle: the smallest
        ladder bucket (power-of-two counts of seq_tile tiles — see
        ``seq_tile_buckets``) covering ``need`` live tokens. Unbounded
        pallas stages the padded full capacity; the two-pass compute
        (reference, or a 1-port compute budget) stages max_len densely."""
        if not self._fused_compute:
            return self.max_len
        if self.dynamic_grid or not self.length_bound:
            # dynamic grid: ONE staged shape (the padded capacity) for every
            # cycle — each kernel row bounds its own traversal by its
            # length, so the ladder is out of the hot path entirely
            got = self._stage_buckets[-1]
        else:
            got = next((b for b in self._stage_buckets if b >= need),
                       self._stage_buckets[-1])
        self.stage_lens_seen.add(got)
        return got

    def _tiles_touched(self, needs: list, stage_s: int, bounded: bool,
                       splits: int = 1) -> tuple[int, int, int]:
        """(tiles the kernel's R port touches, ideal ceil-bound,
        critical-path chain) for one staged batch of live lengths against a
        ``stage_s``-long staging cache. Unbounded traversals touch every
        grid tile. The CRITICAL chain is the step's latency proxy: batch
        rows are grid-parallel, so a step takes as long as its longest
        single dependent accumulation chain — the longest row's tile
        count."""
        tile = fit_seq_tile(stage_s, self.seq_tile)
        grid = stage_s // tile
        if bounded and self.dynamic_grid and needs:
            grid = min(grid, max(1, max(-(-n // tile) for n in needs)))
        bound = sum(min(-(-n // tile), grid) for n in needs)
        touched = bound if bounded else grid * len(needs)
        critical = 0
        for n in needs:
            chain = min(-(-n // tile), grid) if bounded else grid
            if splits > 1:
                chain = -(-chain // splits) + 1       # + the combine
            critical = max(critical, chain)
        return touched, bound, critical

    def _kv_words(self, cache_k, cache_v, slot: int, t0: int, t1: int
                  ) -> np.ndarray:
        """Flatten cache positions [t0, t1) of one slot into pool words."""
        k = np.asarray(cache_k[:, slot, t0:t1], np.float32)   # [L, T, hkv, hd]
        v = np.asarray(cache_v[:, slot, t0:t1], np.float32)
        w = np.stack([k, v], axis=1)                          # [L, 2, T, ...]
        w = np.moveaxis(w, 2, 0)                              # [T, L, 2, ...]
        return w.reshape(t1 - t0, -1)

    def _reserved_pages_by_shard(self) -> list[int]:
        """Worst-case pages every LIVE slot may still carve from its home
        shard: a request commits at most ``len(prompt) + max_new - 1``
        words (the final token's KV never lands — eviction precedes its
        append), so its outstanding claim is that ceiling minus the pages
        it already holds. The admission precheck (and the chaos harness's
        quarantine floor) subtracts these reservations from the free
        lists, so admitting a new request — or quarantining pages — can
        never strand a request that was already admitted."""
        reserved = [0] * self.pool.kv_shards
        pt = self.pool.page_tokens
        for r in self.slot_req:
            if r is None:
                continue
            worst = len(r.prompt) + r.max_new - 1
            held = len(self.pool.tables.get(r.rid, ()))
            # a shared tail page is write-private: the next append will
            # copy-on-write it, carving one page beyond plain table growth
            need = (max(0, -(-worst // pt) - held)
                    + self.pool.pending_cow_pages(r.rid))
            reserved[self.pool.assign_home(r.rid)] += need
        return reserved

    def _collect_prefill(self) -> list:
        """Port B: admit queued requests into free (or newly grown) slots,
        then advance EVERY mid-prefill slot by one fixed-size token chunk.
        Chunks from different requests are stacked into one padded batch, run
        through a single chunked-prefill compute step, and all chunks' K,V
        become streams of the SAME bulk-write port transaction."""
        nl, _, hkv, hd = self._kv_dims
        # arrival-ordered admission wave: only the QUEUE HEAD is ever
        # eligible (AdmissionQueue.pop_ready) — under slot contention a
        # freed slot goes to the oldest ready request, never a younger
        # shorter one (FIFO; no long-prompt starvation). Overload safety
        # wraps the same loop: a degraded controller caps admissions per
        # cycle, and each candidate head passes the pool's capacity
        # precheck BEFORE it is popped — a full home shard parks the head
        # (retry next cycle, after evictions free pages) instead of
        # raising mid-admission, and a head that exhausts its retry
        # budget is shed.
        now = self.vclock
        cap = self.overload.cap() if self.overload is not None else None
        admitted_now = 0
        reserved = None
        while self.admission.head_ready(now):
            if cap is not None and admitted_now >= cap:
                break
            head = self.admission.head()
            if reserved is None:
                reserved = self._reserved_pages_by_shard()
            # prefix-aware admission: match BEFORE the capacity precheck,
            # so matched pages (attachable by refcount bump) never count
            # as demand and the probe moves to the prefix's shard
            match, worst = prefix_admission_plan(
                self.pool, head.prompt, head.max_new,
                enabled=self.prefix_cache)
            try:
                shard = self.pool.admission_precheck(
                    head.rid, worst, reserved_by_shard=reserved,
                    prefix=match)
            except PoolCapacityError:
                if head.capacity_retries >= self.capacity_retry_limit:
                    # eviction-aware backoff exhausted: shed (drop_head
                    # keeps the admitted counter honest)
                    self.admission.drop_head()
                    self._shed(head, "capacity")
                    continue
                head.capacity_retries += 1
                self.capacity_parked_cycles += 1
                break       # park: this cycle's evictions already ran,
                            # retry after the NEXT cycle frees pages
            slot = self._free_slot()
            if slot is None:
                # a ready arrival waited this cycle on a full slot table
                self.slot_contention_cycles += 1
                break
            req = self.admission.pop_ready(now)
            admitted_now += 1
            if req.capacity_retries:
                self.capacity_recoveries += 1
            full = match.full_pages if match is not None else 0
            reserved[shard] += max(
                0, -(-worst // self.pool.page_tokens) - full)
            req.slot = slot
            req.admit_cycle = self.cycles
            req.admit_tick = now
            if slot in self._freed_slots_this_cycle:
                # admission only proceeded because this cycle's EVICT
                # phase freed the slot — eviction-pressure signal
                self.evict_pressure_admissions += 1
            if self.cfg.input_mode == "embeddings":
                raise NotImplementedError("engine demo serves token models")
            self.slot_req[slot] = req
            attached = 0
            if match is not None:
                # adopt the matched prefix by refcount bump: the request's
                # home FOLLOWS the shared pages' shard, its table starts at
                # the matched pages, and prefill resumes at the tail
                self.pool.attach_prefix(req.rid, match)
                attached = match.tokens
            # device-aware placement: the home shard is fixed at admission
            # (least-loaded, or the prefix's shard), BEFORE the first page
            # is carved, so the first chunk's compute can already be
            # grouped onto its device
            self.pool.assign_home(req.rid)
            self.slot_len[slot] = attached
            ps = _PrefillState(
                consumed=attached,
                stage_k=np.zeros((nl, self.max_len, hkv, hd), np.float32),
                stage_v=np.zeros((nl, self.max_len, hkv, hd), np.float32))
            if attached:
                # the chunk compute attends over the STAGED running cache,
                # not the pool — backfill the stage with the adopted words
                # (inverse of _kv_words) so the tail's attention sees the
                # prefix KV it never computed
                w = self.pool.gather_words(req.rid, np.arange(attached))
                w = w.reshape(attached, nl, 2, hkv, hd)
                ps.stage_k[:, :attached] = np.moveaxis(w[:, :, 0], 0, 1)
                ps.stage_v[:, :attached] = np.moveaxis(w[:, :, 1], 0, 1)
            self._prefilling[slot] = ps
        if not self._prefilling:
            return []

        # one padded chunk batch across all prefilling slots (batch dim
        # bucketed to a power of two); the chunk kernel services each row's
        # live tiles only
        order = sorted(self._prefilling)
        # a degraded overload controller shrinks the per-cycle chunk (the
        # generated tokens are unchanged — chunked prefill is chunk-size
        # invariant — only the per-cycle port-traffic shape moves)
        c = (self.overload.chunk_tokens(self.chunk_tokens)
             if self.overload is not None else self.chunk_tokens)
        nb = _bucket(len(order), lo=1)
        row_of = {s: j for j, s in enumerate(order)}
        need_of = {s: self._prefilling[s].consumed
                   + min(c, len(self.slot_req[s].prompt)
                         - self._prefilling[s].consumed) for s in order}
        stage_s = self._stage_len(max(need_of.values()))
        live = min(stage_s, self.max_len)   # last bucket may pad past max_len
        toks = np.zeros((nb, c), np.int32)
        clen = np.zeros((nb,), np.int32)
        offs = np.full((nb,), self._dead_row, np.int32)
        stage_k = self._stage_bufs.get(("prefill", "k"),
                                       (nl, nb, stage_s, hkv, hd))
        stage_v = self._stage_bufs.get(("prefill", "v"),
                                       (nl, nb, stage_s, hkv, hd))
        for slot in order:
            j = row_of[slot]
            ps = self._prefilling[slot]
            req = self.slot_req[slot]
            t0 = ps.consumed
            n = min(c, len(req.prompt) - t0)
            toks[j, :n] = req.prompt[t0:t0 + n]
            clen[j] = n
            offs[j] = t0
            stage_k[:, j, :live] = ps.stage_k[:, :live]
            stage_v[:, j, :live] = ps.stage_v[:, :live]

        dev = self.device
        state = {"len": torch.from_numpy(offs).to(dev),
                 "cache_k": self._stage_bufs.to_device(stage_k),
                 "cache_v": self._stage_bufs.to_device(stage_v)}
        st, logits = self._prefill_chunk(
            self.params, state, {"inputs": torch.from_numpy(toks).to(dev),
                                 "chunk_len": torch.from_numpy(clen).to(dev)})
        ck = st["cache_k"].cpu().numpy()
        cv = st["cache_v"].cpu().numpy()
        lg = logits.float().cpu().numpy()
        # the chunk kernel masks dead tiles per sequence; the reference
        # reads the whole staged cache densely per chunk
        touched, _, _ = self._tiles_touched(
            [need_of[s] for s in order], stage_s,
            bounded=self._fused_compute)
        self.prefill_tile_reads += touched
        self.prefill_chunks += len(order)

        streams = []
        for slot in order:
            j = row_of[slot]
            ps = self._prefilling[slot]
            req = self.slot_req[slot]
            t0, n = int(offs[j]), int(clen[j])
            ps.stage_k[:, :live] = ck[:, j, :live]
            ps.stage_v[:, :live] = cv[:, j, :live]
            streams.append({"seq": req.rid,
                            "vectors": self._kv_words(ck, cv, j, t0, t0 + n)})
            ps.consumed = t0 + n
            self.slot_len[slot] += n          # committed later this same cycle
            self.prefill_tokens += n
            if ps.consumed == len(req.prompt):
                # prefill complete: the FIRST generated token comes from the
                # prefill logits (no re-feed of prompt[-1] through decode)
                del self._prefilling[slot]
                if self.prefix_cache:
                    # registration is deferred past this cycle's pool
                    # commit — the final chunk's words are not in the pool
                    # yet, and nothing can match before the next cycle's
                    # admissions anyway
                    self._register_pending.append((req.rid,
                                                   tuple(req.prompt)))
                req.generated.append(int(np.argmax(lg[j])))
                if len(req.generated) >= req.max_new:
                    req.done = True
                # stamped AFTER this cycle's pool commit (the token isn't
                # "served" until its KV traversal lands) — see step()
                self._token_events.append(req)
            elif self.prefix_cache:
                # register the full pages committed so far: a sharer that
                # arrives mid-prefill can attach the in-progress prefix
                # instead of waiting for completion. Only whole pages — a
                # partial-tail entry would end the chain and permanently
                # shadow the full-page entry (first registration wins),
                # so the sub-page tail is left for the completion call.
                pt = self.pool.page_tokens
                full = ps.consumed - ps.consumed % pt
                if full >= pt:
                    self._register_pending.append(
                        (req.rid, tuple(req.prompt[:full])))
        return streams

    def _collect_decode(self):
        """Port C: pending appends (last step's KV words) + attention-read
        gathers for every active slot."""
        appends = [{"seq": self.slot_req[i].rid, "vectors": w[None]}
                   for i, w in sorted(self._pending.items())
                   if self.slot_req[i] is not None]
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and not r.done
                  and i not in self._prefilling]
        reads = [{"seq": self.slot_req[i].rid,
                  "positions": np.arange(self._total_len(i))}
                 for i in active]
        return appends, active, reads

    def _total_len(self, slot: int) -> int:
        """Tokens the slot will hold once this cycle's append commits."""
        return self.slot_len[slot] + (1 if slot in self._pending else 0)

    def _dispatch_decode(self, active: list, gathered: list
                         ) -> tuple[int, int, int, _InFlight]:
        """Launch one fused decode step for all active slots over staging
        caches assembled from the pool gather — WITHOUT waiting for the
        device: retirement (``_retire``) happens at the start of the next
        macro-cycle, after the host has planned it, so device compute and
        host scheduling overlap. The staging batch is padded to a
        power-of-two bucket, and the staging buffers are DOUBLE-BUFFERED —
        the next cycle's fill never touches the buffer this cycle's
        host-to-device copy was made from.

        Returns (R-port tiles touched, ideal per-slot ceil tile bound,
        critical-path chain, the in-flight handle)
        — tile accounting is pure host arithmetic over live lengths, so it
        needs no results."""
        nl, _, hkv, hd = self._kv_dims
        nb = _bucket(len(self.slot_req), lo=self._init_slots)
        row_of = {i: i for i in active}
        need_of = {i: rows.shape[0] + 1                 # post-append lens
                   for i, rows in zip(active, gathered)}
        stage_s = self._stage_len(max(need_of.values(), default=1))
        stage_k = self._stage_bufs.get(("decode", "k"),
                                       (nl, nb, stage_s, hkv, hd))
        stage_v = self._stage_bufs.get(("decode", "v"),
                                       (nl, nb, stage_s, hkv, hd))
        lens = np.full((nb,), self._dead_row, np.int32)
        last_tokens = np.zeros((nb, 1), np.int32)
        for i, rows in zip(active, gathered):
            j = row_of[i]
            t = rows.shape[0]
            w = rows.float().cpu().numpy().reshape(t, nl, 2, hkv, hd)
            stage_k[:, j, :t] = np.moveaxis(w[:, :, 0], 0, 1)
            stage_v[:, j, :t] = np.moveaxis(w[:, :, 1], 0, 1)
            lens[j] = t
            r = self.slot_req[i]
            seqs = r.generated or r.prompt
            last_tokens[j, 0] = seqs[-1]

        dev = self.device
        state = {"len": torch.from_numpy(lens).to(dev),
                 "cache_k": self._stage_bufs.to_device(stage_k),
                 "cache_v": self._stage_bufs.to_device(stage_v)}
        st, logits = self._decode(
            self.params, state,
            {"inputs": torch.from_numpy(last_tokens).to(dev)})
        inflight = _InFlight(cycle=self.cycles, vclock_end=self.vclock,
                             active=list(active), row_of=row_of, lens=lens,
                             state=st, logits=logits,
                             rids={i: self.slot_req[i].rid for i in active})
        bounded = self._fused_compute and self.length_bound
        tiles, bound, crit = self._tiles_touched(
            [need_of[i] for i in active], stage_s, bounded=bounded,
            splits=self.num_kv_splits)
        return tiles, bound, crit, inflight

    def _retire(self, inf: _InFlight) -> None:
        """Force an in-flight decode cycle's device results and fold them
        into host state: each slot's new KV word becomes the NEXT cycle's
        append, its token lands on the request, and finished requests get
        their latency stamps — at the virtual-clock time their cycle's
        traversals committed, not the later wall moment retirement ran."""
        # a slot evicted (e.g. by a chaos cancel) and possibly reassigned
        # while this dispatch was outstanding is skipped — folding the
        # stale row back in would corrupt the new occupant
        live = [i for i in inf.active if self.slot_req[i] is not None
                and self.slot_req[i].rid == inf.rids.get(i)]
        # the device-to-host copy of the new tokens and of each row's
        # appended KV word is the retire point (the sync with the device)
        rows = [inf.row_of[i] for i in live]
        dev = inf.logits.device
        js = torch.tensor(rows, dtype=torch.long, device=dev)
        ps = torch.from_numpy(inf.lens[rows].astype(np.int64)).to(dev)
        kw = inf.state["cache_k"][:, js, ps]                # [L, n, hkv, hd]
        vw = inf.state["cache_v"][:, js, ps]
        words = torch.stack([kw, vw], dim=1).permute(2, 0, 1, 3, 4)
        words = words.flatten(1).float().cpu().numpy()
        nxt = torch.argmax(inf.logits.float(), dim=-1).cpu().numpy()
        now_wall = time.perf_counter()
        for n, i in enumerate(live):
            j = inf.row_of[i]
            r = self.slot_req[i]
            self._pending[i] = words[n]
            r.generated.append(int(nxt[j]))
            if len(r.generated) >= r.max_new:
                r.done = True
                r.finish_cycle = inf.cycle
                r.finish_tick = inf.vclock_end
                r.t_finish = now_wall

    def _service_status(self) -> dict:
        return {"cycle": self.cycles,
                "vclock": self.vclock,
                "queue": len(self.admission),
                "queue_ready": self.admission.ready_depth(self.vclock),
                "active": sum(r is not None and not r.done
                              for r in self.slot_req),
                "prefilling": len(self._prefilling),
                "slots": len(self.slot_req),
                "lens": [self._total_len(i) if self.slot_req[i] is not None
                         else 0 for i in range(len(self.slot_req))],
                "pool_utilization": self.pool.utilization,
                "pool_traversals": self.pool.traversals,
                "shed": len(self.shed),
                "overload_state": (self.overload.state
                                   if self.overload is not None else None)}

    # ---- dependency scheduling ----------------------------------------------
    def _build_phases(self, scrub: list, admits: list, appends: list,
                      reads: list) -> list:
        """Turn the cycle's collected traffic into program-ordered
        :class:`PhaseTxn` bundles with page-granular footprints — the
        scheduler's hazard-analysis input.

        Write footprints are PROJECTED against the post-eviction free lists
        in commit order (prefills then appends — the same order
        ``PagedPool.cycle`` grows tables), so a footprint includes the tail
        page a demand fills and any free page it will pop; the decode read's
        footprint is every active sequence's mapped pages plus the pages its
        own append lands on (the intra-phase append+read pair stays ONE
        phase — the exempt same-cycle W->R contract)."""
        demands = ([(s["seq"], int(s["vectors"].shape[0])) for s in admits]
                   + [(s["seq"], int(s["vectors"].shape[0]))
                      for s in appends])
        footprints = self.pool.project_write_pages(demands)
        prefill_pages = frozenset().union(*footprints[:len(admits)]) \
            if admits else frozenset()
        append_pages = frozenset().union(*footprints[len(admits):]) \
            if appends else frozenset()

        phases = []
        if scrub:
            phases.append(PhaseTxn(EVICT, "evict", (
                PortTxn(SCRUB, WRITE, frozenset(scrub), scrub),)))
        if admits:
            phases.append(PhaseTxn(PREFILL, "prefill", (
                PortTxn(BULK_FILL, WRITE, prefill_pages, admits),)))
        if appends or reads:
            txns = []
            if appends:
                txns.append(PortTxn(APPEND, WRITE, append_pages, appends))
            if reads:
                read_pages = append_pages.union(
                    *[self.pool.mapped_pages(s["seq"]) for s in reads])
                txns.append(PortTxn(ATTN_READ, READ, read_pages, reads))
            phases.append(PhaseTxn(DECODE, "decode", tuple(txns)))
        return phases

    def _commit(self, schedule) -> list:
        """Issue a :class:`~repro_torch.serve.scheduler.PortSchedule` against the
        pool — one :meth:`PagedPool.cycle` per traversal, each under ITS
        port config's priority, with the capacity precheck spanning every
        co-scheduled write — and return the decode gathers (empty when the
        cycle carried no reads)."""
        groups = []
        read_gi = None
        for trav in schedule.traversals:
            streams = {_STREAM_KEY[t.port]: t.payload for t in trav.txns()}
            if "read" in streams:
                read_gi = len(groups)
            groups.append((streams, trav.priority()))
        outs = self.pool.cycle_batch(groups)
        if read_gi is None:
            return []
        return outs[read_gi]["read"] or []

    # ---- the macro-cycle -----------------------------------------------------
    def step(self) -> dict:
        """One external clock cycle of the PIPELINED host loop: retire the
        previous cycle's in-flight decode (its tokens/appends feed this
        cycle's phases), walk enabled ports in priority order, issue the
        collected traffic against the physical pool, then DISPATCH this
        cycle's decode compute without forcing it — the device executes it
        while the host plans the next macro-cycle. State evolution is
        bit-identical to the synchronous loop; only the forcing point
        moved."""
        # chaos delayed retirement: while stalled the in-flight decode is
        # NOT forced this cycle (and no new decode work is collected or
        # dispatched below) — evict/admit/prefill keep running
        stalled = self.retire_stall_cycles > 0
        if stalled:
            self.retire_stall_cycles -= 1
            if self._inflight is not None:
                self.stalled_retirements += 1
        else:
            self.flush()
        # deadline shedding happens at the HEAD of the cycle, before any
        # admission decision: expired heads never reach a slot, a page, or
        # a pool traversal (head-only — see AdmissionQueue)
        for req in self.admission.shed_expired_heads(self.vclock):
            self._shed(req, "deadline")
        if self.overload is not None:
            self.overload.observe(self.admission.ready_depth(self.vclock),
                                  cycle=self.cycles, tick=self.vclock)
        self._freed_slots_this_cycle = set()
        self._token_events = []
        cfg = self._port_enables()
        sched = build_schedule(cfg)
        slots = sched.slots
        if self.single_port:
            # bare macro: one port per CLK (rotate through enabled ports)
            slots = fsm.rotate_single_port(slots, self._sp_rotate)
            self._sp_rotate += 1

        collected = {"status": {}, "scrub": [], "admits": [],
                     "appends": [], "active": [], "reads": []}

        def service(state, port):
            if port == EVICT:
                state["scrub"] = self._collect_evict()
            elif port == PREFILL:
                state["admits"] = self._collect_prefill()
            elif port == DECODE:
                if not stalled:
                    (state["appends"], state["active"],
                     state["reads"]) = self._collect_decode()
            else:
                state["status"] = self._service_status()
            return state

        walk_cfg = PortConfig(
            enabled=tuple(p in slots for p in range(4)),
            roles=cfg.roles, priority=cfg.priority)
        collected = fsm.walk_static(walk_cfg, collected, service)
        status = collected["status"]
        scrub, admits = collected["scrub"], collected["admits"]
        appends, active, reads = (collected["appends"], collected["active"],
                                  collected["reads"])

        # schedule the cycle's traffic: hazard analysis over page
        # footprints picks the per-traversal port mix, then the plan
        # commits against the physical pool in program order
        t0 = self.pool.traversals
        phases = self._build_phases(scrub, admits, appends, reads)
        plan = sched_mod.plan(phases, mode=self.schedule_mode,
                              max_ports=self.max_ports,
                              split_roles=self._split_roles)
        gathered = self._commit(plan)
        self.schedule_log.append(
            tuple(t.phase_ids() for t in plan.traversals))
        if len({ph.phase for ph in phases}) > 1:
            self.multi_phase_cycles += 1
            if plan.co_scheduled:
                self.coscheduled_cycles += 1
        for s in appends:                          # appends are now committed
            slot = next(i for i in range(len(self.slot_req))
                        if self.slot_req[i] is not None
                        and self.slot_req[i].rid == s["seq"])
            self.slot_len[slot] += 1
            self._pending.pop(slot, None)
        # completed prompts' pages join the prefix index now that their
        # final chunk's words are committed (see _collect_prefill)
        for rid, ptoks in self._register_pending:
            if rid in self.pool.tables:
                self.pool.register_prefix(rid, ptoks)
        self._register_pending = []

        dt = self.pool.traversals - t0
        if dt == 0:
            # an idle (status-only) macro-cycle still costs one virtual
            # tick — otherwise the clock would stall while the open-loop
            # engine waits on future arrivals
            self.idle_ticks += 1
        # latency stamps for this cycle's prefill-produced tokens: a first
        # token counts as served once its cycle's traversals COMMITTED, at
        # the post-commit virtual-clock reading
        now_tick, now_wall = self.vclock, time.perf_counter()
        for r in self._token_events:
            r.first_token_cycle = self.cycles
            r.first_token_tick = now_tick
            r.t_first = now_wall
            if r.done:
                r.finish_cycle = self.cycles
                r.finish_tick = now_tick
                r.t_finish = now_wall
        if admits:
            self.prefill_steps += 1
            self.prefill_traversals += dt
        if active:
            self.decode_steps += 1
            self.decode_traversals += dt
            tiles, bound, crit, inflight = self._dispatch_decode(
                active, gathered)
            self._inflight = inflight
            self.decode_tile_reads += tiles
            self.decode_critical_tiles += crit
            if appends:
                self.steady_decode_steps += 1
                self.steady_decode_traversals += dt
                self.steady_decode_tile_reads += tiles
                self.steady_decode_tile_bound += bound
                self.steady_decode_critical_tiles += crit

        self.cycles += 1
        self.port_log.append(slots)
        return status

    def run(self, max_cycles: int = 10_000) -> list[Request]:
        while self.pending_work() and self.cycles < max_cycles:
            self.step()
        self.flush()
        return self.finished
