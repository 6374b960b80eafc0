"""Host-side admission control for the multi-port serving engine (a copy
of the JAX package's pure-Python module).

Admission is a first-class HOST-side decision, decoupled from the device
macro-cycle: requests wait here while slots are contended and are admitted
when capacity frees up. The architectural invariant:

**Admission follows ARRIVAL order (FIFO) under slot contention.** When
several queued requests compete for one freed slot, the OLDEST ready
request wins — :meth:`pop_ready` only ever surfaces the queue head, never
a younger request that happens to look cheaper (shorter prompt, fewer
pages). Head-of-line blocking is the contract: re-ordering by readiness or
size would systematically starve long-prompt requests.

The queue measures itself: ``peak_depth``, ``admitted``, and per-request
wait stamps land on the request objects themselves (``admit_cycle`` /
``admit_tick``). Requests only need ``arrival_tick`` (virtual-clock arrival
time) — the queue is generic over the payload.

**Overload safety.** Two explicit, COUNTED load-shedding decisions
(``rejected`` / ``shed_expired``):

* a bounded depth (``max_depth``): :meth:`push` REJECTS — returns False —
  when the queue is full, the earliest (and cheapest) place to say no;
* deadline shedding: requests may carry ``deadline_tick`` (arrival + TTL).
  :meth:`shed_expired_heads` drops expired HEADS before they are admitted;
  shedding only ever inspects the head, so the FIFO contract is untouched.

:class:`OverloadController` is the graceful-degradation stage BEFORE
shedding — on sustained ready-queue pressure it shrinks the engine's
prefill chunk and caps admissions per cycle, restoring both when pressure
clears.

**Prefix-aware admission** (:func:`prefix_admission_plan`): the head's
prompt is matched against the pool's content-addressed prefix index BEFORE
the capacity precheck, so matched pages — attachable by refcount bump —
never count as page demand and the precheck probes the PREFIX's shard.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional


class AdmissionQueue:
    """Arrival-ordered FIFO of submitted-but-not-admitted requests."""

    def __init__(self, max_depth: Optional[int] = None):
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self._q: deque = deque()
        self.max_depth = max_depth
        self.peak_depth = 0
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0              # pushes refused by the depth bound
        self.shed_expired = 0          # expired heads dropped pre-admission

    def push(self, req) -> bool:
        """Enqueue in submission order (== arrival order: callers submit as
        the traffic schedule fires, and ties share the submission order).
        Returns False — and counts the rejection — when a ``max_depth``
        bound is set and the queue is already full."""
        if self.max_depth is not None and len(self._q) >= self.max_depth:
            self.rejected += 1
            return False
        self._q.append(req)
        self.submitted += 1
        self.peak_depth = max(self.peak_depth, len(self._q))
        return True

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def head(self):
        """The oldest queued request (None when empty) — the ONLY request
        eligible for the next admission."""
        return self._q[0] if self._q else None

    def head_ready(self, now: float) -> bool:
        """True when the oldest queued request has arrived by virtual tick
        ``now`` (closed-loop submissions stamp their arrival at submit time,
        so they are always ready)."""
        return bool(self._q) and self._q[0].arrival_tick <= now

    def ready_depth(self, now: float) -> int:
        """How many queued requests have arrived by ``now`` — the open-loop
        queue-depth sample."""
        return sum(1 for r in self._q if r.arrival_tick <= now)

    def pop_ready(self, now: float) -> Optional[object]:
        """Admit the queue HEAD if it has arrived; None otherwise. Never
        skips ahead — a later, shorter request must wait behind the head
        (FIFO; no starvation of long-prompt requests). Expired heads are
        shed first (see :meth:`shed_expired_heads`), so the request this
        returns can still meet its deadline."""
        self.shed_expired_heads(now)
        if not self.head_ready(now):
            return None
        self.admitted += 1
        return self._q.popleft()

    def drop_head(self):
        """Remove and return the head WITHOUT counting it admitted — the
        engine's shed path (e.g. capacity-retry exhaustion)."""
        return self._q.popleft() if self._q else None

    @staticmethod
    def _expired(req, now: float) -> bool:
        ddl = getattr(req, "deadline_tick", None)
        return ddl is not None and now > ddl

    def shed_expired_heads(self, now: float) -> list:
        """Drop every expired request from the FRONT of the queue (its
        deadline tick has already passed at virtual time ``now``) and
        return them for the caller to stamp/count. Head-only by design:
        an expired request buried behind a live head is left in place —
        it will be shed when it surfaces, and skipping over the head to
        reap it early would break the arrival-order contract."""
        shed = []
        while self._q and self._expired(self._q[0], now):
            shed.append(self._q.popleft())
        self.shed_expired += len(shed)
        return shed


def prefix_admission_plan(pool, prompt, max_new: int, *,
                          enabled: bool = True):
    """The admission-layer prefix policy: (match, worst_tokens) for one
    candidate request.

    ``worst`` is the request's worst-case lifetime word demand — prompt
    plus generated tokens, minus the final token whose KV never lands
    (eviction precedes its append). The match, when ``enabled``, is capped
    at ``len(prompt) - 1`` tokens: the LAST prompt position is always
    recomputed, because the first generated token is read off its prefill
    logits (a full-prompt attach would leave nothing to take logits from).
    Matching runs BEFORE the capacity precheck by contract — callers pass
    the match to :meth:`PagedPool.admission_precheck` so only the
    unmatched tail counts as page demand, on the prefix's shard."""
    worst = len(prompt) + max_new - 1
    match = None
    if enabled and len(prompt) > 1:
        match = pool.match_prefix(prompt, limit=len(prompt) - 1)
    return match, worst


@dataclasses.dataclass
class OverloadController:
    """Graceful degradation under pressure — the stage between "serve
    everything" and "shed".

    Watches the ready-queue depth the engine samples every macro-cycle.
    After ``sustain`` consecutive cycles at or above ``depth_high`` it
    enters the DEGRADED state: the engine's prefill chunk shrinks by
    ``chunk_shrink`` (new prompts stream in smaller per-cycle slices, so
    in-flight decodes keep making progress instead of stalling behind
    bulk prefill traffic) and new admissions are capped at
    ``admission_cap`` per cycle (the queue absorbs the burst; deadline
    shedding trims what can no longer be served). After ``sustain``
    consecutive cycles at or below ``depth_low`` it restores normal
    service. Hysteresis (high/low bands + the sustain count) keeps it
    from flapping on a single bursty cycle.

    Degrading never changes WHAT is generated — chunked prefill is
    chunk-size invariant,
    only the per-cycle port traffic shape moves. Every transition is
    logged in ``transitions`` with its cycle, tick, and trigger depth;
    ``degraded_cycles`` counts time spent degraded — both surfaced in the
    overload summary."""

    depth_high: int = 6
    depth_low: int = 1
    sustain: int = 3
    chunk_shrink: int = 2          # chunk_tokens divisor while degraded
    admission_cap: int = 1         # max admissions per cycle while degraded
    state: str = "normal"
    transitions: list = dataclasses.field(default_factory=list)
    degraded_cycles: int = 0
    _over: int = 0
    _under: int = 0

    def __post_init__(self):
        if self.depth_low >= self.depth_high:
            raise ValueError(
                f"depth_low ({self.depth_low}) must be < depth_high "
                f"({self.depth_high}) — the hysteresis band")
        if self.sustain < 1 or self.chunk_shrink < 1 or self.admission_cap < 1:
            raise ValueError("sustain, chunk_shrink and admission_cap must "
                             "all be >= 1")

    @property
    def degraded(self) -> bool:
        return self.state == "degraded"

    def observe(self, ready_depth: int, *, cycle: int, tick: int) -> None:
        """One macro-cycle's pressure sample; may transition the state."""
        if self.state == "normal":
            self._over = self._over + 1 if ready_depth >= self.depth_high \
                else 0
            if self._over >= self.sustain:
                self.state = "degraded"
                self._over = self._under = 0
                self.transitions.append(
                    {"cycle": cycle, "tick": tick, "to": "degraded",
                     "ready_depth": ready_depth})
        else:
            self.degraded_cycles += 1
            self._under = self._under + 1 if ready_depth <= self.depth_low \
                else 0
            if self._under >= self.sustain:
                self.state = "normal"
                self._over = self._under = 0
                self.transitions.append(
                    {"cycle": cycle, "tick": tick, "to": "normal",
                     "ready_depth": ready_depth})

    def chunk_tokens(self, base: int) -> int:
        """The prefill chunk the engine should use this cycle."""
        return base if self.state == "normal" \
            else max(1, base // self.chunk_shrink)

    def cap(self) -> Optional[int]:
        """Per-cycle admission cap (None = uncapped) for this cycle."""
        return None if self.state == "normal" else self.admission_cap
