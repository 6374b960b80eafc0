"""Fault-injection chaos harness for the multi-port serving engine.

The overload layer (deadlines, bounded admission, capacity retry, graceful
degradation) is only trustworthy if it holds under the failures it was
built for — and those failures must be REPRODUCIBLE, or a CI pass means
nothing. This module makes fault injection a seeded, virtual-clock-
scheduled experiment:

* :class:`FaultPlan` — a deterministic schedule of faults
  (``FaultPlan.generate(seed, horizon)``: same seed, same plan,
  bit-for-bit), each fault pinned to a virtual tick. Three kinds:

  - ``squeeze``: an admission-time capacity squeeze — quarantine N free
    pages per shard (``PagedPool.quarantine``) for a bounded duration,
    then release. The quarantine respects the engine's worst-case
    reservations (``keep_free``), so a squeeze pressures ADMISSION —
    requests park, retry after evictions, or shed — without ever making
    an already-admitted sequence's append fail mid-stream.
  - ``cancel``: mid-stream request cancellation — a live slot picked
    deterministically from the plan's pre-drawn choice is marked done
    (``MultiPortEngine.cancel``) and its slot + pages are freed through
    the NORMAL evict/scrub path next cycle; no bespoke teardown.
  - ``stall``: delayed retirement of the async-dispatched decode
    (``MultiPortEngine.stall_retirement``) — the in-flight device work
    stays un-forced for N macro-cycles while the host keeps evicting,
    admitting, and prefilling.

* :func:`check_invariants` — the engine-wide consistency audit the
  harness runs after EVERY injection and release (and once more at the
  end): free ∪ quarantined ∪ ⋃mapped-with-multiplicity partitions pool
  capacity (a page in k tables is owned exactly k times, all by its
  refcount; free/quarantined pages are owned once and never also
  mapped), refcounts equal table multiplicity exactly, quarantine never
  holds a referenced page, prefix-index registrations only cover live
  pages, no orphaned page tables (every table belongs to a live slot),
  page tables sized exactly for their sequence's committed words, every
  page on the shard its free list / table placement claims, and slot
  bookkeeping in sync with the pool. A violation raises
  :class:`InvariantViolation` — a hard CI failure, never a warning.

* :class:`ChaosHarness` — plugs into ``drive(..., on_cycle=harness)``:
  fires due faults before the macro-cycle they are scheduled in, releases
  expiring squeezes, and keeps the ``distributed/fault.py`` liveness
  helpers wired in: a :class:`~repro_torch.distributed.fault.Heartbeat`
  beats once per driven cycle (when given a directory), and a
  :class:`~repro_torch.distributed.fault.StragglerDetector` watches the
  VIRTUAL-tick duration of each driven cycle — a parked/stalled stretch
  that fast-forwards the clock shows up as a deterministic straggler
  event, counted in ``straggler_events``.

The end-to-end contract (``tests/test_torch_chaos.py`` and
``chip_smoke.py``): every fault passes the invariant audit,
and SURVIVORS — requests neither shed nor cancelled — finish with tokens
identical to a fault-free run of the same arrival schedule.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.distributed.fault import Heartbeat, StragglerDetector

KINDS = ("squeeze", "cancel", "stall")


class InvariantViolation(AssertionError):
    """An engine/pool consistency invariant broke after a fault."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: what to inject and when (virtual ticks)."""

    tick: int                   # virtual-clock tick the fault fires at
    kind: str                   # "squeeze" | "cancel" | "stall"
    magnitude: int = 1          # squeeze: pages/shard; stall: cycles
    duration: int = 0           # squeeze: ticks until release
    choice: float = 0.0         # cancel: pre-drawn pick in [0, 1)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind: {self.kind!r}")
        if self.tick < 0 or self.magnitude < 1 or self.duration < 0:
            raise ValueError(f"bad fault geometry: {self}")
        if not 0.0 <= self.choice < 1.0:
            raise ValueError(f"choice must be in [0, 1), got {self.choice}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, immutable schedule of faults, sorted by tick."""

    seed: int
    faults: tuple

    @classmethod
    def generate(cls, seed: int, horizon: int, *, n_faults: int = 6,
                 kinds: tuple = KINDS, max_squeeze: int = 2,
                 max_stall: int = 3, max_duration: int = 24) -> "FaultPlan":
        """Draw ``n_faults`` faults uniformly over ``[0, horizon)`` ticks
        with kinds cycled from ``kinds`` (every kind exercised) and
        magnitudes/durations drawn from the seeded rng — deterministic:
        same arguments, same plan, bit-for-bit."""
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if n_faults < 1:
            raise ValueError(f"n_faults must be >= 1, got {n_faults}")
        for k in kinds:
            if k not in KINDS:
                raise ValueError(f"unknown fault kind: {k!r}")
        rng = np.random.default_rng(seed)
        ticks = np.sort(rng.integers(0, horizon, n_faults))
        faults = []
        for i, t in enumerate(ticks):
            kind = kinds[i % len(kinds)]
            faults.append(Fault(
                tick=int(t), kind=kind,
                magnitude=int(rng.integers(
                    1, (max_squeeze if kind == "squeeze" else max_stall)
                    + 1)),
                duration=(int(rng.integers(1, max_duration + 1))
                          if kind == "squeeze" else 0),
                choice=float(rng.random()) if kind == "cancel" else 0.0))
        return cls(seed=seed, faults=tuple(faults))


def _mapped_pages(pool) -> list:
    return [p for t in pool.tables.values() for p in t]


def check_invariants(eng) -> None:
    """Audit the engine + pool for consistency; raise
    :exc:`InvariantViolation` with a specific message on the first break.

    The invariants (the chaos gate's hard failures):

    1. **Partition with multiplicity**: free ∪ quarantined ∪
       ⋃mapped-with-multiplicity covers exactly ``0..n_pages-1``. A page
       in k tables is owned k times — all k accounted for by its
       refcount; free and quarantined pages are owned exactly once and
       never also mapped.
    2. **Refcount exactness**: ``pool.refcounts[p]`` equals the number
       of table slots referencing ``p``, for EVERY mapped page; no
       refcount entry survives for an unmapped page (no rc-0 retention);
       every prefix-index-registered page is live (rc >= 1).
    3. **No orphans**: every page table belongs to a request live in a
       slot (finished/cancelled sequences were freed by EVICT).
    4. **Table sizing**: each sequence's table holds exactly
       ``ceil(words / page_tokens)`` pages.
    5. **Shard placement**: every free/quarantined page sits in ITS
       shard's list, and every sequence's pages live on its home shard
       (prefix attaches re-home the sequence to the shared pages'
       shard, so this stays exact under sharing).
    6. **Slot bookkeeping**: ``slot_len`` matches the pool's committed
       word count for every occupied slot.
    """
    pool = eng.pool
    n_pages = pool.plan.n_pages

    mapped = _mapped_pages(pool)
    mult: dict = {}
    for p in mapped:
        mult[p] = mult.get(p, 0) + 1
    free = pool.free_pages
    quar = list(pool.quarantined_pages)
    exclusive = free + quar
    if len(set(exclusive)) != len(exclusive):
        dup = sorted(p for p in set(exclusive)
                     if exclusive.count(p) > 1)
        raise InvariantViolation(
            f"pages free/quarantined twice: {dup}")
    overlap = set(exclusive) & set(mult)
    if overlap:
        raise InvariantViolation(
            f"mapped pages also free/quarantined: {sorted(overlap)}")
    owned = set(exclusive) | set(mult)
    if sorted(owned) != list(range(n_pages)):
        lost = sorted(set(range(n_pages)) - owned)
        extra = sorted(owned - set(range(n_pages)))
        raise InvariantViolation(
            f"free+quarantined+mapped do not partition capacity "
            f"(lost {lost}, alien {extra})")

    # refcounts mirror table multiplicity EXACTLY: every mapped page has
    # a refcount equal to how many table slots hold it, and no refcount
    # outlives its last reference (the no-tombstone contract)
    bad = {p: (pool.refcounts.get(p), k) for p, k in mult.items()
           if pool.refcounts.get(p) != k}
    if bad:
        raise InvariantViolation(
            f"refcounts != table multiplicity (page: (rc, refs)): {bad}")
    stale = sorted(set(pool.refcounts) - set(mult))
    if stale:
        raise InvariantViolation(
            f"refcounts retained for unmapped pages: {stale}")
    dead_reg = sorted(p for p in pool.page_reg if p not in mult)
    if dead_reg:
        raise InvariantViolation(
            f"prefix index registers unmapped pages: {dead_reg}")

    live = {r.rid for r in eng.slot_req if r is not None}
    orphans = set(pool.tables) - live
    if orphans:
        raise InvariantViolation(
            f"orphaned page tables for evicted seqs {sorted(orphans)}")

    pt = pool.page_tokens
    for seq, table in pool.tables.items():
        words = pool.lengths.get(seq, 0)
        need = -(-words // pt)
        if len(table) != need:
            raise InvariantViolation(
                f"seq {seq}: {len(table)} pages mapped for {words} words "
                f"(needs {need})")
        home = pool.home.get(seq)
        wrong = [p for p in table if pool.plan.shard_of_page(p) != home]
        if wrong:
            raise InvariantViolation(
                f"seq {seq} (home shard {home}) holds foreign pages "
                f"{wrong}")

    for s, fl in enumerate(pool.free_by_shard):
        wrong = [p for p in fl if pool.plan.shard_of_page(p) != s]
        if wrong:
            raise InvariantViolation(
                f"shard {s} free list holds foreign pages {wrong}")
    for s, q in enumerate(pool.quarantine_by_shard):
        wrong = [p for p in q if pool.plan.shard_of_page(p) != s]
        if wrong:
            raise InvariantViolation(
                f"shard {s} quarantine holds foreign pages {wrong}")

    for i, r in enumerate(eng.slot_req):
        if r is None:
            continue
        words = pool.lengths.get(r.rid, 0)
        if words != eng.slot_len[i]:
            raise InvariantViolation(
                f"slot {i} (rid {r.rid}): slot_len {eng.slot_len[i]} != "
                f"pool words {words}")


class ChaosHarness:
    """Inject a :class:`FaultPlan` into a driven engine, auditing
    invariants after every action. Callable — pass it straight to
    ``drive(eng, arrivals, on_cycle=harness)``."""

    def __init__(self, plan: FaultPlan, *,
                 heartbeat_dir: Optional[str] = None,
                 worker: str = "engine",
                 straggler_multiplier: float = 4.0):
        self.plan = plan
        self._due = deque(sorted(plan.faults, key=lambda f: f.tick))
        self._release_tick: Optional[int] = None
        self._last_tick: Optional[int] = None
        self.injected: list[dict] = []     # every action, with its tick
        self.invariant_checks = 0
        self.straggler = StragglerDetector(multiplier=straggler_multiplier)
        self.straggler_events = 0
        self.heartbeat = (Heartbeat(heartbeat_dir, worker)
                          if heartbeat_dir is not None else None)

    # -- injection primitives (each audited) ------------------------------
    def _audit(self, eng) -> None:
        check_invariants(eng)
        self.invariant_checks += 1

    def _squeeze(self, eng, fault: Fault, now: int) -> None:
        if self._release_tick is not None:
            # one squeeze at a time: release the active one first
            eng.pool.release_quarantine()
            self._release_tick = None
        taken = eng.pool.quarantine(
            fault.magnitude, keep_free=eng._reserved_pages_by_shard())
        self._release_tick = now + fault.duration
        self.injected.append({"tick": now, "kind": "squeeze",
                              "pages": len(taken),
                              "release_tick": self._release_tick})

    def _cancel(self, eng, fault: Fault, now: int) -> None:
        live = sorted(r.rid for r in eng.slot_req
                      if r is not None and not r.done)
        if not live:
            self.injected.append({"tick": now, "kind": "cancel",
                                  "rid": None})
            return
        rid = live[int(fault.choice * len(live))]
        eng.cancel(rid)
        self.injected.append({"tick": now, "kind": "cancel", "rid": rid})

    def _stall(self, eng, fault: Fault, now: int) -> None:
        eng.stall_retirement(fault.magnitude)
        self.injected.append({"tick": now, "kind": "stall",
                              "cycles": fault.magnitude})

    # -- the drive() hook --------------------------------------------------
    def __call__(self, eng) -> None:
        now = eng.vclock
        if self.heartbeat is not None:
            self.heartbeat.beat(eng.cycles)
        # straggler watch over VIRTUAL cycle duration: a parked or stalled
        # stretch that fast-forwards the clock is a deterministic outlier
        if self._last_tick is not None:
            if self.straggler.record(eng.cycles, float(now
                                                      - self._last_tick)):
                self.straggler_events += 1
        self._last_tick = now
        if self._release_tick is not None and now >= self._release_tick:
            eng.pool.release_quarantine()
            self._release_tick = None
            self.injected.append({"tick": now, "kind": "release"})
            self._audit(eng)
        while self._due and self._due[0].tick <= now:
            fault = self._due.popleft()
            {"squeeze": self._squeeze, "cancel": self._cancel,
             "stall": self._stall}[fault.kind](eng, fault, now)
            # injection-tick vs plan-tick audit: drive() only calls the
            # hook on cycles that actually step, so a fault due inside an
            # idle fast-forward fires at the first REAL cycle after it —
            # the drift stamp makes that residual (and any regression in
            # the drive() ordering) visible instead of silent
            self.injected[-1].update(plan_tick=fault.tick,
                                     drift=now - fault.tick)
            self._audit(eng)

    def finalize(self, eng) -> None:
        """End of run: force any trailing in-flight work, release a still-
        active squeeze, fire faults past the traffic horizon (audited like
        any other), and audit once more."""
        eng.flush()
        while self._due:
            fault = self._due.popleft()
            {"squeeze": self._squeeze, "cancel": self._cancel,
             "stall": self._stall}[fault.kind](eng, fault, eng.vclock)
            self.injected[-1].update(plan_tick=fault.tick,
                                     drift=eng.vclock - fault.tick)
            self._audit(eng)
        if self._release_tick is not None:
            eng.pool.release_quarantine()
            self._release_tick = None
            self.injected.append({"tick": eng.vclock, "kind": "release"})
        eng.flush()
        self._audit(eng)
