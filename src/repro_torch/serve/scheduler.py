"""Dependency-tracked macro-cycle port scheduler.

The paper's headline is port CONFIGURABILITY: 1-4 ports in any R/W mix,
chosen per cycle to match the traffic. The engine's old control plane kept
the mix rigid — every macro-cycle walked EVICT > PREFILL > DECODE in a
fixed phase order and the pool contract assumed 1W+1R. This module makes
the mix a per-cycle DECISION: each engine phase becomes a transaction
bundle with a page-granular footprint, and :func:`plan` packs
non-hazarding phases into shared pool traversals, emitting a
:class:`PortSchedule` whose every traversal carries its own
:class:`~repro_torch.core.ports.PortConfig` (enabled set, roles, and a priority
permutation equal to program order).

Hazard rules, at page granularity, between a program-earlier phase ``a``
and a later phase ``b``:

* **port collision** — both phases need the same physical port: split.
* **RAW** (``a`` writes a page ``b`` reads) and **WAR** (``a`` reads a
  page ``b`` writes): NEVER co-scheduled. Same-page prefill-then-decode
  must stay two traversals even though in-traversal service order would
  happen to read-after-write correctly — the conservative split is the
  architectural contract.
* **WAW** (both write an overlapping page) — co-schedulable: the
  traversal's priority is program order, so the later phase's words
  land last. This is also a bug fix over the old fixed pool priority
  (APPEND serviced before SCRUB), under which a decode append landing on
  a page freed in the SAME cycle was zeroed by that page's scrub.
* Intra-phase pairs are exempt by construction (a phase's own append+read
  stay one :class:`PhaseTxn`; the traversal service order — writes before
  reads in program order — IS the fused kernel's same-cycle W->R
  contract).

**Refcounted page sharing.** With copy-on-write prefix sharing a
page can appear in MANY sequences' tables, so the same physical page now
shows up in several phases' READ footprints in one cycle — that is RAR,
co-schedulable by the rules above, and exactly the point: N decodes
attending over one shared system-prompt page ride one traversal. The
hazard analysis needs NO special case because shared pages are
read-shared / write-private by construction upstream: the pool never
lets a write land on a refcount>1 page — the appender's footprint
(``project_write_pages``) carries the FRESH CoW page it will remap to,
and the CoW copy itself is extra W-port lanes inside that same phase's
write transaction (same traversal, same port, same commit). A write
footprint therefore only ever contains write-private pages, and the
RAW/WAR rules keep doing their job against the readers unchanged.

``mode="static"`` keeps the old rigid walk as the oracle: one traversal
per phase, program order, no co-scheduling. ``max_ports`` (1-4) bounds a
traversal's port count — the paper's B1B0 knob; phases wider than the
budget pre-split into single-transaction units. ``split_roles=True``
post-splits every traversal into a writes-traversal followed by a
reads-traversal (the two-pass reference / bare-macro pool discipline).

**Pipelining.** :func:`plan` is pure host-side work over page-id
footprints — it never touches device buffers — so the engine's async step
loop plans cycle N's schedule while cycle N-1's dispatched decode is still
executing on device (the dispatch is retired at the START of the next
step). That placement is load-bearing for the planner's inputs staying
valid: the phase footprints are computed from host page tables, which the
in-flight cycle never mutates (all table updates happen at commit, before
the next plan). The traversal count this module emits is also the serving
harness's TIME BASE: the engine's virtual clock advances one tick
per committed pool traversal, so a mode that plans more traversals per
macro-cycle (``static``) pays for them directly in measured TTFT tail.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.ports import MAX_PORTS, READ, WRITE, PortConfig
from repro_torch.core.priority import complete_priority


@dataclasses.dataclass(frozen=True)
class PortTxn:
    """One port transaction: a role-tagged page footprint plus the opaque
    stream payload the engine will commit on that port."""

    port: int                      # physical pool port id
    role: int                      # READ / WRITE
    pages: frozenset               # page-granular footprint
    payload: object = None         # opaque stream bundle (engine-owned)


@dataclasses.dataclass(frozen=True)
class PhaseTxn:
    """One engine phase's transactions; ``phase`` is its program-order
    position (the engine's logical port id), which doubles as the hazard
    ordering key."""

    phase: int
    label: str
    txns: tuple                    # tuple[PortTxn, ...] in program order

    def ports(self) -> tuple:
        return tuple(t.port for t in self.txns)


@dataclasses.dataclass(frozen=True)
class Traversal:
    """One physical pool traversal: the phases co-scheduled into it, in
    program order."""

    phases: tuple                  # tuple[PhaseTxn, ...]

    def txns(self) -> tuple:
        return tuple(t for ph in self.phases for t in ph.txns)

    def ports(self) -> tuple:
        return tuple(t.port for t in self.txns())

    def priority(self) -> tuple:
        """Full priority permutation: program order first (earlier phases
        serviced first — WAW order preservation and writes-before-reads),
        remaining port ids appended in ascending order."""
        return complete_priority(self.ports())

    def port_config(self) -> PortConfig:
        """The per-traversal port mix as a validated PortConfig — the
        paper's per-cycle configurability decision, made by the scheduler
        instead of a fixed wiring."""
        enabled = [False] * MAX_PORTS
        roles = [READ] * MAX_PORTS
        for t in self.txns():
            enabled[t.port] = True
            roles[t.port] = t.role
        return PortConfig(enabled=tuple(enabled), roles=tuple(roles),
                          priority=self.priority())

    def phase_ids(self) -> tuple:
        return tuple(ph.phase for ph in self.phases)


@dataclasses.dataclass(frozen=True)
class PortSchedule:
    """The plan for one macro-cycle: ordered pool traversals, each with its
    own port mix."""

    mode: str
    max_ports: int
    traversals: tuple              # tuple[Traversal, ...]

    @property
    def co_scheduled(self) -> bool:
        """True when any traversal services more than one engine phase —
        the cycle saved at least one pool traversal vs the rigid walk."""
        return any(len(set(t.phase_ids())) > 1 for t in self.traversals)


def conflicts(a: PhaseTxn, b: PhaseTxn) -> Optional[str]:
    """Hazard between program-earlier phase ``a`` and later phase ``b``
    if they shared a traversal: ``"port"`` / ``"raw"`` / ``"war"``, or
    None when co-scheduling is safe (disjoint pages, RAR, or WAW —
    program-order priority preserves write order)."""
    if set(a.ports()) & set(b.ports()):
        return "port"
    for ta in a.txns:
        for tb in b.txns:
            if ta.pages.isdisjoint(tb.pages):
                continue
            if ta.role == WRITE and tb.role == READ:
                return "raw"
            if ta.role == READ and tb.role == WRITE:
                return "war"
    return None


def _split_by_role(trav: Traversal) -> list:
    """Two-pass discipline: the traversal's W transactions, then its R
    transactions, each as their own traversal (program order preserved
    within both)."""
    out = []
    for role in (WRITE, READ):
        phases = []
        for ph in trav.phases:
            sel = tuple(t for t in ph.txns if t.role == role)
            if sel:
                phases.append(ph if sel == ph.txns
                              else PhaseTxn(ph.phase, ph.label, sel))
        if phases:
            out.append(Traversal(tuple(phases)))
    return out


def plan(phases: Sequence[PhaseTxn], *, mode: str = "ooo",
         max_ports: int = MAX_PORTS, split_roles: bool = False
         ) -> PortSchedule:
    """Schedule one macro-cycle's phases onto pool traversals.

    ``phases`` must arrive in program order (ascending ``phase``). In
    ``"ooo"`` mode each phase greedily joins the LAST open traversal when
    (a) no port collides, (b) the combined port count fits ``max_ports``,
    and (c) it has no RAW/WAR hazard against ANY phase already in it —
    joining an EARLIER traversal is never attempted, since issuing before
    the traversal it conflicted with would invert program order.
    ``"static"`` is the rigid-walk oracle: one traversal per phase.
    """
    if mode not in ("static", "ooo"):
        raise ValueError(f"unknown schedule mode: {mode!r}")
    if not 1 <= max_ports <= MAX_PORTS:
        raise ValueError(f"max_ports must be in 1..{MAX_PORTS}, got {max_ports}")
    order = [ph.phase for ph in phases if ph.txns]
    if order != sorted(order):
        raise ValueError(f"phases must arrive in program order, got {order}")

    units: list[PhaseTxn] = []
    for ph in phases:
        if not ph.txns:
            continue
        if len(ph.txns) > max_ports:
            # port budget narrower than the phase: issue its transactions
            # one traversal each, program order (the 1-port degradation)
            units.extend(PhaseTxn(ph.phase, f"{ph.label}[{i}]", (t,))
                         for i, t in enumerate(ph.txns))
        else:
            units.append(ph)

    groups: list[list[PhaseTxn]] = []
    for u in units:
        if mode == "ooo" and groups:
            g = groups[-1]
            ports = {p for ph in g for p in ph.ports()}
            if (len(ports | set(u.ports())) <= max_ports
                    and all(conflicts(ph, u) is None for ph in g)):
                g.append(u)
                continue
        groups.append([u])

    travs = [Traversal(tuple(g)) for g in groups]
    if split_roles:
        travs = [s for t in travs for s in _split_by_role(t)]
    return PortSchedule(mode=mode, max_ports=max_ports,
                        traversals=tuple(travs))
