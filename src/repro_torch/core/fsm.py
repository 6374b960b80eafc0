"""Finite state machine — the port-walk sequencer.

Paper mapping (Fig. 2, §II-A-4): the FSM transitions between enabled ports in
priority order, one SRAM access per internal slot, and is asynchronously reset
to the highest-priority enabled port at each external CLK posedge.

The walk is host-side: the port count is <= 4 and the configuration is fixed
for a macro-cycle, so ``walk_static`` simply visits the enabled ports in
service order and ``walk_schedule`` drives a cycle from an ordered list of
per-traversal configurations.
"""
from __future__ import annotations

from typing import Callable, Sequence, TypeVar

from repro_torch.core.ports import PortConfig

S = TypeVar("S")
P = TypeVar("P")


class PhaseError(ValueError):
    """Raised when a phase counter is driven outside its legal domain.

    The external phase counter counts CLK posedges since the engine started,
    so it is monotonically non-negative; a negative value indicates the
    caller's cycle accounting went backwards, which Python's modulo would
    silently mask (``-1 % 4 == 3``)."""


def walk_static(config: PortConfig, state: S,
                service: Callable[[S, int], S]) -> S:
    """Visit each enabled port once, in priority order (one macro-cycle).

    Args:
      config: static port configuration.
      state: carried state (e.g. (storage, read_outputs)).
      service: slot body; called as service(state, port_id) for each slot.
    """
    for port in config.service_order():
        state = service(state, port)
    return state


def rotate_single_port(schedule: tuple[int, ...], phase: int
                       ) -> tuple[int, ...]:
    """Bare-macro degradation of a macro-cycle schedule: service ONE slot per
    external CLK, round-robin over the enabled ports (the paper's 1-port
    baseline — the FSM never advances past its reset state within a cycle).

    ``schedule`` is a :func:`~repro_torch.core.clockgen.build_schedule` slot
    tuple; ``phase`` counts external cycles since the engine started. Phases
    beyond ``len(schedule)`` wrap (round-robin); negative phases raise
    :class:`PhaseError` rather than leaning on Python's modulo semantics.
    """
    if not schedule:
        raise ValueError("cannot rotate an empty schedule")
    if phase < 0:
        raise PhaseError(f"phase counter must be non-negative, got {phase}")
    return (schedule[phase % len(schedule)],)


def walk_schedule(schedule: Sequence[tuple[PortConfig, P]], state: S,
                  service: Callable[[S, P, PortConfig], S]) -> S:
    """Drive a macro-cycle from a *schedule* instead of one fixed config.

    Generalization of :func:`walk_static`: a schedule is an ordered sequence
    of pool traversals, each carrying its own :class:`PortConfig` (the
    per-cycle enabled-port set, R/W roles and priority chosen by the
    dependency scheduler) plus an opaque payload (the transactions to issue
    on those ports). ``service(state, payload, config)`` is called once per
    traversal, in schedule order — program order between hazarding
    traversals is therefore preserved by construction.
    """
    for config, payload in schedule:
        state = service(state, payload, config)
    return state
