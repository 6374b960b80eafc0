"""Finite state machine — the port-walk sequencer.

Paper mapping (Fig. 2, §II-A-4): the FSM transitions between enabled ports in
priority order, one SRAM access per internal slot, and is asynchronously reset
to the highest-priority enabled port at each external CLK posedge.

Two realizations:

* ``walk_static``  — a host-side walk of a static configuration (used by
  ``multiport.step``; ``walk_schedule`` drives a cycle from an ordered list
  of per-traversal configurations).
* ``walk_dynamic`` — a walk whose enable mask and priority are tensors: it
  always runs MAX_PORTS slots (the JAX package's ``lax.scan`` over the slots
  is a loop of 4 here) and disabled slots are no-ops. Its slot order, like
  ``reset_state``/``transition``/``walk_order_dynamic``, is tensor ops only,
  so a captured CUDA graph can hold it.
"""
from __future__ import annotations

from typing import Callable, Sequence, TypeVar

import torch

from repro_torch.core import priority as prio
from repro_torch.core.ports import MAX_PORTS, PortConfig

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


def walk_order_dynamic(enabled_mask: torch.Tensor, priority_perm: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (slot_ports int32[MAX_PORTS], slot_active bool[MAX_PORTS]):
    slot k services the k-th enabled port in priority order; trailing slots
    (k >= N) are idle (active False). A stable sort of the ranks with the
    enabled ones first, as the hardware assigns slots."""
    ranked_enabled = enabled_mask[priority_perm]                # bool by rank
    order = torch.sort((~ranked_enabled).to(torch.int8), stable=True).indices
    return priority_perm[order].to(torch.int32), ranked_enabled[order]


def walk_dynamic(enabled_mask: torch.Tensor, priority_perm: torch.Tensor,
                 state: S,
                 service: Callable[[S, torch.Tensor, torch.Tensor], S]) -> S:
    """Tensor-configured walk: always runs MAX_PORTS slots; disabled slots
    are no-ops.

    ``service(state, port_id, active)`` must be a no-op when ``active`` is
    False (the caller typically masks its scatter/gather with ``active``).
    """
    slot_ports, slot_active = walk_order_dynamic(enabled_mask, priority_perm)
    for k in range(MAX_PORTS):
        state = service(state, slot_ports[k], slot_active[k])
    return state


def reset_state(enabled_mask: torch.Tensor,
                priority_perm: torch.Tensor) -> torch.Tensor:
    """CLKP posedge behaviour: async load of the highest-priority enabled
    port."""
    return prio.encode_dynamic(enabled_mask, priority_perm)


def transition(current: torch.Tensor, enabled_mask: torch.Tensor,
               priority_perm: torch.Tensor) -> torch.Tensor:
    """CLK2 posedge behaviour: advance to the next enabled port (Fig. 2)."""
    return prio.next_port_dynamic(current, enabled_mask, priority_perm)
