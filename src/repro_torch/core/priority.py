"""Priority encoder — static (host) and dynamic (tensor) variants.

Paper mapping (Fig. 1, §II-A-3): the priority encoder assigns a fixed priority
(default A > B > C > D) to the enabled ports; its output asynchronously loads
the FSM back to the highest-priority enabled port at every external-clock edge.

The static functions take Python sequences. The dynamic ones take tensors
(``enabled_mask`` bool[MAX_PORTS], ``priority`` an int permutation) and are
tensor ops only: no ``.item()`` and no Python branch on a value, so nothing
waits on the card and a captured CUDA graph can hold them.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.ports import MAX_PORTS


def encode_static(enabled: Sequence[bool], priority: Sequence[int]) -> int:
    """Index of the highest-priority enabled port (host)."""
    for p in priority:
        if enabled[p]:
            return p
    raise ValueError("no port enabled")


def order_static(enabled: Sequence[bool], priority: Sequence[int]
                 ) -> tuple[int, ...]:
    """All enabled ports, highest priority first (host)."""
    return tuple(p for p in priority if enabled[p])


def complete_priority(order: Sequence[int], n: int = MAX_PORTS) -> tuple[int, ...]:
    """Extend a service order over a subset of ports to a full priority
    permutation of ``range(n)``: the listed ports keep their relative order
    (highest priority first) and the remaining ids follow in ascending order.
    This is how the scheduler turns a traversal's program-order port list
    into a :class:`~repro_torch.core.ports.PortConfig` priority field."""
    order = tuple(order)
    if len(set(order)) != len(order) or any(p < 0 or p >= n for p in order):
        raise ValueError(f"order must be distinct port ids in 0..{n-1}: {order}")
    return order + tuple(p for p in range(n) if p not in order)


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first True of a bool vector, 0 when there is none
    (``jnp.argmax`` of a bool vector)."""
    return torch.argmax(x.to(torch.int8))


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor without reading it back to the host
    (``x[i]`` would turn ``i`` into a Python int)."""
    return torch.take(x, i.long())


def encode_dynamic(enabled_mask: torch.Tensor,
                   priority: torch.Tensor) -> torch.Tensor:
    """Tensor priority encoder.

    Args:
      enabled_mask: bool[MAX_PORTS], indexed by port id.
      priority: int[MAX_PORTS] permutation; priority[k] = port id with rank k.

    Returns:
      int32 scalar tensor: the highest-priority enabled port id. With
      nothing enabled (which a PortConfig cannot express) it is
      ``priority[0]``: the argmax of an all-False vector is 0, as in the
      JAX package, whose docstring says ``priority[-1]``.
    """
    ranked_enabled = enabled_mask[priority]                 # bool, by rank
    return _at(priority, _first_true(ranked_enabled)).to(torch.int32)


def rank_of(priority: torch.Tensor) -> torch.Tensor:
    """Inverse permutation: rank_of(priority)[port] = rank of that port."""
    ranks = torch.arange(MAX_PORTS, dtype=torch.int32, device=priority.device)
    return torch.zeros_like(ranks).scatter_(0, priority.long(), ranks)


def next_port_dynamic(current: torch.Tensor, enabled_mask: torch.Tensor,
                      priority: torch.Tensor) -> torch.Tensor:
    """Tensor FSM transition: the next enabled port after ``current`` in
    priority order, wrapping to the highest-priority enabled port (Fig. 2)."""
    cur_rank = _at(rank_of(priority), current)
    ranked_enabled = enabled_mask[priority]
    idx = torch.arange(MAX_PORTS, device=priority.device)
    later = ranked_enabled & (idx > cur_rank)       # enabled ranks after it
    nxt_rank = torch.where(later.any(), _first_true(later),
                           _first_true(ranked_enabled))
    return _at(priority, nxt_rank).to(torch.int32)
