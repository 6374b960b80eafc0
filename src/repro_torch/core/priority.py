"""Port priorities (host-side: the port configuration is static per cycle).

Paper mapping (Fig. 1, §II-A-3): the priority encoder assigns a fixed priority
(default A > B > C > D) to the enabled ports; its output asynchronously loads
the FSM back to the highest-priority enabled port at every external-clock edge.
``PortConfig.service_order`` is that encoder; this module completes a
traversal's partial service order into a full priority permutation.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.ports import MAX_PORTS


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
