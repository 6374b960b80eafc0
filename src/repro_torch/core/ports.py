"""Port bundles for the configurable multi-port memory wrapper.

Paper mapping (Fig. 1): each external port carries ``port_en`` (enable), ``w/rb``
(write / read-bar role), ``addr`` (address lines) and ``w_data`` (write data).
On an accelerator a port is *vectorized*: one macro-cycle carries a queue of
``Q`` word requests per port (a 65nm SRAM port moves one word per cycle; a
vector unit moves many).

``PortConfig`` is the static part (fixed for a macro-cycle): which ports are
enabled, each port's R/W role, and the priority permutation. ``PortRequest`` is
the per-cycle part: addresses, data, and a per-lane validity mask, as torch
tensors on the memory's device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

MAX_PORTS = 4  # the paper's wrapper exposes four external ports

READ = 0
WRITE = 1


@dataclasses.dataclass(frozen=True)
class PortConfig:
    """Static configuration of the wrapper (the ``port_en`` / ``w/rb`` wires).

    Attributes:
      enabled:  per-port enable bits (``port_en``).
      roles:    per-port READ/WRITE role (``w/rb``); ignored for disabled ports.
      priority: permutation of range(MAX_PORTS); lower position = higher priority
                (paper default A > B > C > D == identity permutation).
    """

    enabled: tuple[bool, ...]
    roles: tuple[int, ...]
    priority: tuple[int, ...] = tuple(range(MAX_PORTS))

    def __post_init__(self) -> None:
        if len(self.enabled) != MAX_PORTS or len(self.roles) != MAX_PORTS:
            raise ValueError(f"PortConfig requires exactly {MAX_PORTS} port slots")
        if sorted(self.priority) != list(range(MAX_PORTS)):
            raise ValueError(f"priority must be a permutation of 0..{MAX_PORTS-1}")
        if not any(self.enabled):
            raise ValueError("at least one port must be enabled")
        for r in self.roles:
            if r not in (READ, WRITE):
                raise ValueError("roles must be READ (0) or WRITE (1)")

    # --- the "N ports en" block -------------------------------------------------
    @property
    def enabled_count(self) -> int:
        """Number of enabled ports (the block that drives B1B0)."""
        return sum(self.enabled)

    @property
    def b1b0(self) -> int:
        """The 2-bit enabled-port count fed to the clock generator.

        Paper encoding: 00 => 1-port, 01 => 2-port, 10 => 3-port, 11 => 4-port.
        """
        return self.enabled_count - 1

    # --- priority encoder output -------------------------------------------------
    def service_order(self) -> tuple[int, ...]:
        """Enabled port indices in service order (highest priority first).

        This is the composition of the priority encoder and the FSM walk of
        Fig. 2: the FSM starts at the highest-priority enabled port and visits
        each enabled port once per macro-cycle.
        """
        return tuple(p for p in self.priority if self.enabled[p])

    def read_ports(self) -> tuple[int, ...]:
        return tuple(p for p in range(MAX_PORTS) if self.enabled[p] and self.roles[p] == READ)

    def write_ports(self) -> tuple[int, ...]:
        return tuple(p for p in range(MAX_PORTS) if self.enabled[p] and self.roles[p] == WRITE)

    def mix(self) -> str:
        """The R/W mix of the enabled ports, e.g. ``"2W+1R"`` for a 3-port
        asymmetric configuration (``"2W"`` / ``"1R"`` when one role is
        absent). This is the label the pool's per-mix traversal histogram
        keys on."""
        n_w = len(self.write_ports())
        n_r = len(self.read_ports())
        parts = ([f"{n_w}W"] if n_w else []) + ([f"{n_r}R"] if n_r else [])
        return "+".join(parts)

    def describe(self) -> str:
        """Unambiguous rendering: port count, R/W mix, and the per-port
        roles in service order — ``"3-port[2W+1R|A:W > B:W > C:R]"``.
        :meth:`parse` round-trips this back to a canonical PortConfig."""
        names = "ABCD"
        parts = []
        for p in self.priority:
            if self.enabled[p]:
                parts.append(f"{names[p]}:{'W' if self.roles[p] == WRITE else 'R'}")
        return f"{self.enabled_count}-port[{self.mix()}|{' > '.join(parts)}]"

    @classmethod
    def parse(cls, text: str) -> "PortConfig":
        """Reconstruct a canonical PortConfig from :meth:`describe` output.

        Canonical means: disabled ports get the READ role, and the priority
        permutation is the listed service order followed by the remaining
        port ids in ascending order — enabled set, enabled roles and
        ``service_order()`` all round-trip exactly.
        """
        import re
        names = "ABCD"
        m = re.fullmatch(r"(\d+)-port\[([^|\]]+)\|([^\]]+)\]", text)
        if not m:
            raise ValueError(f"unparseable port description: {text!r}")
        count, mix, order_txt = int(m.group(1)), m.group(2), m.group(3)
        enabled = [False] * MAX_PORTS
        roles = [READ] * MAX_PORTS
        order = []
        for part in order_txt.split(" > "):
            pm = re.fullmatch(r"([ABCD]):([RW])", part.strip())
            if not pm:
                raise ValueError(f"unparseable port entry {part!r} in {text!r}")
            p = names.index(pm.group(1))
            if enabled[p]:
                raise ValueError(f"port {pm.group(1)} listed twice in {text!r}")
            enabled[p] = True
            roles[p] = WRITE if pm.group(2) == "W" else READ
            order.append(p)
        priority = tuple(order) + tuple(p for p in range(MAX_PORTS)
                                        if p not in order)
        cfg = cls(enabled=tuple(enabled), roles=tuple(roles),
                  priority=priority)
        if cfg.enabled_count != count or cfg.mix() != mix:
            raise ValueError(
                f"inconsistent description {text!r}: lists "
                f"{cfg.enabled_count} port(s) with mix {cfg.mix()}")
        return cfg


def quad_port(roles: Sequence[int] = (WRITE, WRITE, READ, READ)) -> PortConfig:
    """All four ports enabled (the paper's flagship 4-port mode)."""
    return PortConfig(enabled=(True,) * 4, roles=tuple(roles))


def single_port(role: int = READ) -> PortConfig:
    """Degenerate 1-port mode — behaves exactly like the bare SRAM macro."""
    return PortConfig(enabled=(True, False, False, False), roles=(role, READ, READ, READ))


@dataclasses.dataclass
class PortRequest:
    """One macro-cycle of traffic for one port.

    Attributes:
      addr: int32[Q]  word addresses.
      data: dtype[Q, W]  write payload (ignored for read ports; zeros by convention).
      mask: bool[Q]   lane validity (a disabled lane issues no transaction).
    """

    addr: torch.Tensor
    data: torch.Tensor
    mask: torch.Tensor

    @property
    def queue_len(self) -> int:
        return self.addr.shape[-1]


def empty_request(queue_len: int, word_width: int, dtype=torch.float32,
                  device="cpu") -> PortRequest:
    """An all-invalid request bundle (for disabled ports)."""
    return PortRequest(
        addr=torch.zeros((queue_len,), dtype=torch.int32, device=device),
        data=torch.zeros((queue_len, word_width), dtype=dtype, device=device),
        mask=torch.zeros((queue_len,), dtype=torch.bool, device=device),
    )


def read_request(addr, word_width: int, dtype=torch.float32,
                 mask=None, device="cpu") -> PortRequest:
    addr = torch.as_tensor(addr, dtype=torch.int32, device=device)
    if mask is None:
        mask = torch.ones(addr.shape, dtype=torch.bool, device=device)
    return PortRequest(addr=addr,
                       data=torch.zeros((*addr.shape, word_width), dtype=dtype,
                                        device=device),
                       mask=torch.as_tensor(mask, dtype=torch.bool,
                                            device=device))


def write_request(addr, data, mask=None) -> PortRequest:
    data = torch.as_tensor(data)
    addr = torch.as_tensor(addr, dtype=torch.int32, device=data.device)
    if mask is None:
        mask = torch.ones(addr.shape, dtype=torch.bool, device=data.device)
    return PortRequest(addr=addr, data=data,
                       mask=torch.as_tensor(mask, dtype=torch.bool,
                                            device=data.device))
