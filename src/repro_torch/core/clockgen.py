"""Clock generator — schedule builder for the multi-port wrapper.

Paper mapping (Fig. 3/4, §II-A-5): the clock generator divides the external
clock CLK into N internal slots based on the enabled-port count B1B0. Per
external cycle it emits:

  * ``BACK``  — N pulses: one memory access (SRAM macro strobe) per enabled port;
  * ``CLK2``  — N-1 pulses: the FSM state transitions between consecutive slots;
  * ``CLKP``  — 1 pulse at the CLK posedge: latches port inputs and async-resets
                 the FSM to the highest-priority enabled port.

On an accelerator there is no clock to divide: the "internal slots"
become the sequential service slots inside one kernel traversal. This
module builds that schedule and also provides a cycle-accurate waveform
simulator used by tests to check the paper's Fig. 4 invariants.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.ports import PortConfig


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One macro-cycle's service schedule (the BACK/CLK2 analogue)."""

    slots: tuple[int, ...]        # port id serviced in each internal slot
    n_back_pulses: int            # == len(slots) == N
    n_clk2_pulses: int            # == N - 1 (state transitions between slots)
    b1b0: int                     # 2-bit enabled count encoding (N - 1)

    @property
    def n_ports(self) -> int:
        return self.n_back_pulses


def build_schedule(config: PortConfig) -> Schedule:
    """Expand a PortConfig into the per-macro-cycle service schedule."""
    slots = config.service_order()
    n = len(slots)
    return Schedule(slots=slots, n_back_pulses=n, n_clk2_pulses=n - 1, b1b0=n - 1)


@dataclasses.dataclass
class Waveform:
    """Discrete waveform over internal time steps (numpy, test-only).

    Each external CLK cycle is divided into ``resolution`` internal steps; we
    record pulse trains as 0/1 arrays, mirroring the paper's Fig. 4 signals.
    """

    clk: np.ndarray
    clkp: np.ndarray
    back: np.ndarray
    clk2: np.ndarray
    selected_port: np.ndarray  # port id driving the macro at each internal step


def simulate_waveform(configs: Sequence[PortConfig], resolution: int = 8) -> Waveform:
    """Simulate the clock generator over one external CLK cycle per config.

    Mirrors the paper's Fig. 4 experiment, where successive CLK cycles are
    configured as 4-port, 3-port, 2-port and 1-port.
    """
    n_cycles = len(configs)
    t = n_cycles * resolution
    clk = np.zeros(t, np.int8)
    clkp = np.zeros(t, np.int8)
    back = np.zeros(t, np.int8)
    clk2 = np.zeros(t, np.int8)
    sel = np.full(t, -1, np.int32)

    for c, cfg in enumerate(configs):
        base = c * resolution
        clk[base: base + resolution // 2] = 1          # high half of external clock
        clkp[base] = 1                                  # posedge spike
        sched = build_schedule(cfg)
        n = sched.n_back_pulses
        # N equal internal slots inside this cycle; BACK pulses at each slot
        # start; CLK2 pulses at each slot boundary (N-1 of them).
        slot_starts = [base + (k * resolution) // n for k in range(n)]
        for k, s in enumerate(slot_starts):
            back[s] = 1
            if k > 0:
                clk2[s] = 1
            end = base + ((k + 1) * resolution) // n if k + 1 < n else base + resolution
            sel[s:end] = sched.slots[k]
    return Waveform(clk=clk, clkp=clkp, back=back, clk2=clk2, selected_port=sel)


def effective_access_rate(config: PortConfig, external_clock_hz: float) -> float:
    """The paper's headline metric: memory-access frequency seen by the macro.

    4 enabled ports at CLK=250 MHz => 1 GHz effective access rate (Table II).
    """
    return external_clock_hz * build_schedule(config).n_back_pulses
