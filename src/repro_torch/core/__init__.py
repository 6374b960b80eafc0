"""Core: the paper's configurable multi-port memory wrapper.

Public API:
  PortConfig / PortRequest / READ / WRITE  — port bundles (ports.py)
  MemorySpec / step / step_banked          — the memory + its semantics (multiport.py)
  build_schedule / simulate_waveform       — clock-generator analogue (clockgen.py)
  baselines                                — single-port / replicated / coded designs
"""
from repro_torch.core.clockgen import (Schedule, build_schedule,
                                       effective_access_rate,
                                       simulate_waveform)
from repro_torch.core.multiport import (MemorySpec, reference_step, step,
                                        step_banked)
from repro_torch.core.ports import (MAX_PORTS, READ, WRITE, PortConfig,
                                    PortRequest, empty_request, quad_port,
                                    read_request, single_port, write_request)

__all__ = [
    "MAX_PORTS", "READ", "WRITE", "PortConfig", "PortRequest",
    "empty_request", "quad_port", "read_request", "single_port", "write_request",
    "MemorySpec", "step", "step_banked", "reference_step",
    "Schedule", "build_schedule", "simulate_waveform", "effective_access_rate",
]
