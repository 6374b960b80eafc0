"""Fault tolerance primitives: heartbeats, straggler detection, failure
injection (for tests), and restart policy.

The coordinator model is file-based (works on any shared filesystem): every worker touches
``<dir>/heartbeat_<worker>`` each step; the monitor flags workers whose last
beat is older than ``timeout_s``. Straggler mitigation is deadline-based:
step durations feed an EMA; a step slower than ``multiplier`` x EMA is logged
as a straggler event and (policy "skip") the runner advances to the next
step's data rather than re-issuing — safe because batches are pure functions
of the step index (data/pipeline.py).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional


class InjectedFailure(RuntimeError):
    """Raised by FailureInjector to simulate a worker crash."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministically fail at the given global steps (tests/demos)."""
    fail_at_steps: tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


class Heartbeat:
    def __init__(self, directory: str, worker: str = "w0"):
        self.path = os.path.join(directory, f"heartbeat_{worker}")
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int) -> None:
        with open(self.path, "w") as f:
            f.write(f"{step} {time.time()}")

    @staticmethod
    def stale_workers(directory: str, timeout_s: float) -> list[str]:
        now = time.time()
        stale = []
        if not os.path.isdir(directory):
            return stale
        for name in os.listdir(directory):
            if not name.startswith("heartbeat_"):
                continue
            with open(os.path.join(directory, name)) as f:
                parts = f.read().split()
            if now - float(parts[1]) > timeout_s:
                stale.append(name.removeprefix("heartbeat_"))
        return stale


@dataclasses.dataclass
class StragglerDetector:
    """EMA-based step-time outlier detection."""
    multiplier: float = 3.0
    ema_decay: float = 0.9
    warmup: int = 3
    _ema: Optional[float] = None
    _n: int = 0
    events: list = dataclasses.field(default_factory=list)

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step was a straggler."""
        self._n += 1
        if self._ema is None:
            self._ema = duration_s
            return False
        is_straggler = (self._n > self.warmup
                        and duration_s > self.multiplier * self._ema)
        if is_straggler:
            self.events.append({"step": step, "duration": duration_s,
                                "ema": self._ema})
        else:  # stragglers don't poison the EMA
            self._ema = (self.ema_decay * self._ema
                         + (1 - self.ema_decay) * duration_s)
        return is_straggler
