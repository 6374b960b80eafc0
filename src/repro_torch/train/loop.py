"""Training runner: checkpointed, heartbeat-monitored, straggler-aware,
restartable loop around a train step.

Restart semantics: on any failure the runner restores the latest checkpoint
and resumes at the step after it. Because batches are pure functions of the
step index, a restarted run consumes exactly the data it would have — no
loader state to recover. The step is functional (``train_step.py``), so
``init_state`` stays as given and two runners may share it.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint import ckpt
from repro_torch.distributed.fault import (FailureInjector, Heartbeat,
                                           InjectedFailure, StragglerDetector)

PyTree = Any


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str = os.path.join("build", "repro_torch_ckpt")
    ckpt_every: int = 50
    keep_last: int = 3
    max_restarts: int = 3
    async_ckpt: bool = True
    heartbeat_dir: Optional[str] = None
    worker: str = "w0"


class TrainingRunner:
    def __init__(self, step_fn: Callable, init_state: PyTree,
                 get_batch: Callable[[int], dict], rcfg: RunnerConfig,
                 *, injector: Optional[FailureInjector] = None,
                 straggler: Optional[StragglerDetector] = None):
        self.step_fn = step_fn
        self.init_state = init_state
        self.get_batch = get_batch
        self.rcfg = rcfg
        self.injector = injector
        self.straggler = straggler or StragglerDetector()
        self.saver = ckpt.AsyncSaver() if rcfg.async_ckpt else None
        self.heartbeat = (Heartbeat(rcfg.heartbeat_dir, rcfg.worker)
                          if rcfg.heartbeat_dir else None)
        self.history: list[dict] = []
        self.restarts = 0

    # -- checkpoint plumbing -------------------------------------------------
    def _save(self, step: int, state: PyTree) -> None:
        if self.saver is not None:
            self.saver.save(self.rcfg.ckpt_dir, step, state,
                            keep_last=self.rcfg.keep_last)
        else:
            ckpt.save(self.rcfg.ckpt_dir, step, state,
                      keep_last=self.rcfg.keep_last)

    def _restore_or_init(self) -> tuple[PyTree, int]:
        last = ckpt.latest_step(self.rcfg.ckpt_dir)
        if last is None:
            return self.init_state, 0
        state, manifest = ckpt.restore(self.rcfg.ckpt_dir, self.init_state,
                                       step=last)
        return state, manifest["step"] + 1

    # -- main loop -----------------------------------------------------------
    def run(self, n_steps: int) -> PyTree:
        state, start = self._restore_or_init()
        step = start
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                batch = self.get_batch(step)
                state, metrics = self.step_fn(state, batch)
                # Python floats: waits for the device, as JAX's
                # block_until_ready does there
                record = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0

                if self.heartbeat:
                    self.heartbeat.beat(step)
                lagging = self.straggler.record(step, dt)
                self.history.append(
                    {"step": step, "dt": dt, "straggler": lagging, **record})
                if step % self.rcfg.ckpt_every == 0:
                    self._save(step, state)
                step += 1
            except InjectedFailure:
                self.restarts += 1
                if self.restarts > self.rcfg.max_restarts:
                    raise
                if self.saver is not None:
                    self.saver.wait()
                state, step = self._restore_or_init()
        self._save(n_steps - 1, state)
        if self.saver is not None:
            self.saver.wait()
        return state
