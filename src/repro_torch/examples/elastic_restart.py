"""Fault-tolerance demo: a training run that crashes twice, restarts from
checkpoints, and finishes with exactly the loss trajectory of an
uninterrupted run (step-addressable data + atomic checkpoints).

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart
    PYTHONPATH=src python -m repro_torch.examples.elastic_restart --device cpu

The JAX package's ``examples/elastic_restart.py`` on the port: reduced
tinyllama-1.1b with seed-0 weights on ``--device`` (the card by default),
40 steps uninterrupted and 40 with failures injected at steps 13 and 27.
The two runs' checkpoints go under ``--work-dir`` (default
``build/repro_torch_examples/elastic_restart``), removed at the end.
"""
from __future__ import annotations

import argparse
import os
import shutil

import torch

from repro_torch import device as _device
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.distributed.fault import FailureInjector
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import RunnerConfig, TrainingRunner
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

DRIFT_LIMIT = 1e-5


def main(argv=None) -> dict:
    """Runs both and asserts the recovery is exact; returns {"restarts",
    "drift"}."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.elastic_restart")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    ap.add_argument("--work-dir", default=os.path.join(
        "build", "repro_torch_examples", "elastic_restart"))
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    cfg = registry.get("tinyllama-1.1b", reduced=True)
    tcfg = TrainConfig(peak_lr=3e-3, warmup_steps=5, total_steps=60,
                       adamw=AdamWConfig(weight_decay=0.0))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = init_train_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    loader = ShardedLoader(cfg, DataConfig(seed=0), batch=8, seq=16,
                           device=dev)

    d1, d2 = (os.path.join(args.work_dir, d) for d in ("clean", "faulty"))
    for d in (d1, d2):
        shutil.rmtree(d, ignore_errors=True)
    try:
        clean = TrainingRunner(step, state, loader.get,
                               RunnerConfig(ckpt_dir=d1, ckpt_every=10,
                                            async_ckpt=False))
        clean.run(40)

        faulty = TrainingRunner(
            step, state, loader.get,
            RunnerConfig(ckpt_dir=d2, ckpt_every=10, async_ckpt=False,
                         heartbeat_dir=os.path.join(d2, "hb")),
            injector=FailureInjector(fail_at_steps=(13, 27)))
        faulty.run(40)

        print(f"restarts: {faulty.restarts} (crashed at steps 13 and 27)")
        a = {h["step"]: h["ce"] for h in clean.history}
        b = {h["step"]: h["ce"] for h in faulty.history}
        drift = max(abs(a[s] - b[s]) for s in range(30, 40))
        print(f"post-restart loss drift vs uninterrupted run: {drift:.2e}")
        assert drift < DRIFT_LIMIT
        print("OK: recovery is exact — checkpoint + step-addressable data.")
    finally:
        shutil.rmtree(d1, ignore_errors=True)
        shutil.rmtree(d2, ignore_errors=True)
    return {"restarts": faulty.restarts, "drift": drift}


if __name__ == "__main__":
    main()
