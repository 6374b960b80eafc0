"""Quickstart: train a tiny llama-family model on the synthetic chain task.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The JAX package's ``examples/quickstart.py`` on the port: reduced
tinyllama-1.1b, seed-0 weights drawn on ``--device`` (the card by
default), AdamW at a 2e-3 peak, batch 8 x 32.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)


def main(argv=None) -> list:
    """Trains and prints every tenth step; returns each step's metrics as
    floats."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    cfg = registry.get("tinyllama-1.1b", reduced=True)
    tcfg = TrainConfig(peak_lr=2e-3, warmup_steps=5, total_steps=60,
                       adamw=AdamWConfig(weight_decay=0.0))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = init_train_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    loader = ShardedLoader(cfg, DataConfig(seed=0), batch=8, seq=32,
                           device=dev)

    print(f"arch={cfg.arch_id}  params="
          f"{sum(x.numel() for x in T.leaves(params)):,}  device={dev}")
    history = []
    for i in range(args.steps):
        state, metrics = step(state, loader.get(i))
        history.append({k: float(v) for k, v in metrics.items()})
        if i % 10 == 0:
            print(f"step {i:3d}  ce={history[-1]['ce']:.4f}  "
                  f"acc={history[-1]['accuracy']:.3f}  "
                  f"gnorm={history[-1]['grad_norm']:.3f}")
    print("done — loss should have dropped by >1 nat.")
    return history


if __name__ == "__main__":
    main()
