"""End-to-end example: train a ~100M-parameter qwen2-family model for a few
hundred steps with the full production loop — checkpointing, heartbeats,
straggler detection, restart-safe data.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300 \\
        --batch 4
    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 2 \\
        --batch 1 --seq 64 --device cpu

The JAX package's ``examples/train_100m.py`` on the port: the same
config (:func:`config_100m`) and loop, seed-0 weights on ``--device``
(the card by default), asynchronous checkpoints every 50 steps and
heartbeats under ``--ckpt`` (default
``build/repro_torch_examples/train_100m``). It prints the median step
time and, on the card, the peak memory.
"""
from __future__ import annotations

import argparse
import os
import statistics

import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import RunnerConfig, TrainingRunner
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)


def config_100m() -> ArchConfig:
    """~100M params: 12L, d=768, GQA 12/4 heads, untied head, 32k vocab."""
    return ArchConfig(
        arch_id="repro-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32_000, qkv_bias=True,
        q_chunk=256, remat="block")


def main(argv=None) -> TrainingRunner:
    """Trains and prints the summary; returns the runner (its ``history``
    holds each step)."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.train_100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(
        "build", "repro_torch_examples", "train_100m"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    cfg = config_100m()
    tcfg = TrainConfig(peak_lr=6e-4, warmup_steps=20, total_steps=args.steps,
                       adamw=AdamWConfig(weight_decay=0.1))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n = sum(x.numel() for x in T.leaves(params))
    print(f"params: {n/1e6:.1f}M on {dev}")

    state = init_train_state(params, tcfg)
    del params
    step = make_train_step(cfg, tcfg)
    loader = ShardedLoader(cfg, DataConfig(seed=0), batch=args.batch,
                           seq=args.seq, device=dev)
    runner = TrainingRunner(
        step, state, loader.get,
        RunnerConfig(ckpt_dir=args.ckpt, ckpt_every=50, async_ckpt=True,
                     heartbeat_dir=os.path.join(args.ckpt, "hb")))
    del state
    runner.run(args.steps)
    ce = [h["ce"] for h in runner.history]
    k = max(min(10, len(ce)), 1)        # a run resumed at its end took none
    print(f"ce: first10={sum(ce[:k])/k:.3f}  last10={sum(ce[-k:])/k:.3f}")
    print(f"straggler events: {len(runner.straggler.events)}")
    dts = [h["dt"] for h in runner.history]
    median = f"{statistics.median(dts):.4f}" if dts else "none"
    peak = (f", peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
            f" GiB" if dev.type == "cuda" else "")
    print(f"step_s median={median} over {len(dts)} steps{peak} ({dev})")
    return runner


if __name__ == "__main__":
    main()
