"""Training launcher: the checkpointed runner over the train step, on one
device (the card unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 50 --batch 8 --seq 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 8 --batch 8 --seq 1024            # published widths, the card

The weights are random, drawn from seed 0 on the device; the data is the
chain task of ``data/pipeline.py`` at seed 0. ``--multi-pod
--compress-grads`` runs the int8 error-feedback mean over 2 pods, whose
per-pod grads are the pod slices of the batch on this one device.
``--mesh production`` is not ported (ROADMAP A8b/A11).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics

import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import RunnerConfig, TrainingRunner
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adamw8bit", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "production"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: build/repro_torch_train/<run>, one "
                         "directory per arch, width, optimizer and "
                         "gradient compression")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and validate the command line without building anything."""
    args = build_parser().parse_args(argv)
    if args.mesh == "production":
        raise SystemExit("--mesh production (a sharded mesh) is not ported "
                         "to repro_torch yet — ROADMAP items A8b/A11")
    return args


def ckpt_dir(args: argparse.Namespace) -> str:
    """``--ckpt-dir``, else a directory of its own for each train state's
    shape, so that a run resumes only its own checkpoints."""
    if args.ckpt_dir is not None:
        return args.ckpt_dir
    run = (f"{args.arch}-{'reduced' if args.reduced else 'full'}-"
           f"{args.optimizer}")
    if args.compress_grads:
        run += f"-int8ef{train_config(args).n_pods}"
    return os.path.join("build", "repro_torch_train", run)


def arch_config(args: argparse.Namespace):
    """Every registered arch trains, as in the JAX launcher."""
    return registry.get(args.arch, reduced=args.reduced)


def train_config(args: argparse.Namespace) -> TrainConfig:
    n_pods = 2 if args.multi_pod else 1
    return TrainConfig(optimizer=args.optimizer, peak_lr=args.lr,
                       warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       grad_compression=("int8_ef" if args.compress_grads
                                         else None),
                       n_pods=n_pods if args.compress_grads else 1,
                       adamw=AdamWConfig())


@dataclasses.dataclass
class Setup:
    cfg: object
    tcfg: TrainConfig
    state: dict
    step: object
    loader: ShardedLoader
    device: torch.device


def build(args: argparse.Namespace) -> Setup:
    """Config, seed-0 parameters and train state on the device, the train
    step and the loader."""
    dev = _device.resolve(args.device)
    cfg = arch_config(args)
    tcfg = train_config(args)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return Setup(cfg, tcfg, init_train_state(params, tcfg),
                 make_train_step(cfg, tcfg),
                 ShardedLoader(cfg, DataConfig(seed=0), batch=args.batch,
                               seq=args.seq, device=dev), dev)


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))


def main(argv=None) -> TrainingRunner:
    """Train; returns the runner (its ``history`` holds each step)."""
    args = parse_args(argv)
    s = build(args)
    n = sum(x.numel() for x in T.leaves(s.state["params"]))
    print(f"arch={s.cfg.arch_id} params={n/1e6:.1f}M "
          f"optimizer={args.optimizer} devices=1 ({device_name(s.device)})")
    root = ckpt_dir(args)
    runner = TrainingRunner(
        s.step, s.state, s.loader.get,
        RunnerConfig(ckpt_dir=root, ckpt_every=args.ckpt_every,
                     heartbeat_dir=os.path.join(root, "hb")))
    runner.run(args.steps)
    hist = runner.history
    # a run that resumes at its last step takes none
    median = (f"{statistics.median(h['dt'] for h in hist):.4f}" if hist
              else "none")
    print(f"ce first5={sum(h['ce'] for h in hist[:5])/5:.4f} "
          f"last5={sum(h['ce'] for h in hist[-5:])/5:.4f} "
          f"stragglers={len(runner.straggler.events)} "
          f"step_s median={median} ({device_name(s.device)})")
    return runner


if __name__ == "__main__":
    main()
