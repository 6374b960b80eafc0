"""Training launcher: the checkpointed runner over the train step, on one
device (the card unless ``--device cpu``), or sharded over the production
mesh with one process per mesh position.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 50 --batch 8 --seq 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 8 --batch 8 --seq 1024            # published widths, the card
    torchrun --nproc_per_node 256 -m repro_torch.launch.train \\
        --arch qwen2.5-3b --batch 256 --seq 4096 --mesh production \\
        [--multi-pod] [--compress-grads]

The weights are random, drawn from seed 0 on the device; the data is the
chain task of ``data/pipeline.py`` at seed 0. ``--multi-pod
--compress-grads`` runs the int8 error-feedback mean over 2 pods, whose
per-pod grads are the pod slices of the batch (on one device, the pod
slices of its batch; on the mesh, each pod's own shard).

``--mesh production`` builds the 16 x 16 (``--multi-pod``: 2 x 16 x 16)
mesh over the ``torchrun`` ranks and raises, naming the shape, when the
job has another number of ranks; :func:`train_on_mesh` is everything after
that, for any mesh (``launch.mesh.make_debug_mesh`` in the tests). Ranks
join the backend ``distributed.peermem.choose_backend`` picks from
``torchrun``'s ``LOCAL_WORLD_SIZE`` and ``WORLD_SIZE``: gloo on the CPU,
NCCL with a card a rank, and the peer-memory group
(``distributed/peermem.py``) where the ranks of one host share its cards;
on cards no collective passes through host memory.
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
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
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
    """Parse the command line without building anything."""
    return build_parser().parse_args(argv)


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


def build_on_mesh(args: argparse.Namespace, mesh) -> Setup:
    """``build`` over ``mesh``, one process per mesh position: the seed-0
    parameters drawn once on rank 0 and distributed from there by the JAX
    package's rules (``launch.specs.train_state_pspecs``), the optimizer
    states placed as their parameters by the optimizers' inits, and a
    loader that places each batch by ``sharding.batch_specs``."""
    import torch.distributed as dist

    dev = torch.device(mesh.device_type)
    cfg = arch_config(args)
    tcfg = train_config(args)
    rules = shd.Rules.for_mesh(mesh)
    shapes = SP.params_shapes(cfg)
    specs = shd.param_pspecs(shapes, mesh, rules, cfg=cfg)
    if dist.get_rank() == 0:
        drawn = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    else:                                   # overwritten by rank 0's draw
        drawn = T.tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                                 device=dev), shapes)
    params = T.tree_map(lambda x, s: shd.place(x, mesh, s), drawn, specs)
    del drawn
    bspecs = shd.batch_specs(cfg, mesh, rules, global_batch=args.batch)
    return Setup(cfg, tcfg, init_train_state(params, tcfg),
                 make_train_step(cfg, tcfg),
                 ShardedLoader(cfg, DataConfig(seed=0), batch=args.batch,
                               seq=args.seq, device=dev,
                               shardings=shd.named(mesh, bspecs)), dev)


def init_ranks(args: argparse.Namespace) -> None:
    """Join ``torchrun``'s process group (env://) when it started this
    process and none is joined yet, each rank on its local card modulo the
    cards there are, over ``peermem.choose_backend``'s backend: gloo for
    ``--device cpu``, NCCL with a card a rank, peer memory where ranks
    share a card."""
    import torch.distributed as dist

    from repro_torch.distributed import peermem

    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    dev = _device.resolve(args.device)
    world = int(os.environ["WORLD_SIZE"])
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = peermem.choose_backend(
        dev.type, int(os.environ.get("LOCAL_WORLD_SIZE", world)), cards,
        world)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % cards)
    if backend == peermem.NAME:
        peermem.register()
    dist.init_process_group(backend, init_method="env://")


def _report(args, runner: TrainingRunner, where: str) -> None:
    hist = runner.history
    # a run that resumes at its last step takes none
    median = (f"{statistics.median(h['dt'] for h in hist):.4f}" if hist
              else "none")
    print(f"ce first5={sum(h['ce'] for h in hist[:5])/5:.4f} "
          f"last5={sum(h['ce'] for h in hist[-5:])/5:.4f} "
          f"stragglers={len(runner.straggler.events)} "
          f"step_s median={median} ({where})")


def _run(args, s: Setup, devices: str, where: str, worker: str = "w0",
         speak: bool = True) -> TrainingRunner:
    n = sum(x.numel() for x in T.leaves(s.state["params"]))
    if speak:
        print(f"arch={s.cfg.arch_id} params={n/1e6:.1f}M "
              f"optimizer={args.optimizer} devices={devices}")
    root = ckpt_dir(args)
    runner = TrainingRunner(
        s.step, s.state, s.loader.get,
        RunnerConfig(ckpt_dir=root, ckpt_every=args.ckpt_every,
                     heartbeat_dir=os.path.join(root, "hb"), worker=worker))
    runner.run(args.steps)
    if speak:
        _report(args, runner, where)
    return runner


def train_on_mesh(args: argparse.Namespace, mesh) -> TrainingRunner:
    """Train over ``mesh`` (every rank calls this); rank 0 prints the two
    report lines. Returns the runner."""
    import torch.distributed as dist

    s = build_on_mesh(args, mesh)
    rank = dist.get_rank()
    shape = " x ".join(f"{k} {v}" for k, v in mesh.shape.items())
    where = f"{shape} on {device_name(s.device)}"
    return _run(args, s, f"{mesh.size} ({where})", where,
                worker=f"w{rank}", speak=rank == 0)


def main(argv=None) -> TrainingRunner:
    """Train; returns the runner (its ``history`` holds each step)."""
    args = parse_args(argv)
    if args.mesh == "production":
        init_ranks(args)
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    devices=_device.resolve(args.device))
        return train_on_mesh(args, mesh)
    s = build(args)
    return _run(args, s, f"1 ({device_name(s.device)})",
                device_name(s.device))


if __name__ == "__main__":
    main()
