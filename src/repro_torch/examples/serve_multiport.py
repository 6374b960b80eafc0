"""Serving demo: the paper's 4-port wrapper as a continuous-batching engine.

Each engine macro-cycle services EVICT (W) > PREFILL (W) > DECODE (R/W) >
STATUS (R) in priority order — one traversal of the KV-cache state per cycle,
exactly as the wrapper walks its FSM. Compare against --single-port, which
services one port per cycle (the bare-macro baseline).

    PYTHONPATH=src python -m repro_torch.examples.serve_multiport
    PYTHONPATH=src python -m repro_torch.examples.serve_multiport --single-port
    PYTHONPATH=src python -m repro_torch.examples.serve_multiport --device cpu

The JAX package's ``examples/serve_multiport.py`` on the port: reduced
tinyllama-1.1b with seed-0 weights drawn on ``--device`` (the card by
default), the same engine settings and the same requests (drawn by
``np.random.default_rng(0)``). On the card ``--kernel-mode pallas`` runs
the fused CUDA kernels (decode, chunked prefill, the pool step); on the
CPU their plain versions. It prints the kernels' launch counts where the
JAX script has none to print.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import registry
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import init_params
from repro_torch.serve.engine import MultiPortEngine


def main(argv=None, params=None) -> MultiPortEngine:
    """Serves the requests and prints the summary; returns the engine.
    ``params`` replaces the seeded weights (on ``--device``) when given."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.serve_multiport")
    ap.add_argument("--single-port", action="store_true")
    ap.add_argument("--kernel-mode", default="pallas",
                    choices=["pallas", "reference"],
                    help="pallas: fused one-traversal data plane (default); "
                         "reference: two-pass oracle")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    cfg = registry.get("tinyllama-1.1b", reduced=True)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    eng = MultiPortEngine(params, cfg, slots=4, max_len=64, prefill_bucket=8,
                          kernel_mode=args.kernel_mode,
                          single_port=args.single_port, device=dev)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(list(rng.integers(0, cfg.vocab, int(rng.integers(3, 8)))),
                   max_new=args.max_new)

    reset_launch_counts()
    t0 = time.perf_counter()
    while eng.pending_work():
        status = eng.step()
        if status and eng.cycles % 5 == 0:
            print(f"cycle {status['cycle']:4d} queue={status['queue']} "
                  f"active={status['active']} lens={status['lens']}")
    dt = time.perf_counter() - t0

    mode = "single-port" if args.single_port else f"4-port/{args.kernel_mode}"
    toks = sum(len(r.generated) for r in eng.finished)
    print(f"\n[{mode}] {len(eng.finished)} requests, {toks} tokens, "
          f"{eng.cycles} macro-cycles, {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s) on {dev}")
    print(f"pool: {eng.pool_traversals} physical traversals "
          f"({eng.steady_decode_traversals / max(eng.steady_decode_steps, 1):.2f}"
          f" per steady decode step; claim C1: ~1 fused vs 2 two-pass)")
    print("port schedule of the first 6 cycles:",
          [tuple("EPDS"[p] for p in c) for c in eng.port_log[:6]])
    print("kernel launches: " + ", ".join(f"{k} {v}" for k, v in
                                           launch_counts().items()))
    return eng


if __name__ == "__main__":
    main()
