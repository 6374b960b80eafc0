"""Serving launcher: the multi-port engine over a token-model architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --no-reduced --requests 4 --max-new 8 [--device cuda]

Closed loop: every request is submitted up front and the engine runs until
all are served. ``--reduced`` (the default) serves the architecture's small
smoke config; ``--no-reduced`` serves the published one. The weights are
random, drawn from a fixed seed; ``--seed`` draws the prompts.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import registry
from repro_torch.kernels import launch_counts
from repro_torch.models import init_params
from repro_torch.serve.engine import MultiPortEngine

# flags of the JAX launcher whose machinery has not been ported yet, and
# the ROADMAP item that brings each
_NOT_PORTED = {
    "arrival_rate": ("--arrival-rate", "A6b (open-loop traffic and chaos)"),
    "trace": ("--trace", "A6b (open-loop traffic and chaos)"),
    "chaos_seed": ("--chaos-seed", "A6b (open-loop traffic and chaos)"),
    "slo": ("--slo", "A6b (open-loop traffic and chaos)"),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced smoke config (--no-reduced "
                         "serves the published one)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="initial slot-table size")
    ap.add_argument("--max-slots", type=int, default=64,
                    help="slot-table growth bound (continuous batching)")
    ap.add_argument("--chunk-tokens", type=int, default=16,
                    help="prefill chunk size (tokens per admission per cycle)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seq-tile", type=int, default=None,
                    help="KV-cache tile size for length-bounded traversals "
                         "(default: min(64, max_len)); validated against "
                         "--max-len's bucket ladder at startup")
    ap.add_argument("--no-length-bound", action="store_true",
                    help="disable live-length bounding (every staged tile "
                         "counts as read — the unbounded baseline)")
    ap.add_argument("--no-dynamic-grid", action="store_true",
                    help="stage a bucketed live prefix instead of the full "
                         "padded capacity")
    ap.add_argument("--num-kv-splits", type=int, default=1,
                    help="split-KV decode (only 1 is ported)")
    ap.add_argument("--kv-shards", type=int, default=1,
                    help="shard the paged KV pool across devices (only 1 "
                         "is ported)")
    ap.add_argument("--single-port", action="store_true")
    ap.add_argument("--kernel-mode", default="pallas",
                    choices=["pallas", "reference"],
                    help="'pallas': the fused kernels and the pool-step "
                         "kernel; 'reference': the two-pass oracles")
    ap.add_argument("--schedule-mode", default="ooo",
                    choices=["static", "ooo"],
                    help="macro-cycle port scheduler: 'ooo' co-schedules "
                         "non-hazarding phases into shared pool traversals; "
                         "'static' keeps one traversal per phase")
    ap.add_argument("--max-ports", type=int, default=4,
                    help="per-traversal port budget (1-4, the paper's B1B0 "
                         "knob); 1 degrades the attention compute to the "
                         "two-pass oracle")
    ap.add_argument("--deadline", type=float, default=None, metavar="TICKS",
                    help="admission TTL in virtual ticks: a request still "
                         "queued past arrival+TTL is shed")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="bound the admission queue; submissions beyond it "
                         "are shed immediately")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable refcounted prefix sharing (tokens are "
                         "identical either way)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="open-loop Poisson arrivals (not ported yet)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="open-loop trace replay (not ported yet)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="fault injection (not ported yet)")
    ap.add_argument("--slo", type=float, default=None, metavar="TICKS",
                    help="open-loop p99 TTFT SLO report (not ported yet)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the prompts")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and validate the command line without building anything."""
    args = build_parser().parse_args(argv)
    for key, (flag, item) in _NOT_PORTED.items():
        if getattr(args, key) is not None:
            raise SystemExit(f"{flag} is not ported to repro_torch yet — "
                             f"ROADMAP item {item}")
    if args.num_kv_splits != 1:
        raise SystemExit("--num-kv-splits > 1 (split-KV decode) is not "
                         "ported to repro_torch yet — ROADMAP item B4")
    if args.kv_shards != 1:
        raise SystemExit("--kv-shards > 1 (multi-device KV) is not ported "
                         "to repro_torch yet — ROADMAP item A8")
    return args


def arch_config(args: argparse.Namespace):
    cfg = registry.get(args.arch, reduced=args.reduced)
    if cfg.family != "dense" or cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} is a {cfg.family!r} architecture; "
                         f"repro_torch serves the dense family (ROADMAP A9)")
    return cfg


def main(argv=None) -> MultiPortEngine:
    """Serve ``--requests`` closed-loop requests; returns the engine."""
    args = parse_args(argv)
    cfg = arch_config(args)
    seq_tile = (min(64, args.max_len) if args.seq_tile is None
                else args.seq_tile)
    try:
        buckets = MultiPortEngine.final_stage_ladder(args.max_len, seq_tile)
    except ValueError as e:
        raise SystemExit(f"--seq-tile: {e}")
    if seq_tile > args.max_len:
        print(f"--seq-tile {seq_tile} exceeds --max-len {args.max_len}; "
              f"clamping to {args.max_len} (the engine's own clamp)")
        seq_tile = args.max_len
    grid = "bucketed" if args.no_dynamic_grid else "dynamic-grid"
    print(f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}, "
          f"{cfg.param_dtype} on {args.device}")
    print(f"length-bounded staging buckets (seq_tile={seq_tile}, "
          f"S_max={args.max_len}, {grid}): {list(buckets)}")
    dev = _device.resolve(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    eng = MultiPortEngine(params, cfg, slots=args.slots,
                          max_slots=max(args.max_slots, args.slots),
                          max_len=args.max_len,
                          chunk_tokens=args.chunk_tokens,
                          kernel_mode=args.kernel_mode,
                          single_port=args.single_port,
                          seq_tile=seq_tile,
                          length_bound=not args.no_length_bound,
                          dynamic_grid=not args.no_dynamic_grid,
                          schedule_mode=args.schedule_mode,
                          max_ports=args.max_ports,
                          default_ttl_ticks=args.deadline,
                          max_queue_depth=args.max_queue_depth,
                          prefix_cache=not args.no_prefix_cache,
                          device=dev)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        eng.submit([int(t) for t in rng.integers(0, cfg.vocab,
                                                 int(rng.integers(3, 10)))],
                   max_new=args.max_new)
    t0 = time.perf_counter()
    done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    mode = "single-port" if args.single_port else "multi-port"
    print(f"[{mode}] {len(done)} requests, {toks} tokens, "
          f"{eng.cycles} macro-cycles, {dt:.2f}s ({toks/max(dt,1e-9):.1f} tok/s)")
    print(f"pool traversals: {eng.pool_traversals} "
          f"({eng.pool_traversals / max(toks, 1):.2f}/token); "
          f"slots grown to {eng.n_slots}/{eng.max_slots}; prefill "
          f"{eng.prefill_traversals / max(eng.prefill_tokens, 1):.3f} "
          f"traversals/prompt-token over {eng.prefill_steps} chunk cycles; "
          f"{eng.decode_steps} decode cycles")
    counts = ", ".join(f"{k} {v}" for k, v in launch_counts().items())
    print(f"kernel launches: {counts}")
    mixes = ", ".join(f"{k}: {v}" for k, v in
                      sorted(eng.pool.mix_counts.items()))
    print(f"schedule [{eng.schedule_mode}, max_ports={eng.max_ports}]: "
          f"{eng.coscheduled_cycles}/{eng.multi_phase_cycles} multi-phase "
          f"cycles co-scheduled (frac {eng.coschedule_frac:.2f}); "
          f"traversal mixes {{{mixes}}}")
    print(f"tile reads (seq_tile={eng.seq_tile}): decode "
          f"{eng.steady_decode_tile_reads} steady "
          f"(bound {eng.steady_decode_tile_bound}), prefill "
          f"{eng.prefill_tile_reads / max(eng.prefill_chunks, 1):.2f}/chunk "
          f"vs {-(-args.max_len // eng.seq_tile)} dense; pool "
          f"r/w {eng.pool.tile_reads}/{eng.pool.tile_writes}")
    if eng.prefix_cache:
        ps = eng.prefix_stats
        print(f"prefix cache: {ps['hits']}/{ps['lookups']} admissions "
              f"attached a resident prefix ({ps['attached_tokens']} tokens "
              f"/ {ps['attached_pages']} pages adopted without recompute); "
              f"copy-on-write splits {ps['cow_copies']} "
              f"({ps['cow_words']} words copied)")
    if eng.shed:
        print(f"overload: shed {len(eng.shed)} (deadline "
              f"{eng.shed_deadline}, queue_full {eng.shed_queue_full}, "
              f"capacity {eng.shed_capacity})")
    for r in done[:4]:
        print(f"  req {r.rid}: prompt={r.prompt} -> {r.generated}")
    return eng


if __name__ == "__main__":
    main()
