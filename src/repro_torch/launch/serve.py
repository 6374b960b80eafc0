"""Serving launcher: the multi-port engine over a token-model architecture
of the dense or MoE family.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --no-reduced --requests 4 --max-new 8 [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-moe-16b --no-reduced --requests 4 --max-new 8

Closed loop: every request is submitted up front and the engine runs until
all are served. ``--reduced`` (the default) serves the architecture's small
smoke config; ``--no-reduced`` serves the published one (``--dtype
float32`` serves it in f32). The weights are random, drawn from a fixed
seed; ``--seed`` draws the prompts.

Open loop: requests ARRIVE on a virtual-clock schedule (1 tick = 1 pool
traversal) — seeded Poisson arrivals via ``--arrival-rate``, or a JSONL
trace via ``--trace`` (``repro_torch.serve.traffic.write_trace``). The run
prints TTFT / per-token percentiles in ticks, queue counters, ``--slo``
attainment, and with ``--chaos-seed`` injects a seeded fault plan with
invariant audits after every fault:

    PYTHONPATH=src python -m repro_torch.launch.serve --arrival-rate 0.8 \
        --requests 10 --chaos-seed 23 --slo 40
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import registry
from repro_torch.kernels import launch_counts
from repro_torch.models import KV_FAMILIES, init_params
from repro_torch.serve import traffic
from repro_torch.serve.chaos import ChaosHarness, FaultPlan
from repro_torch.serve.engine import MultiPortEngine


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
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="parameter and compute dtype (default: the "
                         "config's own)")
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
                    help="split-KV decode: run each sequence's decode "
                         "traversal as this many grid-parallel partial-"
                         "attention chains plus an LSE combine (1 = the "
                         "serial kernel; fused decode only)")
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
                    help="open-loop mode: seeded Poisson arrivals at this "
                         "many requests per virtual tick (1 tick = 1 pool "
                         "traversal), heavy-tailed lengths over the "
                         "registry scenario spread, admitted FIFO as slots "
                         "free up")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="open-loop mode: replay a JSONL arrival trace "
                         "(see repro_torch.serve.traffic.write_trace)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="open-loop only: inject a seeded FaultPlan "
                         "(capacity squeezes, mid-stream cancels, delayed "
                         "retirement) with engine/pool invariant audits "
                         "after every fault")
    ap.add_argument("--slo", type=float, default=None, metavar="TICKS",
                    help="p99-TTFT SLO in virtual ticks: print attainment "
                         "with the open-loop latency summary")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the prompts")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and validate the command line without building anything."""
    args = build_parser().parse_args(argv)
    if args.trace is not None and args.arrival_rate is not None:
        raise SystemExit("--trace and --arrival-rate are exclusive")
    if args.chaos_seed is not None and not open_loop(args):
        raise SystemExit("--chaos-seed needs open-loop mode "
                         "(--arrival-rate or --trace)")
    if args.num_kv_splits < 1:
        raise SystemExit(f"--num-kv-splits must be >= 1, "
                         f"got {args.num_kv_splits}")
    if args.kv_shards != 1:
        raise SystemExit("--kv-shards > 1 (multi-device KV) is not ported "
                         "to repro_torch yet — ROADMAP item A8")
    return args


def open_loop(args: argparse.Namespace) -> bool:
    return args.trace is not None or args.arrival_rate is not None


def arch_config(args: argparse.Namespace):
    cfg = registry.get(args.arch, reduced=args.reduced)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} has a stub frontend; serve a token arch")
    if cfg.family not in KV_FAMILIES:
        raise SystemExit(f"{args.arch} is a {cfg.family!r} architecture; the "
                         f"engine serves KV-cache families")
    if args.dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=args.dtype,
                                  compute_dtype=args.dtype)
    return cfg


def _arrivals(args: argparse.Namespace, cfg) -> tuple:
    if args.trace:
        arrivals = traffic.trace_arrivals(args.trace, vocab=cfg.vocab,
                                          seed=args.seed)
    else:
        max_prompt = max(args.max_len - args.max_new, 2)
        arrivals = traffic.poisson_arrivals(
            args.requests, args.arrival_rate, seed=args.seed,
            vocab=cfg.vocab, max_prompt=min(40, max_prompt),
            max_output=args.max_new)
    for a in arrivals:
        if a.prompt_len + a.max_new > args.max_len:
            raise SystemExit(f"arrival ({a.prompt_len}+{a.max_new}) exceeds "
                             f"--max-len {args.max_len}")
    return arrivals


def main(argv=None) -> MultiPortEngine:
    """Serve the requests; returns the engine."""
    return run(parse_args(argv))[0]


def run(args: argparse.Namespace) -> tuple:
    """Serve the requests of parsed ``args``; returns (the engine, the
    chaos harness or None)."""
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
    moe = cfg.moe
    experts = (f", {moe.n_experts} experts top-{moe.top_k} of {moe.d_expert}"
               f" + {moe.n_shared} shared" if moe is not None else "")
    print(f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads{experts}, vocab {cfg.vocab}, "
          f"{cfg.param_dtype} on {args.device}")
    print(f"length-bounded staging buckets (seq_tile={seq_tile}, "
          f"S_max={args.max_len}, {grid}): {list(buckets)}")
    if args.num_kv_splits > 1:
        print(f"split-KV decode: {args.num_kv_splits} partial chains per "
              f"sequence + LSE combine (fused decode path)")
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
                          num_kv_splits=args.num_kv_splits,
                          schedule_mode=args.schedule_mode,
                          max_ports=args.max_ports,
                          default_ttl_ticks=args.deadline,
                          max_queue_depth=args.max_queue_depth,
                          prefix_cache=not args.no_prefix_cache,
                          device=dev)
    harness = None
    if open_loop(args):
        arrivals = _arrivals(args, cfg)
        print(f"open-loop: {len(arrivals)} arrivals over ticks "
              f"[{arrivals[0].arrival_tick}, {arrivals[-1].arrival_tick}]"
              if arrivals else "open-loop: empty schedule")
        if args.chaos_seed is not None:
            horizon = (arrivals[-1].arrival_tick + 1) if arrivals else 1
            harness = ChaosHarness(
                FaultPlan.generate(args.chaos_seed, horizon=horizon))
        t0 = time.perf_counter()
        traffic.drive(eng, arrivals, on_cycle=harness)
        if harness is not None:
            harness.finalize(eng)
        done = eng.finished
    else:
        rng = np.random.default_rng(args.seed)
        for _ in range(args.requests):
            eng.submit([int(t) for t in
                        rng.integers(0, cfg.vocab, int(rng.integers(3, 10)))],
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
    if open_loop(args):
        _open_loop_report(args, eng, harness)
    elif eng.shed:
        print(f"overload: shed {len(eng.shed)} (deadline "
              f"{eng.shed_deadline}, queue_full {eng.shed_queue_full}, "
              f"capacity {eng.shed_capacity})")
    for r in done[:4]:
        print(f"  req {r.rid}: prompt={_short(r.prompt)} -> {r.generated}")
    return eng, harness


def _short(prompt: list) -> str:
    if len(prompt) <= 12:
        return str(prompt)
    return f"[{', '.join(map(str, prompt[:8]))}, ... ({len(prompt)} tokens)]"


def _open_loop_report(args, eng: MultiPortEngine, harness) -> None:
    done = eng.finished
    ttft = np.array([r.ttft_ticks for r in done if r.ttft_ticks is not None],
                    dtype=np.float64)
    tpot = np.array([r.tpot_ticks for r in done if r.tpot_ticks is not None],
                    dtype=np.float64)
    if ttft.size:
        line = (f"latency (virtual ticks, 1 tick = 1 pool traversal): "
                f"TTFT p50/p99 {np.percentile(ttft, 50):.1f}/"
                f"{np.percentile(ttft, 99):.1f}")
        if tpot.size:
            line += (f"; per-token p50/p99 {np.percentile(tpot, 50):.2f}/"
                     f"{np.percentile(tpot, 99):.2f}")
        print(line)
    print(f"queue: peak depth {eng.admission.peak_depth}, "
          f"slot-contention cycles {eng.slot_contention_cycles}, "
          f"evict-pressure admissions {eng.evict_pressure_admissions}, "
          f"total ticks {eng.vclock}")
    if eng.shed or eng.cancelled or eng.capacity_parked_cycles:
        print(f"overload: shed {len(eng.shed)} "
              f"(deadline {eng.shed_deadline}, queue_full "
              f"{eng.shed_queue_full}, capacity {eng.shed_capacity}), "
              f"capacity parked/recovered "
              f"{eng.capacity_parked_cycles}/{eng.capacity_recoveries}, "
              f"cancelled {eng.cancelled}")
    if harness is not None:
        print(f"chaos [seed {args.chaos_seed}]: "
              f"{len(harness.injected)} actions, "
              f"{harness.invariant_checks} invariant audits clean, "
              f"stalled retirements {eng.stalled_retirements}, "
              f"straggler events {harness.straggler_events}")
    if args.slo is not None and ttft.size:
        met = int((ttft <= args.slo).sum())
        print(f"SLO (p99 TTFT <= {args.slo:g} ticks): "
              f"{'MET' if np.percentile(ttft, 99) <= args.slo else 'MISSED'}"
              f" — {met}/{ttft.size} requests within SLO")


if __name__ == "__main__":
    main()
