#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # needs one CUDA device

Phases (any failure exits non-zero before the final line):

1. print the card (``nvidia-smi``) and build the CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. hold each kernel against its plain torch version on the card at the
   serving path's shapes (full tinyllama-1.1b, launcher defaults): f32 with
   TF32 off at 1e-5, bf16 queries at 4e-2, ragged lengths, a dead row,
   appends at 0 and at tile edges, tile counts identical, the pool step
   bit-exact on port mixes whose ports hit the same words in every hazard
   order (W->R, R->W, W->W), with Q = 8192 and most lanes off, and with
   a payload on each write slot and a result for each read slot only. The
   split-KV pair (stage 1 + stage 2) is held
   against its plain version at the long-context shapes (caches
   [4, 2048, 4, 64], seq_tile 64, num_kv_splits 2, 4, 8), and its caches
   and tile counts against the serial kernel's; num_kv_splits=1 launches
   the serial kernel only. Flash attention (B5) is held against its plain
   version at 2e-5 (f32, the CUDA-core kernel) / 5e-2 (bf16, the
   tensor-core kernel): causal and full, Sq != Sk both ways, Sq and Sk off
   the 64/128 tiles (200, 333), G of 1, 3, 7 and 8, D of 16, 48, 64 and
   128, a batch of 3, tiles of 32-128, Sq = q_tile, each call launching its
   route's kernel once; a non-divisible shape raises before any launch;
3. serve 4 requests x 8 new tokens of tinyllama-1.1b at full width (bf16,
   as published; random weights from a fixed seed) through
   ``repro_torch.launch.serve`` and check that the path went through the
   kernels: decode launches = 22 x decode cycles, chunk launches = 22 x
   prefill cycles, pool-step launches = pool traversals. The inputs of each
   kernel's most frequent call on that path are kept; on them the kernel is
   held against its plain version once more and timed (CUDA events over a
   queue of launches, median of batches) beside the plain version, the
   one-call PyTorch yardstick and the bound from bytes and operations;
4. serve the long-context split-KV path the same way: 4 prompts of
   1500-2000 tokens replayed from a trace (``--max-len 2048
   --chunk-tokens 128 --num-kv-splits 8``), split launches = 22 x decode
   cycles, serial decode launches 0; on the path's decode call time the
   serial kernel and the split pair at 2, 4 and 8 splits (stage 2 launched
   behind stage 1 by programmatic dependent launch) beside the stages
   timed apart, the chunk kernel on that path's own chunk call (C = 128
   over a 2K context) and the pool step on that path's largest call (the
   last cycle's scrub of every live word) and on its largest decode
   gather, each beside the previous design's time;
4b. serve the same trace at the launcher's default ``--num-kv-splits 1``:
   serial decode launches = 22 x decode cycles, split launches 0, greedy
   tokens identical to the split run; the serial kernel (one clustered
   launch) is timed on that path's own decode call beside its bound, SDPA
   and its previous design, with its cluster size and how many such
   clusters the card holds at once;
5. the whole-prompt dense path at the same full width in f32 (TF32 off):
   ``forward`` over 2 x 2048 tokens, ``prefill`` of the first 1024 and 8
   teacher-forced fused decode steps, whose logits match ``forward``'s at
   the same positions (atol 3e-3, rtol 1e-3) with identical argmax. While
   ``forward`` runs, flash attention computes every layer's attention
   through ``ops.flash_attention`` on that layer's own q, k, v, held
   against the model's ``chunked_causal_attention`` and its plain version
   at 2e-5: launches = 22 (flash, the 3xTF32 kernel), 0 (flash_tc) and
   22 x 8 (decode). Layers 0 and 21 are then held against the plain
   version in f32 and cast to bf16, and layer 0's inputs time the kernel
   beside its plain version, SDPA and the bound (3xTF32 at the TF32 peak,
   the f32 CUDA-core bound beside it);
5b. the whole-prompt path at the published bf16: ``forward`` over 2 x 2048
   tokens with the tensor-core kernel computing every layer's attention,
   held against ``chunked_causal_attention`` and the plain version at
   5e-2: launches = 22 (flash_tc), 0 (flash). Layer 0's inputs time it;
   so do bf16 q/k/v at qwen2-vl-7b's heads (G = 7, D = 128, 2048
   positions, seed 0);
6. check that greedy tokens are identical between the fused kernels and
   the two-pass reference, and between split and serial decode on a
   long-prompt trace, at the same full width in f32 (TF32 off);
7. serve an open-loop Poisson schedule at full width in f32, fault-free
   and under the seeded chaos plan 23: every invariant audit clean, every
   request served or shed exactly once, survivors' tokens identical to the
   fault-free run;
7b. serve deepseek-moe-16b at its published widths (bf16, 28 layers, 64
   routed experts top-6 of 1408 + 2 shared, random weights from seed 0)
   through the launcher at the short path's settings: every request
   served, B1 = 28 x decode cycles, B2 = 28 x prefill cycles, B3 =
   traversals, split pair and flash 0; one decode cycle's 28 MoE layers
   timed on their own inputs (and the expert einsums alone) beside their
   byte bound; peak memory;
7c. B1, B2 and B3 on that path's calls (G 1, D 128; B3 on its largest
   decode gather at a 114688-float word), each held against its plain
   version and timed beside its bound and library call;
7d. the MoE tokens in f32 (TF32 off) at the published widths and 2 of the
   28 layers (f32 fits only so): fused == reference == split 2;
7e. qwen2-vl-7b (M-RoPE, embedding input) and musicgen-large (sinusoidal
   positions, embedding input), one after the other, through the model
   entry points: ``prefill_chunk`` of 128 seeded embedding rows x 2 and 8
   ``decode_step``s at the published widths in bf16 (B2 = L, B1 = 8 L,
   logits finite), then in f32 at 2 layers multiport == reference
   (argmax, 1e-4), and qwen2-vl-7b's ``forward`` == ``prefill`` on a
   4 x 4 patch grid's (t, h, w) positions;
7i. zamba2-7b (hybrid: 13 groups of a shared attention block, G 1 and D
   112, before 6 Mamba2 blocks, + 3 tail blocks) and rwkv6-3b (ssm),
   one after the other, through the model entry points at the published
   widths in bf16: ``prefill`` of 4 x 1024 seeded tokens and 16 multiport
   ``decode_step``s, logits finite (zamba2: B1 = 13 x 16 and every other
   counter 0, then at num_kv_splits=8 the split pair 13 x 16 and B1 0;
   rwkv6-3b: no launch), peak memory, the prefill's host clock and a
   decode step's device time beside the weight-read bound; one rwkv6-3b
   prefill under ``torch.profiler`` (the linear-scan engine's share). B1
   and the split pair at ns 2, 4 and 8 on zamba2's decode call, held
   against their plain versions (4e-2) and timed beside them, SDPA and
   the bound. In f32 at reduced depth (zamba2-7b 13 slots, rwkv6-3b 2
   layers), TF32 off: prefill + decode == forward (atol 3e-3, rtol 1e-3),
   zamba2 multiport == reference (2e-4 / 1e-4, argmax identical), split
   ns 8 == serial greedy tokens, card == CPU on one forward (1e-4). Then
   2 AdamW steps of each through ``launch.train`` (rwkv6-3b at 8 of 32
   layers, zamba2-7b at 7 of 81 slots), losses finite, no launch;
7j. the paper's comparison designs (``core/baselines.py``) on the long
   path's pool geometry (8192 words of 11264 f32): every enable x role mix
   of 4 ports at Q = 8192 lanes a port, addresses that hit the same words
   in every hazard order, under seeded priorities: SinglePortNPass,
   ReplicatedReads(3) and XorCoded equal ``multiport.step`` and the pool
   step kernel bit for bit (XorCoded: its banks flattened; its parity the
   sum of its banks within 1e-5); the tensor priority encoder, FSM
   transition and walk order over 15 masks x 24 permutations, captured in
   one CUDA graph, equal their static counterparts; the 1W+3R mix timed
   four ways (B3 as one traversal of 4 ports, B3 as 4 single-port
   traversals, SinglePortNPass and ReplicatedReads(3) as ported) beside
   the bytes each moves, the bound, the traffic counters and the
   footprint ratios next to the paper's 4x bandwidth and 1.3x / 2x area;
7k. data-parallel KV: tinyllama-1.1b at full width served by a
   ``MultiPortEngine`` built directly over
   ``make_kv_mesh(4, devices=[cuda:0] * 4)`` (4 virtual shards of the
   card: 4 storage shards, each kernel launched once per shard on its row
   block), with the launcher's settings and requests, on the short closed
   loop and on the long trace at ``--num-kv-splits 8``: B1 (or B4a and
   B4b) = 22 x decode cycles x 4, B2 = 22 x prefill cycles x 4, B3 =
   traversals x 4; per-device steady tile reads sum to the total and
   balance >= 1; on each path a shard's own calls of B1 (or the split
   pair), B2 and B3 held against their plain versions and timed beside
   the unsharded calls of this run;
   in f32 (TF32 off) the 4-shard greedy tokens equal phase 6's 1-shard
   tokens;
8. sharded training over a data x model mesh (``launch.train``'s
   ``build_on_mesh``: DTensors placed by the JAX package's rules), with
   ranks that share the card (``launch.local_ranks``, one process each,
   the peer-memory group of ``distributed/peermem.py``, which
   ``local_ranks`` chooses for ranks that share a card: each rank's slot
   on the card mapped by every peer through CUDA IPC, no operand through
   host memory); each rank asserts that its group is ``peermem`` and
   reports the bytes it moved on the card (written to its slot, read from
   the slots) and the write-fence-read-fence rounds:
8a. 4 ranks: every collective DTensor issues, plain and functional, on
   CUDA tensors (f32 and int8 all-reduce, all-gather, reduce-scatter,
   all-to-all) == its local reduction;
8b. tinyllama-1.1b at its published widths (bf16, AdamW, batch 8 x 1024)
   over (data 2, model 2), 4 ranks: 2 steps, the first step's ce within
   4e-2 of phase 7f's one-device first step; each step's time beside
   the recorded and this run's one-device step, each rank's peak memory and
   state bytes, and each collective's bytes a step;
8c. f32 at 2 of the 22 layers, TF32 off, 4 ranks: the sharded step on
   (data 2, model 2) == one device (ce rtol 1e-5, ``lm_head/w`` atol 2e-5
   / rtol 1e-4, the JAX multidevice test's tolerances); the compressed
   step (int8_ef, 2 pods) on (pod 2, data 1, model 2) == one device's,
   with the int8 all-reduce across the pods counted; the state saved on
   (2, 2), restored onto (data 2, model 1) by 2 ranks, takes the next
   step with the ce of the run that goes on at (2, 2) (rtol 1e-5);
8d. the dry run (``launch/dryrun.py``), in this process: 8b's step traced
   by ``launch.op_analysis`` on fake CUDA tensors as rank 0 of a counting
   world of 4 (``distributed/countgroup.py``), no hints: every collective's
   calls and bytes == rank 0's tally of one 8b step in its group's
   ``STATS`` exactly,
   and the predicted arguments + temporaries within 15 % of rank 0's peak
   in one 8b step after the first; then ``run_cell`` of every shape of
   tinyllama-1.1b on the 256-rank mesh and of llama3-405b ``train_4k`` on
   the 512-rank one, each ``ok`` and traced on the card's path, printed
   as predictions; the ``train_4k`` cells of deepseek-moe-16b, rwkv6-3b
   and zamba2-7b on the 256-rank mesh, each traced by ``python -m
   repro_torch.launch.dryrun`` in a process of its own started after the
   build (the recurrent families' eager scans trace for minutes on the
   host's cores while the card runs the other phases), each ``ok`` on the
   card's path, read once 8f is done;
8e. deepseek-moe-16b (2 of 28 layers), rwkv6-3b (8 of 32) and zamba2-7b
   (7 of 81 slots) at their published widths (bf16, AdamW, batch 4 x
   512: phases 7f and 7i's runs) over (data 2, model 2), 4 ranks, one job
   each: one step, its ce within 4e-2 of that phase's one-device first
   step; each rank's step seconds, peak memory and collective bytes;
8f. the five non-dense families in f32 at 2 layers (zamba2-7b at 7
   slots, so that its shared attention block runs), TF32 off, batch 4 x
   256: one sharded step on (data 2, model 2) == the same step on one
   device, computed in this process before the ranks start (ce rtol
   1e-5, ``lm_head/w`` atol 2e-5 / rtol 1e-4);
9. time the launch floor (an empty kernel launched through ctypes like
   the others) and print how far the short calls of B1 and B3 lie above
   it;
10. print the kernel table as JSON, the card's name and power limit, and
   finally ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12              # f32 outside the tensor cores: the
                                    # kernels' arithmetic is f32 FMA
H100_BF16_FLOPS = 989e12            # bf16 tensor cores, dense: the least
                                    # time for bf16 inputs
H100_TF32_FLOPS = 495e12            # TF32 tensor cores, dense: B5's f32
                                    # route takes 3 TF32 products per f32
                                    # one in P V
# earlier designs' times (ms) on the calls timed below, from PERF.md's
# kernel table (NVIDIA H100 80GB HBM3, 700.00 W): printed beside this run's
PREVIOUS_MS = {"pool short": 0.01007, "pool long": 1.62133,
               "split partial": 0.03365, "split combine": 0.00654,
               "split pair": {2: 0.05047, 4: 0.02981, 8: 0.02185},
               "decode short": 0.00606, "decode long": 0.21770,
               "flash f32": 1.66050, "flash f32 3xtf32": 0.93017}
F32_TOL, BF16_TOL = 1e-5, 4e-2
# flash attention: the JAX suite's flash tolerances
# (tests/kernels/test_attention_kernels.py, sweep and bf16 cases)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
# prefill/decode against forward: the JAX suite's decode-equivalence
# tolerance (tests/models/test_decode_equiv.py); f32 sums taken in another
# order (chunked matmuls vs the fused decode kernel) through 22 layers
PROMPT_TOL = dict(atol=3e-3, rtol=1e-3)
SPLITS = (2, 4, 8)                  # the long-context sweep
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "kv_decode_append_attend": ("src/repro_torch/csrc/kv_multiport.cu",
                                "src/repro/kernels/kv_multiport.py:92"),
    "kv_decode_split_partial": ("src/repro_torch/csrc/kv_multiport_split.cu",
                                "src/repro/kernels/kv_multiport.py:180"),
    "kv_decode_split_combine": ("src/repro_torch/csrc/kv_multiport_split.cu",
                                "src/repro/kernels/kv_multiport.py:294"),
    "kv_chunk_append_attend": ("src/repro_torch/csrc/kv_prefill_chunk.cu",
                               "src/repro/kernels/kv_prefill_chunk.py:55"),
    "multiport_sram_step": ("src/repro_torch/csrc/multiport_sram.cu",
                            "src/repro/kernels/multiport_sram.py:42"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:26"),
    "flash_attention_tc": ("src/repro_torch/csrc/flash_attention_tc.cu",
                           "src/repro/kernels/flash_attention.py:26"),
}
FLASH_ROUTE = {torch.float32: "flash_attention",      # the f32 kernel
               torch.bfloat16: "flash_attention_tc"}  # bf16 tensor cores


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _ms(fn, reps: int = 20, batches: int = 5) -> float:
    """Device time of one call: CUDA events around a queue of ``reps``
    calls, divided by ``reps``; the median over ``batches``. A spin kernel
    keeps the card busy while the host queues the calls, so the host's
    per-call work is not counted unless the call itself waits on the card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)                 # ~25 ms of spin
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _graph_ms(fn) -> float:
    """The device time of one call alone, without the host issuing its
    kernels: ``fn`` captured once as a CUDA graph, its replay timed by
    ``_ms``."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _ms(graph.replay, reps=5, batches=5)


def _profiled(fn, module=None, name: str | None = None) -> dict:
    """One call of ``fn`` under ``torch.profiler``; with ``module`` and
    ``name``, each call of ``module.name`` inside a ``record_function``
    range of that name. Returns the host clock (ms, around
    ``torch.cuda.synchronize()``), the kernels' device time summed and
    their count (the range's own device-side annotation left out), the
    operators as (their own kernels' device ms, calls, name), largest
    first, and the range's device ms, host ms and calls (None without a
    range)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    if module is not None:
        inner = getattr(module, name)

        def annotated(*a, **kw):
            with record_function(name):
                return inner(*a, **kw)
        setattr(module, name, annotated)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if module is not None:
            setattr(module, name, inner)

    def own_ms(e, field="self_device_time_total"):
        return getattr(e, field, getattr(e, field.replace("device", "cuda"),
                                         0)) / 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.key != name]
    ops = sorted(((own_ms(e), e.count, e.key) for e in events
                  if e.device_type != DeviceType.CUDA and own_ms(e) > 0),
                 reverse=True)
    ranged = [e for e in events
              if e.key == name and e.device_type != DeviceType.CUDA]
    return {"wall_ms": wall_ms, "busy_ms": sum(own_ms(e) for e in kernels),
            "kernels": sum(e.count for e in kernels), "ops": ops,
            "range": (own_ms(ranged[0], "device_time_total"),
                      ranged[0].cpu_time_total / 1e3, ranged[0].count)
            if ranged else None}


def _bound_ms(nbytes: float, flops: float,
              peak: float = H100_F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _agree(a: torch.Tensor, b: torch.Tensor, atol: float, rtol: float,
           what: str) -> float:
    """The largest |a - b|; raises unless |a - b| <= atol + rtol |b|
    everywhere and both are finite."""
    a, b = a.float(), b.float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError(f"{what}: non-finite values")
    diff = (a - b).abs()
    if bool((diff > atol + rtol * b.abs()).any()):
        raise AssertionError(f"{what}: max |diff| {float(diff.max()):.3g} "
                             f"beyond atol {atol} / rtol {rtol}")
    return float(diff.max())


def _clones(args) -> tuple:
    """Copies of a call's arguments: tensors, and lists of tensors."""
    def clone(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, (list, tuple)):
            return type(a)(clone(x) for x in a)
        return a
    return tuple(clone(a) for a in args)


def _shape_key(a):
    """A hashable stand-in for an argument: its shape (or its items')."""
    if torch.is_tensor(a):
        return tuple(a.shape)
    if isinstance(a, (list, tuple)):
        return tuple(_shape_key(x) for x in a)
    return a


# ---- phase 2: each kernel against its plain version ---------------------

def _decode_agree(args, kw) -> float:
    """Kernel and plain version on copies of the same inputs: caches and
    tile counts identical; returns the largest output difference."""
    from repro_torch.kernels import kv_multiport as kvmp
    a, p = _clones(args), _clones(args)
    o, _, _, t = kvmp.fused_append_attend(*a, return_tiles=True, **kw)
    tile, n = kvmp.launch_geometry(a[1].shape[1], kw.get("seq_tile", 128),
                                   kw.get("live_len"),
                                   kw.get("dynamic_grid", False))
    o_p, t_p = kvmp.fused_append_attend_plain(
        *p, seq_tile=tile, n_tiles=n, length_mask=kw.get("length_mask", True))
    torch.cuda.synchronize()
    if not (torch.equal(a[1], p[1]) and torch.equal(a[2], p[2])):
        raise AssertionError("decode: cache update differs from plain")
    if not torch.equal(t, t_p):
        raise AssertionError(f"decode: tiles {t.tolist()} != {t_p.tolist()}")
    return _err(o, o_p)


def _chunk_agree(args, kw) -> float:
    from repro_torch.kernels import kv_multiport as kvmp
    from repro_torch.kernels import kv_prefill_chunk as kvpc
    a, p = _clones(args), _clones(args)
    o, _, _, t = kvpc.fused_chunk_append_attend(*a, return_tiles=True, **kw)
    tile, n = kvmp.launch_geometry(a[1].shape[1], kw.get("seq_tile", 128),
                                   kw.get("live_len"),
                                   kw.get("dynamic_grid", False))
    o_p, t_p = kvpc.fused_chunk_append_attend_plain(*p, seq_tile=tile,
                                                    n_tiles=n)
    torch.cuda.synchronize()
    if not (torch.equal(a[1], p[1]) and torch.equal(a[2], p[2])):
        raise AssertionError("chunk: cache update differs from plain")
    if not torch.equal(t, t_p):
        raise AssertionError(f"chunk: tiles {t.tolist()} != {t_p.tolist()}")
    return _err(o, o_p)


def _pool_agree(args, kw) -> float:
    """Kernel and plain version on copies of the same inputs: storage and
    reads bit-identical, one launch."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import multiport_sram as mps
    a, p = _clones(args), _clones(args)
    before = launch_counts()["multiport_sram_step"]
    r_k = mps.multiport_sram_step(*a, **kw)
    if launch_counts()["multiport_sram_step"] != before + 1:
        raise AssertionError("pool step: not one launch per call")
    r_p = mps.multiport_sram_step_plain(*p, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(a[0], p[0]) and torch.equal(r_k, r_p)):
        raise AssertionError(f"pool step differs from plain for {kw}")
    return 0.0


def check_decode(dev, gen) -> dict:
    """B1 against its plain version: the short path's geometry (128
    positions, tile 64) at tile edges, p = 0, the last position and a dead
    row, every mode; and the long path's (caches [*, 2048, 4, 64], tile 64)
    at the card's own cluster size, with the long call's 16 (row, kv head)
    clusters and with 12, where clusters of 8 fit."""
    hkv, g, d, s, tile = 4, 8, 64, 128, 64          # full tinyllama, defaults

    def case(lens, qdt, cdt=torch.float32, s=s):
        b = len(lens)
        rnd = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa: E731
        return (rnd(b, hkv * g, d).to(qdt), rnd(b, s, hkv, d).to(cdt),
                rnd(b, s, hkv, d).to(cdt), rnd(b, hkv, d).to(cdt),
                rnd(b, hkv, d).to(cdt),
                torch.tensor(lens, dtype=torch.int32, device=dev))

    edges = [0, tile - 1, tile, tile + 1, s - 1, -1, 17, 100]
    f32, bf = torch.float32, torch.bfloat16
    errs = {"f32": max(_decode_agree(case(edges, f32), dict(seq_tile=tile)),
                       _decode_agree(case(edges, f32),
                                     dict(seq_tile=tile, length_mask=False)),
                       _decode_agree(case(edges, f32),
                                     dict(seq_tile=tile, live_len=64)),
                       _decode_agree(case(edges, f32),
                                     dict(seq_tile=tile, dynamic_grid=True))),
            "bf16": max(_decode_agree(case(edges, bf), dict(seq_tile=tile)),
                        _decode_agree(case(edges, bf, bf),
                                      dict(seq_tile=tile)))}
    taken = {}
    for lens in ([1932, 1788, 1795, 1552], [2047, 1536, -1]):
        kw = dict(seq_tile=tile, dynamic_grid=True)
        for name, qdt in (("long_f32", f32), ("long_bf16", bf)):
            args = case(lens, qdt, s=2048)
            c, clusters, _ = cluster_plan(args, kw)
            taken[clusters] = c
            errs[name] = max(errs.get(name, 0.0), _decode_agree(args, kw))
    if (max(errs["f32"], errs["long_f32"]) > F32_TOL
            or max(errs["bf16"], errs["long_bf16"]) > BF16_TOL):
        raise AssertionError(f"decode kernel disagrees: {errs}")
    print(f"check kv_decode_append_attend at the long geometry: clusters of "
          f"{taken[16]} blocks for 16 (row, kv head) clusters, of "
          f"{taken[12]} for 12; max |diff| f32 {errs['long_f32']:.3g}, "
          f"bf16 q {errs['long_bf16']:.3g}")
    return errs


def _split_agree(args, kw, ns: int) -> tuple[float, float]:
    """The split pair, its plain version and the serial kernel on copies
    of the same inputs: caches and tile counts identical across the three,
    the split call launching the split pair only. Returns the largest
    output difference to the plain split version and to the serial
    kernel."""
    from repro_torch.kernels import kv_multiport as kvmp
    from repro_torch.kernels import launch_counts
    a, p, one = _clones(args), _clones(args), _clones(args)
    before = launch_counts()
    o, _, _, t = kvmp.fused_append_attend(*a, num_kv_splits=ns,
                                          return_tiles=True, **kw)
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    want = {k: 0 for k in ran}
    want.update(kv_decode_split_partial=1, kv_decode_split_combine=1)
    if ran != want:
        raise AssertionError(f"num_kv_splits={ns} launched {ran}")
    tile, n = kvmp.launch_geometry(a[1].shape[1], kw.get("seq_tile", 128),
                                   kw.get("live_len"),
                                   kw.get("dynamic_grid", False))
    o_p, t_p = kvmp.fused_append_attend_split_plain(
        *p, seq_tile=tile, n_tiles=n, length_mask=kw.get("length_mask", True),
        num_kv_splits=ns)
    o_1, _, _, t_1 = kvmp.fused_append_attend(*one, return_tiles=True, **kw)
    torch.cuda.synchronize()
    for other in (p, one):
        if not (torch.equal(a[1], other[1]) and torch.equal(a[2], other[2])):
            raise AssertionError(f"split {ns}: cache update differs")
    if not (torch.equal(t, t_p) and torch.equal(t, t_1)):
        raise AssertionError(f"split {ns}: tiles {t.tolist()} != "
                             f"{t_p.tolist()} / {t_1.tolist()}")
    return _err(o, o_p), _err(o, o_1)


def _combine_agree(acc, stats, dtype) -> float:
    """Stage 2 alone against its plain version on the same partials."""
    from repro_torch.kernels import kv_multiport as kvmp
    out = kvmp.split_combine(acc, stats, dtype)
    out_p = kvmp.split_combine_plain(acc, stats, dtype)
    torch.cuda.synchronize()
    return _err(out, out_p)


def check_split(dev, gen) -> dict:
    """Long-context shapes: full tinyllama heads, caches [4, 2048, 4, 64]
    f32, seq_tile 64 (the launcher's), the engine's dynamic grid."""
    from repro_torch.kernels import kv_multiport as kvmp
    from repro_torch.kernels import launch_counts
    hkv, g, d, s, tile = 4, 8, 64, 2048, 64

    def case(lens, qdt):
        b = len(lens)
        rnd = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa: E731
        return (rnd(b, hkv * g, d).to(qdt), rnd(b, s, hkv, d),
                rnd(b, s, hkv, d), rnd(b, hkv, d), rnd(b, hkv, d),
                torch.tensor(lens, dtype=torch.int32, device=dev))

    # a dead row, an append at 0, rows shorter than one split, the tile
    # edges 63/64/65 and the last position
    lens_sets = ([-1, 0, 100, s - 1], [tile - 1, tile, tile + 1, 1500])
    kw = dict(seq_tile=tile, dynamic_grid=True)
    errs = {"f32": 0.0, "f32_vs_serial": 0.0, "bf16": 0.0, "combine": 0.0}
    for lens in lens_sets:
        for ns in SPLITS:
            e_p, e_1 = _split_agree(case(lens, torch.float32), kw, ns)
            errs["f32"] = max(errs["f32"], e_p)
            errs["f32_vs_serial"] = max(errs["f32_vs_serial"], e_1)
            e_p, _ = _split_agree(case(lens, torch.bfloat16), kw, ns)
            errs["bf16"] = max(errs["bf16"], e_p)
            args = case(lens, torch.float32)
            acc, st, _ = kvmp.split_partials(
                *args, seq_tile=tile, n_tiles=s // tile, length_mask=True,
                num_kv_splits=ns)
            errs["combine"] = max(errs["combine"],
                                  _combine_agree(acc, st, torch.float32))
    e_p, e_1 = _split_agree(case(lens_sets[0], torch.float32),
                            dict(seq_tile=tile, length_mask=False), 4)
    errs["f32"] = max(errs["f32"], e_p)
    errs["f32_vs_serial"] = max(errs["f32_vs_serial"], e_1)
    if (max(errs["f32"], errs["f32_vs_serial"], errs["combine"]) > F32_TOL
            or errs["bf16"] > BF16_TOL):
        raise AssertionError(f"split-KV kernels disagree: {errs}")
    before = launch_counts()
    kvmp.fused_append_attend(*case(lens_sets[0], torch.float32),
                             num_kv_splits=1, **kw)
    ran = {k: v - before[k] for k, v in launch_counts().items() if v - before[k]}
    if ran != {"kv_decode_append_attend": 1}:
        raise AssertionError(f"num_kv_splits=1 launched {ran}")
    return errs


def check_chunk(dev, gen) -> dict:
    hkv, g, d, s, c, tile = 4, 8, 64, 128, 16, 64

    def case(off, cl, qdt):
        b = len(off)
        rnd = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa: E731
        i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
        return (rnd(b, c, hkv * g, d).to(qdt), rnd(b, s, hkv, d),
                rnd(b, s, hkv, d), rnd(b, c, hkv, d), rnd(b, c, hkv, d),
                i32(off), i32(cl))

    off = [0, tile - 1, tile, tile + 1, 100, -1, 17, 48]
    cl = [16, 1, 16, 5, 16, 0, 9, 0]
    f32, bf = torch.float32, torch.bfloat16
    errs = {"f32": max(_chunk_agree(case(off, cl, f32), dict(seq_tile=tile)),
                       _chunk_agree(case(off, cl, f32),
                                    dict(seq_tile=tile, live_len=64)),
                       _chunk_agree(case(off, cl, f32),
                                    dict(seq_tile=tile, dynamic_grid=True))),
            "bf16": _chunk_agree(case(off, cl, bf), dict(seq_tile=tile))}
    if errs["f32"] > F32_TOL or errs["bf16"] > BF16_TOL:
        raise AssertionError(f"chunk kernel disagrees: {errs}")
    return errs


def check_pool_step(dev, gen) -> dict:
    """The pool step bit-exact against its plain version on the full
    tinyllama pool: later ports hit half of port 0's words, so each mix
    checks its hazard orders (W->R, R->W, W->W); Q = 8192 with most lanes
    off, as the long path's decode gathers and scrubs are; bf16 storage;
    a row that is not a whole number of 16-byte moves."""
    from repro_torch.core.ports import READ, WRITE
    words, width = 8192, 22 * 2 * 4 * 64            # full tinyllama pool
    storage = torch.randn((words, width), generator=gen, device=dev)

    def ports(st, roles, q, lanes_on):
        p = len(roles)
        addr = torch.randint(0, st.shape[0], (p, q), generator=gen,
                             device=dev, dtype=torch.int32)
        addr[1:, : q // 2] = addr[0, : q // 2]      # later ports hit port 0's
        mask = torch.zeros((p, q), dtype=torch.bool, device=dev)
        for s, (r, on) in enumerate(zip(roles, lanes_on)):
            mask[s, :on] = True
            if r == WRITE:                          # dedup write lanes
                a = addr[s].tolist()
                last = {w: i for i, w in enumerate(a)}
                mask[s] &= torch.tensor([last[w] == i for i, w in enumerate(a)],
                                        device=dev)
        data = [torch.randn((q, st.shape[1]), generator=gen,
                            device=dev).to(st.dtype)
                for r in roles if r == WRITE]
        return st, addr, data, mask

    R, W = READ, WRITE
    cases = [((W, R, W, R), 64, (48,) * 4),           # W->R, R->W, W->W
             ((W, W, R), 128, (128,) * 3),             # W->W then W->R
             ((R, W, R), 256, (256, 200, 256)),        # R->W->R on one word
             ((R, R, W), 64, (64,) * 3),               # R->R needs no barrier
             ((R,), 16, (9,)),
             ((W, R), 8192, (4, 7080)),                # a decode gather
             ((W,), 8192, (7080,)),                    # a scrub
             ((R,), 8192, (9,))]                       # most lanes off
    for roles, q, on in cases:
        _pool_agree(ports(storage, roles, q, on), dict(roles=roles))
    half = storage[:, :-1].contiguous()     # 11263 f32: 4-byte moves
    _pool_agree(ports(half, (W, R, W), 512, (400,) * 3), dict(roles=(W, R, W)))
    bf = storage[:1024].to(torch.bfloat16)
    _pool_agree(ports(bf, (W, R, W, R), 256, (200,) * 4),
                dict(roles=(W, R, W, R)))
    return {"exact": 0.0}


def check_flash(dev, gen) -> dict:
    """Flash attention against its plain version: causal and full; Sq != Sk
    both ways (top-left mask); G 1, 3, 7, 8; D 16, 48, 64, 128; Sq and Sk
    off the tensor-core kernel's 64/128 tiles; a batch of 3; tiles of 32,
    64, 128; Sq = q_tile; f32 also at q and k 3.5-4x N(0, 1) (scores of
    tens, where the softmax amplifies any rounding of the scores); one
    launch per call, f32 on the f32 kernel and bf16 on the tensor-core one;
    a non-divisible shape raises before any launch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts, ops
    cases = [  # b, h, hkv, sq, sk, d, q_tile, k_tile
        (2, 32, 4, 256, 256, 64, 128, 128), (1, 4, 4, 128, 256, 16, 64, 64),
        (1, 8, 1, 256, 128, 128, 64, 128), (2, 8, 8, 128, 128, 128, 128, 64),
        (1, 6, 2, 96, 160, 48, 32, 32), (1, 4, 2, 200, 333, 16, 200, 333),
        (3, 6, 2, 333, 200, 48, 333, 200), (1, 7, 1, 200, 333, 128, 200, 333)]
    errs = {"f32": 0.0, "bf16": 0.0}
    calls = {name: 0 for name in FLASH_ROUTE.values()}
    before = launch_counts()
    for b, h, hkv, sq, sk, d, qt, kt in cases:
        for causal in (True, False):
            for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                rnd = lambda *sh: torch.randn(sh, generator=gen,  # noqa: E731
                                              device=dev).to(dt)
                q, k, v = rnd(b, h, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d)
                got = ops.flash_attention(q, k, v, causal=causal, q_tile=qt,
                                          k_tile=kt)
                calls[FLASH_ROUTE[dt]] += 1
                want = fa.flash_attention_plain(q, k, v, causal=causal)
                tol = FLASH_TOL[dt]
                errs[name] = max(errs[name], _agree(
                    got, want, tol, tol, f"flash_attention {name} causal="
                    f"{causal} q {tuple(q.shape)} k {tuple(k.shape)}"))
    # the f32 route at scores of tens: q and k 3-4x N(0, 1), v 3-4x
    for b, h, hkv, sq, sk, d, qt, kt in cases[:1] + cases[-2:]:
        for qk, vs in ((3.5, 3.0), (4.0, 4.0)):
            rnd = lambda *sh: torch.randn(sh, generator=gen,  # noqa: E731
                                          device=dev)
            q, k, v = (rnd(b, h, sq, d) * qk, rnd(b, hkv, sk, d) * qk,
                       rnd(b, hkv, sk, d) * vs)
            got = ops.flash_attention(q, k, v, causal=True, q_tile=qt,
                                      k_tile=kt)
            calls[FLASH_ROUTE[torch.float32]] += 1
            errs["f32"] = max(errs["f32"], _agree(
                got, fa.flash_attention_plain(q, k, v, causal=True),
                FLASH_TOL[torch.float32], FLASH_TOL[torch.float32],
                f"flash_attention f32 at q, k {qk}x N(0, 1), v {vs}x, q "
                f"{tuple(q.shape)} k {tuple(k.shape)}"))
    q = torch.zeros((1, 4, 96, 16), device=dev)
    try:
        ops.flash_attention(q, q[:, :2], q[:, :2], q_tile=64)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention took Sq=96 with q_tile=64")
    torch.cuda.synchronize()
    _expect_flash_calls(before, calls)
    return errs


def _expect_flash_calls(before: dict, calls: dict) -> None:
    """Each flash route launched exactly the calls sent to it since
    ``before``."""
    from repro_torch.kernels import launch_counts
    now = launch_counts()
    ran = {name: now[name] - before[name] for name in calls}
    if ran != calls:
        raise AssertionError(f"flash launches {ran} != calls made {calls}")


# ---- phase 3: the serving path, and each kernel timed on its inputs -----

class MainPathCapture:
    """Keeps, while the main path runs, a copy of the inputs of each
    kernel wrapper's most frequent call shape (its latest such call), taken
    before the call: the kernels update caches and storage in place. The
    hook only copies; the wrapper it calls is the one the path calls."""

    def __init__(self):
        self.calls: dict = {}
        self._undo: list = []

    def hook(self, module, attr: str, name: str) -> None:
        orig = getattr(module, attr)

        def hooked(*args, **kw):
            key = (_shape_key(args), tuple(sorted(kw.items())))
            slot = self.calls.setdefault(name, {}).setdefault(key, [0, None])
            slot[0] += 1
            slot[1] = (_clones(args), dict(kw))
            return orig(*args, **kw)

        setattr(module, attr, hooked)
        self._undo.append((module, attr, orig))

    def restore(self) -> None:
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()

    def typical(self, name: str) -> tuple:
        return max(self.calls[name].values(), key=lambda s: s[0])[1]

    def largest(self, name: str, size) -> tuple:
        """The kept call whose ``size(args, kw)`` is largest."""
        return max((s[1] for s in self.calls[name].values()),
                   key=lambda call: size(*call))


def _drive(serve_fn) -> tuple:
    """Run ``serve_fn()`` with every launch count set to 0 just before it
    and read just after it, capturing the kernel calls it makes. Returns
    (its result, launch counts, the captured kernel calls)."""
    from repro_torch.kernels import kv_multiport as kvmp
    from repro_torch.kernels import kv_prefill_chunk as kvpc
    from repro_torch.kernels import launch_counts, multiport_sram as mps
    from repro_torch.kernels import reset_launch_counts
    cap = MainPathCapture()
    cap.hook(kvmp, "fused_append_attend", "decode")
    cap.hook(kvpc, "fused_chunk_append_attend", "chunk")
    cap.hook(mps, "multiport_sram_step", "pool")
    try:
        reset_launch_counts()
        got = serve_fn()
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        cap.restore()
    return got, counts, cap


def serve_path(argv: list) -> tuple:
    """Drive one serving path through the launcher. Returns (engine, chaos
    harness or None, launch counts, the captured kernel calls)."""
    from repro_torch.launch import serve
    (eng, harness), counts, cap = _drive(
        lambda: serve.run(serve.parse_args(argv)))
    return eng, harness, counts, cap


def serve_mesh(argv: list, mesh) -> tuple:
    """Build ``MultiPortEngine`` over ``mesh`` directly, with the launcher's
    settings for ``argv``, and serve the launcher's requests for them (its
    closed-loop prompts, or the trace) through ``_drive``. Returns (engine,
    launch counts, the captured kernel calls)."""
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    from repro_torch.serve import traffic
    from repro_torch.serve.engine import MultiPortEngine
    args = serve.parse_args(argv)
    cfg = serve.arch_config(args)
    dev = torch.device("cuda")

    def run():
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        eng = MultiPortEngine(params, cfg, mesh=mesh, device=dev,
                              **serve.engine_kwargs(args))
        if args.trace:
            traffic.drive(eng, traffic.trace_arrivals(
                args.trace, vocab=cfg.vocab, seed=args.seed))
        else:
            for prompt in serve.closed_loop_prompts(args, cfg.vocab):
                eng.submit(prompt, max_new=args.max_new)
            eng.run()
        return eng
    return _drive(run)


def expect_launches(eng, counts: dict) -> None:
    """The path went through its kernels: one decode launch (the serial
    kernel, or the split pair) per layer per decode cycle, one chunk
    launch per layer per prefill cycle, one pool step per traversal; each
    once per kv shard (every shard launches on its own rows, dead padding
    rows included, and services every traversal on its own storage)."""
    L, n = eng.cfg.n_layers, eng.n_kv_shards
    dec = L * eng.decode_steps * n
    split = eng.num_kv_splits > 1
    want = {"kv_decode_append_attend": 0 if split else dec,
            "kv_decode_split_partial": dec if split else 0,
            "kv_decode_split_combine": dec if split else 0,
            "kv_chunk_append_attend": L * eng.prefill_steps * n,
            "multiport_sram_step": eng.pool.traversals * n,
            "flash_attention": 0, "flash_attention_tc": 0}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if not (dec and eng.prefill_steps and eng.pool.traversals):
        raise AssertionError(f"a kernel of the path never ran: {counts}")
    shards = f" x {n} kv shards" if n > 1 else ""
    print(f"serve: launch counters {counts} match {L} x {eng.decode_steps} "
          f"decode cycles, {L} x {eng.prefill_steps} prefill cycles, "
          f"{eng.pool.traversals} pool traversals{shards}")


def expect_served(eng, n: int, max_new: int) -> None:
    done = eng.finished
    if len(done) != n or any(len(r.generated) != max_new or
                             not all(0 <= t < eng.cfg.vocab
                                     for t in r.generated) for r in done):
        raise AssertionError(f"serve run did not produce {n} x {max_new} "
                             f"valid tokens")
    shards = eng.pool.storage if eng.pool.sharded else (eng.pool.storage,)
    if eng.pool.utilization != 0.0 or any(float(s.abs().max())
                                          for s in shards):
        raise AssertionError("pool not drained and scrubbed after the run")


def _tokens(eng) -> dict:
    return {r.rid: tuple(r.generated) for r in eng.finished}


FULL = ["--arch", "tinyllama-1.1b", "--no-reduced", "--device", "cuda"]


def serve_full_width() -> tuple:
    eng, _, counts, cap = serve_path(FULL + ["--requests", "4", "--max-new",
                                             "8", "--seed", "0"])
    expect_launches(eng, counts)
    expect_served(eng, 4, 8)
    return counts, cap


def write_long_trace(path: Path, lo: int, hi: int, seed: int) -> None:
    """4 arrivals at ticks 0-3, prompts of lo..hi-1 tokens over the served
    config's vocabulary, 8 new tokens each."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.serve import traffic
    vocab = serve.arch_config(serve.parse_args(FULL)).vocab
    rng = np.random.default_rng(seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    traffic.write_trace(str(path), [
        traffic.Arrival(arrival_tick=i, prompt=tuple(
            int(t) for t in rng.integers(0, vocab, int(rng.integers(lo, hi)))),
            max_new=8, scenario="long-context") for i in range(4)])


LONG = ["--max-len", "2048", "--max-slots", "4", "--chunk-tokens", "128"]


LONG_TRACE = ROOT / "build" / "chip_smoke" / "long_2k.jsonl"


def serve_long_context() -> tuple:
    """Returns (launch counts, captured calls, greedy tokens, the pool's
    MemorySpec)."""
    write_long_trace(LONG_TRACE, 1500, 2001, seed=0)
    eng, _, counts, cap = serve_path(FULL + LONG + [
        "--num-kv-splits", "8", "--trace", str(LONG_TRACE)])
    expect_launches(eng, counts)
    expect_served(eng, 4, 8)
    return counts, cap, _tokens(eng), eng.pool.spec


def serve_long_serial(split_tokens: dict) -> tuple:
    """The long trace at the launcher's default ``--num-kv-splits 1``:
    the serial kernel on every decode, the split pair never, and the split
    run's greedy tokens."""
    eng, _, counts, cap = serve_path(FULL + LONG + ["--trace",
                                                    str(LONG_TRACE)])
    if eng.num_kv_splits != 1:
        raise AssertionError(f"the default ran {eng.num_kv_splits} splits")
    expect_launches(eng, counts)
    expect_served(eng, 4, 8)
    toks = _tokens(eng)
    if toks != split_tokens:
        raise AssertionError(f"serial and split tokens differ on the long "
                             f"trace: {toks} != {split_tokens}")
    print(f"long context at --num-kv-splits 1: tokens identical to "
          f"--num-kv-splits 8 over {sum(map(len, toks.values()))} greedy "
          f"tokens")
    return counts, cap


def cluster_plan(args, kw) -> tuple:
    """(cluster size the serial kernel takes on this decode call, the
    (row, kv head) clusters it launches, {size: clusters the card holds at
    once})."""
    from repro_torch.kernels import kv_multiport as kvmp
    q, ck = args[0], args[1]
    b, s, hkv, d = ck.shape
    tile, n = kvmp.launch_geometry(s, kw.get("seq_tile", 128),
                                   kw.get("live_len"),
                                   kw.get("dynamic_grid", False))

    def fit(c):
        return kvmp.cluster_fit(q.shape[1] // hkv, d, q.dtype, ck.dtype, c)
    c = kvmp.cluster_size(n, tile, rows=b * hkv, fit=fit)
    return c, b * hkv, {k: fit(k) for k in range(1, kvmp.MAX_CLUSTER + 1)}


def _sdpa(q, k, v, mask):
    """The one-call PyTorch yardstick: attention alone (no append)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def _decode_library_ms(args) -> float:
    """The one-call PyTorch yardstick on a decode call's inputs: SDPA over
    the same keys, attention alone (no append)."""
    q, ck, cv, _, _, ln = args
    kpos = torch.arange(ck.shape[1], device=q.device)
    mask = (kpos[None] <= ln[:, None].long())[:, None, None, :]
    # q in the caches' dtype: f32 on the serving paths, bf16 on zamba2-7b's
    qc, kt, vt = (q.to(ck.dtype)[:, :, None], ck.transpose(1, 2),
                  cv.transpose(1, 2))
    return _ms(lambda: _sdpa(qc, kt, vt, mask))


def time_decode(args, kw) -> dict:
    from repro_torch.kernels import kv_multiport as kvmp
    q, ck, ln = args[0], args[1], args[5]
    s, d = ck.shape[1], ck.shape[3]
    h = q.shape[1]
    tile, n = kvmp.launch_geometry(s, kw.get("seq_tile", 128),
                                   kw.get("live_len"),
                                   kw.get("dynamic_grid", False))
    err = _decode_agree(args, kw)
    tol = F32_TOL if q.dtype == ck.dtype == torch.float32 else BF16_TOL
    if err > tol:
        raise AssertionError(f"decode kernel on the timed call [q {q.dtype}, "
                             f"caches {tuple(ck.shape)} {ck.dtype}]: max "
                             f"|diff| {err:.3g} beyond {tol}")
    ms = _ms(lambda: kvmp.fused_append_attend(*args, **kw))
    plain_ms = _ms(lambda: kvmp.fused_append_attend_plain(
        *args, seq_tile=tile, n_tiles=n,
        length_mask=kw.get("length_mask", True)))
    lib_ms = _decode_library_ms(args)
    nbytes, keys = _decode_bytes(args, n * tile)
    bound, by = _bound_ms(nbytes, 4 * h * d * keys)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention (attend only)",
            "shape": f"q {tuple(q.shape)} {q.dtype}, caches {tuple(ck.shape)}"
                     f" {ck.dtype}, lens {ln.tolist()}"}


def _decode_bytes(args, n_tiles_x_tile: int) -> tuple[int, int]:
    """(bytes the decode function must move, keys it attends over): q read
    and the output written, each live cached K/V row read once, the new
    K/V read and written once, lens and tile counts."""
    q, ck, _, nk, _, ln = args
    b, s, hkv, d = ck.shape
    live = [p for p in ln.tolist() if p >= 0]
    keys = sum(min(p + 1, n_tiles_x_tile, s) for p in live)
    new = sum(1 for p in live if p < min(n_tiles_x_tile, s))
    ce = ck.element_size()
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * (keys - new) * hkv * d * ce
              + 2 * new * hkv * d * (nk.element_size() + ce)
              + 2 * 4 * b)
    return nbytes, keys


def _split_pairs(args, base, skw) -> list:
    """The split pair at 2, 4 and 8 splits beside the two stages timed
    apart, and stage 2's cost on the path (the pair less stage 1). Stage 2
    is launched behind stage 1 by programmatic dependent launch; stage 2
    timed apart queues behind the stage 2 before it. Returns the printed
    lines."""
    from repro_torch.kernels import kv_multiport as kvmp
    q = args[0]
    lines = []
    for k in SPLITS:
        kk = dict(skw, num_kv_splits=k)
        pair_ms = _ms(lambda: kvmp.fused_append_attend(
            *args, num_kv_splits=k, **base))
        p_ms = _ms(lambda: kvmp.split_partials(*args, **kk))
        acc, st, _ = kvmp.split_partials(*_clones(args), **kk)
        c_ms = _ms(lambda: kvmp.split_combine(acc, st, q.dtype))
        lines.append(
            f"split pair at ns={k}: {pair_ms:.5f} ms (previous design "
            f"{PREVIOUS_MS['split pair'][k]:.5f} ms); stage 1 alone "
            f"{p_ms:.5f} + stage 2 alone {c_ms:.5f} = {p_ms + c_ms:.5f} ms; "
            f"stage 2 on the path (pair - stage 1) {pair_ms - p_ms:.5f} ms")
    lines.append(
        "stage 2's launch: programmatic dependent of stage 1, which never "
        "triggers it early (stage 2's blocks start as stage 1's exit), "
        "blocks of 128 threads")
    return lines


def time_long_decode(args, kw) -> tuple:
    """The serial kernel and the split pair at 2, 4 and 8 splits on the
    long-context path's decode call, and the path's own split count stage
    by stage. Returns (partial row, combine row, printed lines)."""
    from repro_torch.kernels import kv_multiport as kvmp
    q, ck, ln = args[0], args[1], args[5]
    b, s, hkv, d = ck.shape
    h = q.shape[1]
    ns = kw["num_kv_splits"]
    base = {k: v for k, v in kw.items() if k != "num_kv_splits"}
    tile, n = kvmp.launch_geometry(s, base.get("seq_tile", 128),
                                   base.get("live_len"),
                                   base.get("dynamic_grid", False))
    err_pair = max(max(_split_agree(args, base, k)) for k in SPLITS)
    nbytes, keys = _decode_bytes(args, n * tile)
    flops = 4 * h * d * keys
    serial_ms = _ms(lambda: kvmp.fused_append_attend(*args, **base))
    skw = dict(seq_tile=tile, n_tiles=n,
               length_mask=base.get("length_mask", True), num_kv_splits=ns)
    partial_ms = _ms(lambda: kvmp.split_partials(*args, **skw))
    geo = kvmp.split_geometry(h // hkv, d, ck.element_size())
    partial_plain_ms = _ms(lambda: kvmp.split_partials_plain(*args, **skw))
    acc, st, _ = kvmp.split_partials(*_clones(args), **skw)
    err_combine = _combine_agree(acc, st, q.dtype)
    combine_ms = _ms(lambda: kvmp.split_combine(acc, st, q.dtype))
    combine_plain_ms = _ms(lambda: kvmp.split_combine_plain(acc, st, q.dtype))
    lib_ms = _decode_library_ms(args)
    part_bytes = b * ns * h * (d + 2) * 4
    out_bytes = q.numel() * q.element_size()
    serial_bound, _ = _bound_ms(nbytes, flops)
    p_bound, p_by = _bound_ms(nbytes - out_bytes + part_bytes, flops)
    c_bound, c_by = _bound_ms(part_bytes + out_bytes, 6 * b * ns * h * d)
    shape = (f"q {tuple(q.shape)} {q.dtype}, caches {tuple(ck.shape)} "
             f"{ck.dtype}, lens {ln.tolist()}, {ns} splits")
    lines = [
        f"long-context decode [{shape}]: serial kernel {serial_ms:.5f} ms "
        f"(bound {serial_bound:.6f} ms, bytes); SDPA (attend only) "
        f"{lib_ms:.5f} ms; stage 1 alone at ns={ns} {partial_ms:.5f} ms "
        f"(previous design {PREVIOUS_MS['split partial']:.5f} ms; bound "
        f"{p_bound:.6f} ms, {p_by}; ring of {geo['stages']} stages of "
        f"{kvmp.SPLIT_STAGE_KEYS} keys, {geo['smem_bytes']} B of shared "
        f"memory, {'16-byte cp.async' if geo['vector_loader'] else 'element-wise'} "
        f"loader); stage 2 alone, queued behind itself, {combine_ms:.5f} "
        f"ms (previous design, an ordinary launch, "
        f"{PREVIOUS_MS['split combine']:.5f} ms; bound {c_bound:.7f} ms, "
        f"{c_by})",
        *_split_pairs(args, base, skw)]
    partial = {"max_abs_err": err_pair, "ms": partial_ms,
               "plain_ms": partial_plain_ms, "bound_ms": p_bound,
               "bound_by": p_by, "library_ms": lib_ms,
               "library": "scaled_dot_product_attention (attend only)",
               "shape": shape}
    combine = {"max_abs_err": err_combine, "ms": combine_ms,
               "plain_ms": combine_plain_ms, "bound_ms": c_bound,
               "bound_by": c_by, "library_ms": None,
               "library": "no single PyTorch call", "shape": shape}
    return partial, combine, lines


def time_chunk(args, kw) -> dict:
    from repro_torch.kernels import kv_multiport as kvmp
    from repro_torch.kernels import kv_prefill_chunk as kvpc
    q, ck, cv, nk, nv, of, cl = args
    b, c, h, d = q.shape
    s, hkv = ck.shape[1], ck.shape[2]
    tile, n = kvmp.launch_geometry(s, kw.get("seq_tile", 128),
                                   kw.get("live_len"),
                                   kw.get("dynamic_grid", False))
    err = _chunk_agree(args, kw)
    ms = _ms(lambda: kvpc.fused_chunk_append_attend(*args, **kw))
    plain_ms = _ms(lambda: kvpc.fused_chunk_append_attend_plain(
        *args, seq_tile=tile, n_tiles=n))
    ar = torch.arange(c, device=q.device)
    qpos = torch.where(ar[None] < cl[:, None], of[:, None] + ar[None],
                       of[:, None])
    kpos = torch.arange(s, device=q.device)
    mask = (kpos[None, None] <= qpos[..., None])[:, None]     # [B,1,C,S]
    qf, kt, vt = q.float().transpose(1, 2), ck.transpose(1, 2), \
        cv.transpose(1, 2)
    lib_ms = _ms(lambda: _sdpa(qf, kt, vt, mask))
    limit = min(n * tile, s)
    cached = new = pairs = 0
    for o, m in zip(of.tolist(), cl.tolist()):
        if o < 0:
            continue
        keys = min(o + max(m - 1, 0) + 1, limit)
        w = max(0, min(m, limit - o))
        cached, new = cached + keys - w, new + w
        pairs += sum(min((o + i if i < m else o) + 1, limit) for i in range(c))
    ce = ck.element_size()
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * cached * hkv * d * ce
              + 2 * new * hkv * d * (nk.element_size() + ce)
              + 3 * 4 * b)
    bound, by = _bound_ms(nbytes, 4 * h * d * pairs)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention (attend only)",
            "shape": f"q {tuple(q.shape)} {q.dtype}, caches {tuple(ck.shape)}"
                     f" {ck.dtype}, offsets {of.tolist()}, lens {cl.tolist()}"}


def _pool_bytes(args, kw) -> tuple[int, str]:
    """(bytes the pool step must move, the terms): per write lane on its
    payload row read and its word written; per read lane on the word read
    and its output row written; per read lane off a zero row written; the
    addresses and masks read once."""
    from repro_torch.core.ports import WRITE
    storage, addr, _, mask = args
    row = storage.shape[1] * storage.element_size()
    q = addr.shape[1]
    on = mask.sum(dim=1).tolist()
    w_on = sum(n for n, r in zip(on, kw["roles"]) if r == WRITE)
    r_on = sum(n for n, r in zip(on, kw["roles"]) if r != WRITE)
    r_off = sum(q - n for n, r in zip(on, kw["roles"]) if r != WRITE)
    index = addr.numel() * addr.element_size() + mask.numel()
    nbytes = (2 * w_on + 2 * r_on + r_off) * row + index
    terms = (f"{w_on} write lanes x 2 rows + {r_on} read lanes x 2 rows + "
             f"{r_off} zero rows, of {row} B, + {index} B of addresses and "
             f"masks = {nbytes} B")
    return nbytes, terms


def time_pool(args, kw) -> dict:
    from repro_torch.core.ports import WRITE
    from repro_torch.kernels import multiport_sram as mps
    storage, addr, data, mask = args
    roles = kw["roles"]
    err = _pool_agree(args, kw)
    st = storage.clone()
    ms = _ms(lambda: mps.multiport_sram_step(st, addr, data, mask, **kw))
    plain_ms = _ms(lambda: mps.multiport_sram_step_plain(st, addr, data, mask,
                                                         **kw))
    on = mask.sum(dim=1).tolist()
    big = max(range(len(roles)), key=lambda i: on[i])   # the busiest port
    idx = addr[big][mask[big]].long()
    if roles[big] == WRITE:
        rows = data[roles[:big].count(WRITE)][mask[big]]
        lib_ms = _ms(lambda: st.index_copy_(0, idx, rows))
        lib = ("index_copy_ of the busiest port alone, a part of B3's "
               "function, not a yardstick")
    else:
        lib_ms = _ms(lambda: st.index_select(0, idx))
        lib = ("index_select of the busiest port alone, a part of B3's "
               "function, not a yardstick")
    nbytes, terms = _pool_bytes(args, kw)
    bound, by = _bound_ms(nbytes, 0.0)
    ports = "+".join("W" if r == WRITE else "R" for r in roles)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library": lib, "bytes": terms,
            "shape": f"storage {tuple(storage.shape)} {storage.dtype}, ports "
                     f"{ports} in service order, Q {addr.shape[1]}, lanes on "
                     f"{on}"}


def _lanes_on(args, kw) -> int:
    return int(args[3].sum())


def _read_lanes_on(args, kw) -> int:
    from repro_torch.core.ports import WRITE
    return sum(int(m.sum()) for m, r in zip(args[3], kw["roles"])
               if r != WRITE)


def _print_pool(what: str, row: dict, calls: int, previous) -> None:
    before = ("not timed" if previous is None
              else f"{previous:.5f} ms")
    print(f"kernel multiport_sram_step on {what} (x{calls} calls on that "
          f"path) [{row['shape']}]: max_abs_err {row['max_abs_err']:.3g}, "
          f"kernel {row['ms']:.5f} ms (previous design {before}), plain "
          f"{row['plain_ms']:.5f} ms, {row['library']} "
          f"{row['library_ms']:.5f} ms, bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']}: {row['bytes']})")


def _flash_work(q, k, causal: bool = True) -> tuple[int, int]:
    """(bytes, operations) of one flash call: q, k, v read and the output
    written once; 4 D flops (QK and PV) for each query/key pair the mask
    keeps."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    return nbytes, 4 * b * h * d * pairs


def time_flash(q, k, v) -> dict:
    """Flash attention on the whole-prompt path's own q, k, v (causal),
    beside its plain version, SDPA (one call, ``is_causal=True``, top-left
    aligned like the kernel, GQA through ``enable_gqa=True``) and the bound:
    bf16 inputs against the bf16 tensor-core peak, f32 against the f32
    CUDA-core peak."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    tol = FLASH_TOL[q.dtype]
    got = ops.flash_attention(q, k, v, causal=True)
    err = _agree(got, fa.flash_attention_plain(q, k, v, causal=True), tol,
                 tol, f"flash_attention {q.dtype} timed call")

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    sdpa_err = _err(sdpa(), got)
    ms = _ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = _ms(lambda: fa.flash_attention_plain(q, k, v, causal=True))
    lib_ms = _ms(sdpa)
    nbytes, flops = _flash_work(q, k)
    cores, _ = _bound_ms(nbytes, flops)      # all f32 FMA on the CUDA cores
    if q.dtype == torch.bfloat16:
        bound, by = _bound_ms(nbytes, flops, H100_BF16_FLOPS)
        units = "bf16 989 TFLOP/s"
    else:   # the f32 route: the scores' half of the operations in f32 FMA
        # on the CUDA cores; P V's half, 3 TF32 products each, takes less on
        # the tensor cores and can run beside it
        bound, by = _bound_ms(nbytes, flops / 2)
        pv_ms = 3 * flops / 2 / H100_TF32_FLOPS * 1e3
        units = (f"the scores at the f32 CUDA cores' 67 TFLOP/s, P V at 3 x "
                 f"TF32 495 ({pv_ms:.6f} ms), the units it uses; both "
                 f"products on the CUDA cores {cores:.6f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "bound_cuda_cores_ms": cores,
            "library": f"scaled_dot_product_attention (is_causal, enable_gqa; "
                       f"max |diff| to the kernel {sdpa_err:.3g})",
            "shape": f"q {tuple(q.shape)}, k/v {tuple(k.shape)} {q.dtype}, "
                     f"causal, {flops / 1e9:.2f} GFLOP, bound at {units}"}


WHOLE_SEQ, WHOLE_PREFIX, WHOLE_STEPS = 2048, 1024, 8


def _forward_with_b5(cfg, params, ids) -> tuple:
    """``forward`` over ``ids`` with B5, through its entry point, computing
    each layer's attention on that layer's own q, k, v beside the model's
    ``chunked_causal_attention``, and held against both it and B5's plain
    version. Returns (logits, aux, largest |diff| to the model and to the
    plain version over the layers, layers 0 and L-1's q/k/v in
    [B, H, S, D])."""
    from repro_torch import models as M
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    bhsd = lambda x: x.permute(0, 2, 1, 3).contiguous()  # noqa: E731
    kept, vs_model, vs_plain, beyond = {}, [], [], []
    model_attention = A.chunked_causal_attention

    def check(got, want, tol, what):
        try:
            return _agree(got, want, tol, tol, what)
        except AssertionError as e:   # every layer is checked, then raised
            beyond.append(str(e))
            return _err(got, want)

    def with_b5(q, k, v, **kw):
        out = model_attention(q, k, v, **kw)
        i = len(vs_model)
        qb, kb, vb = bhsd(q), bhsd(k), bhsd(v)
        got = ops.flash_attention(qb, kb, vb, causal=True)
        tol = FLASH_TOL[q.dtype]
        vs_model.append(check(got, bhsd(out), tol, f"flash_attention "
                              f"{q.dtype} vs chunked_causal_attention, "
                              f"layer {i}"))
        vs_plain.append(check(got, fa.flash_attention_plain(
            qb, kb, vb, causal=True), tol, f"flash_attention {q.dtype} vs "
            f"plain, layer {i}"))
        if i in (0, cfg.n_layers - 1):
            kept[i] = (qb, kb, vb)
        return out

    A.chunked_causal_attention = with_b5
    try:
        logits, aux = M.forward(params, cfg, {"inputs": ids})
    finally:
        A.chunked_causal_attention = model_attention
    print(f"flash attention {ids.shape[0]} x {ids.shape[1]} tokens in "
          f"{cfg.cdtype}, max |diff| by layer: vs its plain version "
          f"{[float(f'{e:.3g}') for e in vs_plain]}; vs "
          f"chunked_causal_attention {[float(f'{e:.3g}') for e in vs_model]}")
    if beyond:
        raise AssertionError("; ".join(beyond))
    if len(vs_model) != cfg.n_layers:
        raise AssertionError(f"forward ran attention {len(vs_model)} times")
    return logits, aux, {"vs_model": max(vs_model),
                         "vs_plain": max(vs_plain)}, kept


def _check_logits(logits, aux, b: int, cfg) -> None:
    if tuple(logits.shape) != (b, WHOLE_SEQ, cfg.vocab) or float(aux) != 0.0:
        raise AssertionError(f"forward gave {tuple(logits.shape)}, aux {aux}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("forward logits are not finite")


def whole_prompt(dev) -> tuple:
    """The whole-prompt dense path at full width in f32 with every launch
    count set to 0 just before it and read just after: ``forward`` over
    2 x 2048 tokens with flash attention (the CUDA-core kernel) computing
    each layer's attention beside the model's own, then ``prefill`` of 1024
    tokens and 8 fused decode steps held against ``forward``. Returns
    (launch counts, flash errors, layer 0's q/k/v in [B, H, S, D])."""
    from repro_torch import models as M
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.launch import serve
    cfg = serve.arch_config(serve.parse_args(F32))
    n_layers, b = cfg.n_layers, 2
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, device=dev)
    ids = torch.randint(0, cfg.vocab, (b, WHOLE_SEQ), generator=gen,
                        device=dev)

    t0 = time.perf_counter()
    reset_launch_counts()
    logits, aux, fwd_errs, kept = _forward_with_b5(cfg, params, ids)
    state = M.init_decode_state(cfg, b, WHOLE_SEQ, device=dev)
    state, lg = M.prefill(params, cfg, state,
                          {"inputs": ids[:, :WHOLE_PREFIX]})
    at = [WHOLE_PREFIX - 1]
    got = [lg]
    for t in range(WHOLE_PREFIX, WHOLE_PREFIX + WHOLE_STEPS):
        state, lg = M.decode_step(params, cfg, state,
                                  {"inputs": ids[:, t:t + 1]},
                                  kernel_mode="multiport")
        at.append(t)
        got.append(lg)
    torch.cuda.synchronize()
    counts = launch_counts()
    took = time.perf_counter() - t0
    want = {k: 0 for k in counts}
    want.update(flash_attention=n_layers,
                kv_decode_append_attend=n_layers * WHOLE_STEPS)
    if counts != want:
        raise AssertionError(f"whole-prompt launch counts {counts} != {want}")
    _check_logits(logits, aux, b, cfg)
    if state["len"].tolist() != [WHOLE_PREFIX + WHOLE_STEPS] * b:
        raise AssertionError(f"decode state len {state['len'].tolist()}")
    prompt_err = max(_agree(g, logits[:, t], what=f"position {t} vs forward",
                            **PROMPT_TOL) for t, g in zip(at, got))
    if not all(torch.equal(g.argmax(-1), logits[:, t].argmax(-1))
               for t, g in zip(at, got)):
        raise AssertionError("prefill/decode argmax differs from forward's")
    print(f"whole prompt [f32 full width, {b} x {WHOLE_SEQ} tokens]: forward, "
          f"prefill of {WHOLE_PREFIX} + {WHOLE_STEPS} fused decode steps match "
          f"forward at positions {at[0]}..{at[-1]} (max |diff| "
          f"{prompt_err:.3g} within {PROMPT_TOL}), argmax identical; flash "
          f"attention == chunked_causal_attention on all {n_layers} layers "
          f"(max |diff| {fwd_errs['vs_model']:.3g}; vs its plain version "
          f"{fwd_errs['vs_plain']:.3g}); launch counters {counts}; "
          f"{took:.2f}s")
    del params, logits, state, got
    torch.cuda.empty_cache()

    before = launch_counts()
    calls = {name: 0 for name in FLASH_ROUTE.values()}
    errs = {"f32": fwd_errs["vs_plain"], "bf16": 0.0,
            "vs_model": fwd_errs["vs_model"]}
    for i, (qb, kb, vb) in sorted(kept.items()):
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = qb.to(dt), kb.to(dt), vb.to(dt)
            out = ops.flash_attention(q, k, v, causal=True)
            calls[FLASH_ROUTE[dt]] += 1
            tol = FLASH_TOL[dt]
            errs[name] = max(errs[name], _agree(
                out, fa.flash_attention_plain(q, k, v, causal=True), tol, tol,
                f"flash_attention {name} vs plain, layer {i}"))
    torch.cuda.synchronize()
    _expect_flash_calls(before, calls)
    print(f"whole prompt: flash attention vs its plain version on layers "
          f"{sorted(kept)} (f32, and cast to bf16) {errs}")
    return counts, errs, kept[0]


def whole_prompt_bf16(dev) -> tuple:
    """The whole-prompt path at tinyllama's published bf16 with every launch
    count set to 0 just before it and read just after: ``forward`` over
    2 x 2048 tokens with the tensor-core kernel computing each of the 22
    layers' attention beside the model's own. Returns (launch counts,
    errors, layer 0's q/k/v in [B, H, S, D])."""
    from repro_torch import models as M
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    cfg = serve.arch_config(serve.parse_args(FULL))
    if cfg.cdtype != torch.bfloat16:
        raise AssertionError(f"published dtype is {cfg.cdtype}, not bf16")
    n_layers, b = cfg.n_layers, 2
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, device=dev)
    ids = torch.randint(0, cfg.vocab, (b, WHOLE_SEQ), generator=gen,
                        device=dev)
    t0 = time.perf_counter()
    reset_launch_counts()
    logits, aux, errs, kept = _forward_with_b5(cfg, params, ids)
    torch.cuda.synchronize()
    counts = launch_counts()
    took = time.perf_counter() - t0
    want = {k: 0 for k in counts}
    want.update(flash_attention_tc=n_layers)
    if counts != want:
        raise AssertionError(f"bf16 whole-prompt launch counts {counts} != "
                             f"{want}")
    _check_logits(logits, aux, b, cfg)
    print(f"whole prompt [bf16 full width, {b} x {WHOLE_SEQ} tokens]: "
          f"forward finite; tensor-core flash attention == "
          f"chunked_causal_attention on all {n_layers} layers (max |diff| "
          f"{errs['vs_model']:.3g}; vs its plain version "
          f"{errs['vs_plain']:.3g}, tolerance {FLASH_TOL[torch.bfloat16]}); "
          f"launch counters {counts}; {took:.2f}s")
    del params, logits
    torch.cuda.empty_cache()
    return counts, {"bf16": errs["vs_plain"], "vs_model": errs["vs_model"]}, \
        kept[0]


def head_dim_128(dev) -> tuple:
    """q/k/v at qwen2-vl-7b's head layout (G = 7, D = 128) over 2048
    positions, bf16, random from seed 0."""
    from repro_torch.configs import registry
    cfg = registry.get("qwen2-vl-7b")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return tuple(torch.randn((1, n, WHOLE_SEQ, d), generator=gen, device=dev)
                 .to(torch.bfloat16) for n in (h, hkv, hkv))


F32 = FULL + ["--dtype", "float32"]


def fused_equals_reference() -> dict:
    """The short path's requests in f32: fused kernels == two-pass
    reference. Returns the greedy tokens."""
    from repro_torch.launch import serve
    toks = {}
    for mode in ("pallas", "reference"):
        t0 = time.perf_counter()
        eng = serve.main(F32 + ["--requests", "4", "--max-new", "8",
                                "--seed", "0", "--kernel-mode", mode])
        toks[mode] = _tokens(eng)
        print(f"f32 full width, kernel_mode={mode}: {eng.cycles} cycles, "
              f"{eng.pool.traversals} pool traversals, "
              f"{time.perf_counter() - t0:.2f}s")
    if toks["pallas"] != toks["reference"]:
        raise AssertionError(f"fused and reference tokens differ: {toks}")
    print(f"f32 token identity fused == reference over "
          f"{sum(map(len, toks['pallas'].values()))} greedy tokens")
    return toks["pallas"]


def split_equals_serial() -> None:
    """A long-prompt trace in f32: split decode == serial decode."""
    from repro_torch.launch import serve
    path = ROOT / "build" / "chip_smoke" / "long_1k.jsonl"
    write_long_trace(path, 500, 1001, seed=1)
    toks = {}
    for ns in (1, 8):
        t0 = time.perf_counter()
        eng = serve.main(F32 + ["--max-len", "1024", "--max-slots", "4",
                                "--chunk-tokens", "128", "--trace", str(path),
                                "--num-kv-splits", str(ns)])
        expect_served(eng, 4, 8)
        toks[ns] = _tokens(eng)
        print(f"f32 long prompts, num_kv_splits={ns}: {eng.cycles} cycles, "
              f"{time.perf_counter() - t0:.2f}s")
    if toks[1] != toks[8]:
        raise AssertionError(f"split and serial tokens differ: {toks}")
    print(f"f32 token identity split == serial over "
          f"{sum(map(len, toks[1].values()))} greedy tokens")


def chaos_open_loop() -> None:
    """An open-loop Poisson schedule, fault-free and under chaos plan 23:
    clean audits, everyone accounted for once, survivors unchanged."""
    from repro_torch.launch import serve
    from repro_torch.serve.chaos import KINDS, check_invariants
    argv = F32 + ["--arrival-rate", "0.8", "--requests", "10", "--seed", "0"]
    ref, _ = serve.run(serve.parse_args(argv))
    eng, harness = serve.run(serve.parse_args(argv + ["--chaos-seed", "23"]))
    ref_toks = _tokens(ref)
    if len(ref_toks) != 10 or ref.shed:
        raise AssertionError("the fault-free run did not serve every request")
    if harness.invariant_checks < len(harness.plan.faults) + 1:
        raise AssertionError(f"only {harness.invariant_checks} audits ran")
    check_invariants(eng)
    served = {r.rid for r in eng.finished}
    shed = {r.rid for r in eng.shed}
    if served & shed or served | shed != set(ref_toks):
        raise AssertionError(f"requests not accounted for once: served "
                             f"{sorted(served)}, shed {sorted(shed)}")
    survivors = [r for r in eng.finished
                 if not r.cancelled and r.shed_reason is None]
    bad = [r.rid for r in survivors if tuple(r.generated) != ref_toks[r.rid]]
    if not survivors or bad:
        raise AssertionError(f"chaos survivors differ from the fault-free "
                             f"run: {bad}")
    kinds = [i["kind"] for i in harness.injected if i["kind"] in KINDS]
    print(f"chaos [seed 23]: injected {kinds}, {harness.invariant_checks} "
          f"invariant audits clean, {len(survivors)} survivors "
          f"token-identical, {eng.cancelled} cancelled, {len(shed)} shed, "
          f"{eng.stalled_retirements} stalled retirements")


# ---- phases 7b-7e: the MoE family, and the VLM and audio stems ----------

MOE = ["--arch", "deepseek-moe-16b", "--no-reduced", "--device", "cuda"]
SHORT = ["--requests", "4", "--max-new", "8", "--seed", "0"]
# f32 at the published widths fits the card only at reduced depth: the 28
# layers in f32 are 67.5 GB of weights
F32_LAYERS = 2
# the model entry points of the embedding-input families: a prefill chunk
# of 128 embedding rows for 2 sequences, then 8 decode steps
FAMILY_ROWS, FAMILY_CHUNK, FAMILY_STEPS, FAMILY_CACHE = 2, 128, 8, 256
# model entry points, multiport against reference in f32 (TF32 off): the
# tolerance of tests/test_torch_models.py
ENTRY_TOL = 1e-4


def _gib(nbytes: int) -> str:
    return f"{nbytes / 2 ** 30:.2f} GiB"


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _depth_cut(n_layers: int):
    """The launcher's config with its depth cut to ``n_layers``, for the
    f32 runs at published widths (restored by the caller)."""
    from repro_torch.launch import serve
    orig = serve.arch_config
    serve.arch_config = lambda args: dataclasses.replace(orig(args),
                                                         n_layers=n_layers)
    return orig


def serve_moe() -> tuple:
    """deepseek-moe-16b at its published widths (bf16, random weights from
    seed 0) through the launcher at the short path's settings, with every
    launch count set to 0 just before it and read just after: B1 = 28 x
    decode cycles, B2 = 28 x prefill cycles, B3 = traversals, the split
    pair and flash 0. One decode cycle's 28 MoE layers are kept and timed
    on the served weights beside their byte bound. Returns (launch counts,
    the captured kernel calls)."""
    from repro_torch.launch import serve
    from repro_torch.models import mlp, model
    cfg = serve.arch_config(serve.parse_args(MOE))
    decode_x = []
    moe_ffn = mlp.moe_ffn

    def keep(p, x, moe, compute_dtype=None):
        if x.shape[1] == 1:                       # a decode step's layer
            decode_x.append(x.clone())
            del decode_x[:-cfg.n_layers]
        return moe_ffn(p, x, moe, compute_dtype)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mlp.moe_ffn = keep
    try:
        eng, _, counts, cap = serve_path(MOE + SHORT)
    finally:
        mlp.moe_ffn = moe_ffn
    took = time.perf_counter() - t0
    expect_launches(eng, counts)
    expect_served(eng, 4, 8)
    peak = torch.cuda.max_memory_allocated()
    moe = eng.params["layers"]["moe"]
    layers = model._unbind_layers(moe, cfg.n_layers)

    def cycle():
        for p, x in zip(layers, decode_x):
            mlp.moe_ffn(p, x, cfg.moe, compute_dtype=cfg.cdtype)
    ms = _ms(cycle, reps=5, batches=5)
    x0 = decode_x[0]
    b = x0.shape[0]
    m = cfg.moe
    cap_slots = int(max(1, round(m.top_k / m.n_experts * m.capacity_factor)))
    buf = torch.zeros((b, m.n_experts, cap_slots, cfg.d_model),
                      dtype=cfg.cdtype, device=x0.device)

    def expert_products():      # moe_ffn's three einsums, every layer
        for p in layers:
            h = torch.einsum("becd,edf->becf", buf, p["w_gate"])
            torch.einsum("becd,edf->becf", buf, p["w_up"])
            torch.einsum("becf,efd->becd", h, p["w_down"])
    products_ms = _ms(expert_products, reps=5, batches=5)
    # the same cycle as one CUDA graph: the device's time alone, without
    # the host issuing each layer's few dozen small ops
    graph_ms = _graph_ms(cycle)
    nbytes = _tree_bytes(moe) + 2 * cfg.n_layers * x0.numel() * \
        x0.element_size()
    # every expert's capacity slots run (the formulation computes them all)
    flops = cfg.n_layers * 2 * 3 * cfg.d_model * m.d_expert * (
        b * m.n_experts * cap_slots + b * m.n_shared)
    bound, by = _bound_ms(nbytes, flops, H100_BF16_FLOPS)
    # what routing needs: each layer's distinct top-k experts' weights, and
    # top_k + n_shared expert products a token
    routed = [int(mlp.moe_ffn(p, x, m, compute_dtype=cfg.cdtype)[2]
                  .unique().numel()) for p, x in zip(layers, decode_x)]
    expert_bytes = 3 * cfg.d_model * m.d_expert * moe["w_gate"].element_size()
    r_bytes = nbytes - (cfg.n_layers * m.n_experts - sum(routed)) * \
        expert_bytes
    r_flops = cfg.n_layers * 2 * 3 * cfg.d_model * m.d_expert * b * (
        m.top_k + m.n_shared)
    r_bound, r_by = _bound_ms(r_bytes, r_flops, H100_BF16_FLOPS)
    toks = sum(len(r.generated) for r in eng.finished)
    print(f"MoE serve [deepseek-moe-16b, published widths, bf16]: {toks} "
          f"tokens over {eng.cycles} macro-cycles ({eng.prefill_steps} "
          f"prefill, {eng.decode_steps} decode), {took:.2f}s host clock "
          f"with the init (the launcher's tok/s line above times the serve "
          f"alone); peak memory {_gib(peak)} (weights "
          f"{_gib(_tree_bytes(eng.params))}, pool "
          f"{_gib(_tree_bytes(eng.pool.storage))})")
    print(f"MoE layers of one decode cycle ({cfg.n_layers} x moe_ffn on "
          f"x {tuple(x0.shape)} {x0.dtype}, capacity {cap_slots}, all "
          f"{m.n_experts} experts' slots computed): {ms:.5f} ms issued "
          f"op by op as served, {graph_ms:.5f} ms replayed as one CUDA "
          f"graph (the device alone), the three expert einsums alone "
          f"{products_ms:.5f} ms; bound of every expert's slots (the JAX "
          f"formulation) {bound:.6f} ms ({by}: {nbytes} B of routers, "
          f"experts and shared experts read once, {flops / 1e9:.2f} GFLOP); "
          f"bound of the routed experts alone {r_bound:.6f} ms ({r_by}: "
          f"{min(routed)}-{max(routed)} of {m.n_experts} experts routed a "
          f"layer, {r_bytes} B, {r_flops / 1e9:.2f} GFLOP)")
    del eng, moe, layers, decode_x, buf
    torch.cuda.empty_cache()
    return counts, cap


def _hold_split_pair(args, kw, splits) -> tuple[float, float]:
    """The split pair on a captured decode call at each of ``splits``,
    against its plain version and the serial kernel (``_split_agree``),
    and stage 2 alone against its plain version on that call's partials.
    Returns (largest pair error, largest stage 2 error)."""
    from repro_torch.kernels import kv_multiport as kvmp
    base = {k: v for k, v in kw.items() if k != "num_kv_splits"}
    tile, n = kvmp.launch_geometry(args[1].shape[1], base.get("seq_tile", 128),
                                   base.get("live_len"),
                                   base.get("dynamic_grid", False))
    pair = combine = 0.0
    for ns in splits:
        pair = max(pair, *_split_agree(args, base, ns))
        acc, st, _ = kvmp.split_partials(
            *_clones(args), seq_tile=tile, n_tiles=n,
            length_mask=base.get("length_mask", True), num_kv_splits=ns)
        combine = max(combine, _combine_agree(acc, st, args[0].dtype))
    return pair, combine


def moe_rows(counts: dict, cap) -> dict:
    """B1 on deepseek's decode call, B2 on its prefill chunk (D = 128) and
    B3 on its largest decode gather (W = 114688), each held against its
    plain version and timed beside its bound and library call; and the
    split pair at 2, 4 and 8 splits on that decode call against its plain
    version. Returns the errors by kernel."""
    errs = {}
    for name, row, calls in (
            ("kv_decode_append_attend", time_decode(*cap.typical("decode")),
             counts["kv_decode_append_attend"]),
            ("kv_chunk_append_attend", time_chunk(*cap.typical("chunk")),
             counts["kv_chunk_append_attend"]),
            ("multiport_sram_step",
             time_pool(*cap.largest("pool", _read_lanes_on)),
             counts["multiport_sram_step"])):
        lib = row["library"]
        errs[name] = row["max_abs_err"]
        print(f"kernel {name} on the deepseek-moe-16b path's "
              f"{'largest decode gather' if 'sram' in name else 'typical call'}"
              f" (x{calls} on that path) [{row['shape']}]: max_abs_err "
              f"{row['max_abs_err']:.3g}, kernel {row['ms']:.5f} ms, plain "
              f"{row['plain_ms']:.5f} ms, {lib} {row['library_ms']:.5f} ms, "
              f"bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
    args, kw = cap.typical("decode")
    errs["kv_decode_split_partial"], errs["kv_decode_split_combine"] = \
        _hold_split_pair(args, kw, SPLITS)
    q, ck = args[0], args[1]
    tol = F32_TOL if q.dtype == ck.dtype == torch.float32 else BF16_TOL
    if max(errs.values()) > tol:
        raise AssertionError(f"a kernel disagrees with its plain version on "
                             f"the deepseek-moe-16b path (limit {tol}): "
                             f"{errs}")
    print(f"split pair at ns {SPLITS} on the deepseek-moe-16b path's decode "
          f"call [q {tuple(q.shape)} {q.dtype}, caches {tuple(ck.shape)} "
          f"{ck.dtype}]: against its plain version and the serial kernel "
          f"{errs['kv_decode_split_partial']:.3g}, stage 2 alone "
          f"{errs['kv_decode_split_combine']:.3g} (limit {tol})")
    del args, kw
    cap.calls.clear()
    torch.cuda.empty_cache()
    return errs


def moe_identity() -> dict:
    """deepseek-moe-16b in f32 at its published widths and 2 layers (TF32
    off), each run through the launcher with the launch counts set to 0
    just before it and read just after: fused (B1 = 2 x decode cycles,
    split pair 0) == reference (no kernel launched) == split-KV at 2
    splits (B4a = B4b = 2 x decode cycles, B1 0) tokens. B1 and B2 on the
    fused run's calls, and the split pair on the split run's decode call,
    are held against their plain versions. Returns those errors by
    kernel."""
    from repro_torch.launch import serve
    orig = _depth_cut(F32_LAYERS)
    toks, errs = {}, {}
    try:
        for name, extra in (("pallas", []),
                            ("reference", ["--kernel-mode", "reference"]),
                            ("split 2", ["--num-kv-splits", "2"])):
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            eng, _, counts, cap = serve_path(MOE + ["--dtype", "float32"] +
                                             SHORT + extra)
            took = time.perf_counter() - t0
            expect_served(eng, 4, 8)
            if name == "reference":
                if any(counts.values()):
                    raise AssertionError(f"the reference run launched "
                                         f"kernels: {counts}")
            else:
                expect_launches(eng, counts)
            toks[name] = _tokens(eng)
            if name == "pallas":
                errs["kv_decode_append_attend"] = _decode_agree(
                    *cap.typical("decode"))
                errs["kv_chunk_append_attend"] = _chunk_agree(
                    *cap.typical("chunk"))
            elif name == "split 2":
                pair, comb = _hold_split_pair(*cap.typical("decode"), (2,))
                errs["kv_decode_split_partial"] = pair
                errs["kv_decode_split_combine"] = comb
            print(f"MoE f32 ({F32_LAYERS} of 28 layers), {name}: "
                  f"{eng.cycles} cycles, {eng.pool.traversals} pool "
                  f"traversals, launches {counts}, {took:.2f}s, peak memory "
                  f"{_gib(torch.cuda.max_memory_allocated())}")
            del eng, cap
            torch.cuda.empty_cache()
    finally:
        serve.arch_config = orig
    if max(errs.values()) > F32_TOL:
        raise AssertionError(f"a kernel disagrees with its plain version on "
                             f"the MoE f32 path: {errs}")
    if toks["pallas"] != toks["reference"]:
        raise AssertionError(f"MoE fused and reference tokens differ: {toks}")
    if toks["split 2"] != toks["pallas"]:
        raise AssertionError(f"MoE split and serial tokens differ: {toks}")
    print(f"MoE f32 token identity fused == reference == split 2 over "
          f"{sum(map(len, toks['pallas'].values()))} greedy tokens (depth "
          f"reduced to {F32_LAYERS} layers so that f32 fits; widths as "
          f"published); against their plain versions on those runs' calls "
          f"(G 1, D 128, f32): {errs}")
    return errs


def _entry_calls(M, cfg, params, emb, dec, mode: str) -> list:
    """``prefill_chunk`` of the seeded embedding rows, then one
    ``decode_step`` per decode embedding; returns each call's logits."""
    b, c = emb.shape[:2]
    state = M.init_decode_state(cfg, b, FAMILY_CACHE, device=emb.device)
    chunk_len = torch.full((b,), c, dtype=torch.int32, device=emb.device)
    state, lg = M.prefill_chunk(params, cfg, state, {
        "inputs": emb, "chunk_len": chunk_len}, kernel_mode=mode)
    out = [lg]
    for t in range(dec.shape[1]):
        state, lg = M.decode_step(params, cfg, state,
                                  {"inputs": dec[:, t:t + 1]},
                                  kernel_mode=mode)
        out.append(lg)
    if state["len"].tolist() != [c + dec.shape[1]] * b:
        raise AssertionError(f"decode state len {state['len'].tolist()}")
    return out


def _patch_grid_positions(b: int, s: int, dev) -> torch.Tensor:
    """(t, h, w) positions [B, S, 3]: 8 text tokens, a 4 x 4 patch grid at
    t = 8 (h, w = 8 + row, 8 + column), then text from 12 on."""
    pos = torch.arange(s, device=dev)[:, None].repeat(1, 3)
    i = torch.arange(16, device=dev)
    pos[8:24, 0] = 8
    pos[8:24, 1] = 8 + i // 4
    pos[8:24, 2] = 8 + i % 4
    pos[24:] = torch.arange(12, 12 + s - 24, device=dev)[:, None]
    return pos[None].expand(b, s, 3)


def family_entry_points(dev) -> dict:
    """qwen2-vl-7b (M-RoPE, G = 7, D = 128) and musicgen-large (sinusoidal
    positions, G = 1, D = 64) through the model entry points, one after
    the other: at the published widths in bf16 (B2 = L per chunk, B1 = L
    per decode step, logits finite), then in f32 at 2 layers (TF32 off),
    multiport against reference (equal argmax, logits within 1e-4), and
    for qwen2-vl-7b ``forward`` with a 4 x 4 patch grid's positions
    against ``prefill`` on the same positions. Returns the launch counts
    of each bf16 run."""
    from repro_torch import models as M
    from repro_torch.configs import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    runs = {}
    for arch in ("qwen2-vl-7b", "musicgen-large"):
        cfg = registry.get(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        emb = torch.randn((FAMILY_ROWS, FAMILY_CHUNK, cfg.d_model),
                          generator=gen, device=dev)
        dec = torch.randn((FAMILY_ROWS, FAMILY_STEPS, cfg.d_model),
                          generator=gen, device=dev)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = M.init_params(cfg, gen, device=dev)
        reset_launch_counts()
        got = _entry_calls(M, cfg, params, emb, dec, "multiport")
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {k: 0 for k in counts}
        want.update(kv_chunk_append_attend=cfg.n_layers,
                    kv_decode_append_attend=cfg.n_layers * FAMILY_STEPS)
        if counts != want:
            raise AssertionError(f"{arch} launch counts {counts} != {want}")
        if not all(bool(torch.isfinite(g).all()) and
                   tuple(g.shape) == (FAMILY_ROWS, cfg.vocab) for g in got):
            raise AssertionError(f"{arch}: logits not finite or misshapen")
        print(f"{arch} [published widths, bf16: {cfg.n_layers} layers, d "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, D "
              f"{cfg.head_dim_}, {cfg.pos_embed}]: prefill_chunk of "
              f"{FAMILY_CHUNK} embedding rows x {FAMILY_ROWS} + "
              f"{FAMILY_STEPS} decode steps, logits finite; launch counters "
              f"{counts}; {time.perf_counter() - t0:.2f}s with the init, "
              f"peak memory {_gib(torch.cuda.max_memory_allocated())}")
        runs[arch] = counts
        del params, got
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        cfg32 = dataclasses.replace(cfg, n_layers=F32_LAYERS,
                                    param_dtype="float32",
                                    compute_dtype="float32")
        params = M.init_params(cfg32, gen, device=dev)
        fused = _entry_calls(M, cfg32, params, emb, dec, "multiport")
        ref = _entry_calls(M, cfg32, params, emb, dec, "reference")
        err = max(_agree(f, r, ENTRY_TOL, ENTRY_TOL, f"{arch} call {i}")
                  for i, (f, r) in enumerate(zip(fused, ref)))
        if not all(torch.equal(f.argmax(-1), r.argmax(-1))
                   for f, r in zip(fused, ref)):
            raise AssertionError(f"{arch}: multiport argmax != reference")
        line = (f"{arch} [f32, {F32_LAYERS} layers, TF32 off]: multiport == "
                f"reference over {len(fused)} calls (argmax identical, max "
                f"|diff| {err:.3g} within {ENTRY_TOL})")
        if cfg.pos_embed == "mrope":
            pos = _patch_grid_positions(FAMILY_ROWS, FAMILY_CHUNK, dev)
            batch = {"inputs": emb, "positions": pos}
            logits, _ = M.forward(params, cfg32, batch)
            state = M.init_decode_state(cfg32, FAMILY_ROWS, FAMILY_CACHE,
                                        device=dev)
            _, last = M.prefill(params, cfg32, state, batch)
            text = M.forward(params, cfg32, {"inputs": emb})[0]
            e = _agree(last, logits[:, -1], ENTRY_TOL, ENTRY_TOL,
                       f"{arch} prefill vs forward on patch positions")
            if torch.equal(text[:, -1], logits[:, -1]):
                raise AssertionError("the patch grid's positions changed "
                                     "nothing")
            line += (f"; forward == prefill on a 4 x 4 patch grid's (t, h, "
                     f"w) positions (max |diff| {e:.3g}), which move the "
                     f"logits off the text positions'")
        print(f"{line}; {time.perf_counter() - t0:.2f}s")
        del params, fused, ref
        torch.cuda.empty_cache()
    return runs


# ---- phase 7f-7h: training (ROADMAP A10) ---------------------------------

TRAIN_ARCH = ["--arch", "tinyllama-1.1b", "--device", "cuda"]
TRAIN = TRAIN_ARCH + ["--batch", "8", "--seq", "1024"]
TRAIN_STEPS = 8                 # AdamW steps at full width
OTHER_OPT_STEPS = 2             # adamw8bit and adafactor each
# the AdamW step before attention took bf16 operands into f32 sums
# (PERF.md §5, NVIDIA H100 80GB HBM3, 700.00 W)
BEFORE_BF16_PRODUCTS = ("0.869 s a step, copy_ 31.7 % and bmm 17.2 % of "
                        "its kernels' time")
# the recorded one-device AdamW step at batch 8 x 1024 (PERF.md §5,
# measured on one NVIDIA H100 80GB HBM3, 700.00 W): beside phase 8b's
RECORDED_STEP_S = 0.7077
TRAIN_F32_BATCH, TRAIN_F32_SEQ = 4, 256
MICRO_TOL = 1e-5                # microbatches == one batch (ce rel; grads
                                # of each leaf's largest |value|)
RESTART_RTOL = 1e-6             # the JAX restart test's tolerance
CARD_CPU_RTOL = 1e-4            # one step on the card and on the CPU
MOE_TRAIN = ["--arch", "deepseek-moe-16b", "--device", "cuda", "--batch",
             "4", "--seq", "512"]


def _train_setup(argv: list, cfg_edit=None):
    """``launch.train``'s own parse and build, with the config edited by
    ``cfg_edit`` (a depth or dtype cut) when given."""
    from repro_torch.launch import train
    args = train.parse_args(argv)
    orig = train.arch_config
    if cfg_edit is not None:
        train.arch_config = lambda a: cfg_edit(orig(a))
    try:
        return args, train.build(args)
    finally:
        train.arch_config = orig


def _expect_no_launches(what: str) -> None:
    from repro_torch.kernels import launch_counts
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{what} launched kernels {counts}: training "
                             f"runs none of B1-B5")


def _record(metrics: dict) -> dict:
    rec = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(rec[k]) for k in ("loss", "ce", "grad_norm")):
        raise AssertionError(f"non-finite training metrics {rec}")
    return rec


def _train_flops(cfg, batch: int, seq: int) -> tuple[float, float]:
    """(model FLOPs of one training step: 3 x the forward's matmuls and
    attention products, counted from the shapes; the FLOPs the device
    also spends recomputing each block in the backward under remat)."""
    d, hd = cfg.d_model, cfg.head_dim_
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    block = attn + 3 * d * cfg.d_ff
    tokens = batch * seq
    # chunked_causal_attention computes every (query, key) score of a chunk
    # and masks the future: S x S products per head, QK^T and PV
    scores = 4 * batch * cfg.n_heads * seq * seq * hd
    blocks_fwd = cfg.n_layers * (2 * block * tokens + scores)
    fwd = blocks_fwd + 2 * d * cfg.vocab * tokens
    return 3 * fwd, blocks_fwd


def _profile_step(step, state, batch, card: str) -> None:
    """One more step under ``torch.profiler``: the device's busy share of
    the step's host clock (the kernels' time summed), and the operators
    whose kernels take it, by their own device time."""
    prof = _profiled(lambda: step(state, batch))
    busy, wall_ms = prof["busy_ms"], prof["wall_ms"]
    if not busy:
        print(f"train profile: the profiler saw no device time (not "
              f"measured) ({card})")
        return
    print(f"train profile [one AdamW step under torch.profiler, "
          f"{wall_ms:.1f} ms host clock]: kernels {busy:.1f} ms on the "
          f"device ({100 * busy / wall_ms:.1f} % busy); operators by their "
          f"kernels' device time (before attention's bf16 products: "
          f"{BEFORE_BF16_PRODUCTS}) ({card}):")
    for ms, n, name in prof["ops"][:12]:
        print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f} % x{n:<5d} {name}")


def train_full_width(card: str) -> dict:
    """tinyllama-1.1b at its published widths (22 layers, d 2048, 32/4
    heads, d_ff 5632, vocab 32000, bf16), seed-0 weights, the chain task,
    batch 8 x seq 1024, through ``launch.train``'s parse and build: 8 AdamW
    steps (ce, grad_norm, lr and the host time of each step around
    ``torch.cuda.synchronize()``), tokens/s, model TFLOP/s against the bf16
    peak and peak memory; then adamw8bit and adafactor 2 steps each with
    their state bytes. Every launch counter stays 0. Returns the first
    AdamW step's ce and the steady step's seconds (phase 8b's one-device
    reference)."""
    from repro_torch.kernels import reset_launch_counts
    for opt, steps in (("adamw", TRAIN_STEPS),
                       ("adamw8bit", OTHER_OPT_STEPS),
                       ("adafactor", OTHER_OPT_STEPS)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        args, s = _train_setup(TRAIN + ["--steps", str(steps),
                                        "--optimizer", opt])
        state, s.state = s.state, None      # the loop below holds the state
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = s.cfg
        times, recs = [], []
        for i in range(steps):
            batch = s.loader.get(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = s.step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            recs.append(_record(metrics))
            print(f"train [{cfg.arch_id}, published widths, "
                  f"{cfg.param_dtype}, {opt}] step {i}: ce "
                  f"{recs[-1]['ce']:.4f}, grad_norm "
                  f"{recs[-1]['grad_norm']:.4f}, lr {recs[-1]['lr']:.3g}, "
                  f"{times[-1]:.4f} s ({card})")
        _expect_no_launches(f"training with {opt}")
        peak = torch.cuda.max_memory_allocated()
        if opt == "adamw":
            _profile_step(s.step, state, batch, card)
        opt_bytes = _tree_bytes(state["opt"])
        p_bytes = _tree_bytes(state["params"])
        tokens = args.batch * args.seq
        if opt == "adamw":
            steady = statistics.median(times[1:])
            one_device = {"ce": recs[0]["ce"], "step_s": steady}
            model, recompute = _train_flops(cfg, args.batch, args.seq)
            tflops = model / steady / 1e12
            print(f"train [{cfg.arch_id}, {cfg.n_layers} layers, d "
                  f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
                  f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}, "
                  f"AdamW, batch {args.batch} x seq {args.seq}]: init "
                  f"{init_s:.2f} s; "
                  f"first step {times[0]:.4f} s, steps 1-{steps - 1} median "
                  f"{steady:.4f} s (min {min(times[1:]):.4f}, max "
                  f"{max(times[1:]):.4f}); {tokens / steady:.0f} tokens/s; "
                  f"model {model / 1e12:.2f} TFLOP a step (3 x forward "
                  f"matmuls and S x S attention products; remat's recompute "
                  f"of the blocks, {recompute / 1e12:.2f} TFLOP more, not "
                  f"counted) = {tflops:.1f} TFLOP/s, {100 * tflops / 989:.1f} "
                  f"% of the 989 TFLOP/s bf16 peak; peak memory "
                  f"{_gib(peak)} (params {_gib(p_bytes)}, AdamW state "
                  f"{_gib(opt_bytes)}); ce {recs[0]['ce']:.4f} -> "
                  f"{recs[-1]['ce']:.4f}; launch counters all 0 (before "
                  f"attention's bf16 products: {BEFORE_BF16_PRODUCTS}) "
                  f"({card})")
        else:
            print(f"train [{cfg.arch_id}, published widths, "
                  f"{cfg.param_dtype}, {opt}]: {steps} steps finite, "
                  f"median {statistics.median(times):.4f} s a step; "
                  f"optimizer state {opt_bytes} B "
                  f"({_gib(opt_bytes)}; params {_gib(p_bytes)}); peak memory "
                  f"{_gib(peak)}; launch counters all 0 ({card})")
        del state, s, batch, metrics
    torch.cuda.empty_cache()
    return one_device


def _f32_cut(n_layers: int):
    def edit(cfg):
        return dataclasses.replace(cfg, n_layers=n_layers,
                                   param_dtype="float32",
                                   compute_dtype="float32")
    return edit


def _tree_to(tree, device):
    from repro_torch import tree as T
    return T.tree_map(lambda x: x.to(device, copy=True), tree)


def train_f32_identity(card: str) -> dict:
    """tinyllama-1.1b at its published widths, f32, 2 of its 22 layers,
    TF32 off, batch 4 x seq 256: (1) microbatches=4 against one batch, ce
    within 1e-5 and every gradient leaf within 1e-5 of its largest |value|;
    (2) a crash at step 6 restarted from the step-5 checkpoint against an
    uninterrupted 10-step run (the runner, checkpoints on disk), every ce
    within rtol 1e-6, under ``torch.use_deterministic_algorithms``; (3) the
    same step from the same parameters on the card and on the CPU, ce and
    grad_norm within 1e-4 relative. Returns the largest differences."""
    import shutil

    from repro_torch import tree as T
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.train import train_step as ts
    from repro_torch.train.loop import RunnerConfig, TrainingRunner
    out = {}
    argv = TRAIN_ARCH + ["--batch", str(TRAIN_F32_BATCH), "--seq",
                        str(TRAIN_F32_SEQ), "--steps", "10"]
    reset_launch_counts()
    args, s = _train_setup(argv, _f32_cut(F32_LAYERS))
    cfg, state = s.cfg, s.state
    batch = s.loader.get(0)

    # (1) microbatches
    g1, m1 = ts.compute_grads(state["params"], cfg, s.tcfg, batch)
    g4, m4 = ts.compute_grads(state["params"], cfg,
                              dataclasses.replace(s.tcfg, microbatches=4),
                              batch)
    ce_rel = abs(float(m4["ce"]) - float(m1["ce"])) / abs(float(m1["ce"]))
    g_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(T.leaves(g4), T.leaves(g1)))
    if ce_rel > MICRO_TOL or g_rel > MICRO_TOL:
        raise AssertionError(f"microbatches=4 != one batch: ce {ce_rel:.3g},"
                             f" grads {g_rel:.3g} (limit {MICRO_TOL})")
    out["microbatches"] = (ce_rel, g_rel)
    del g1, g4

    # (2) restart, deterministic
    root = ROOT / "build" / "chip_smoke" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        runs = {}
        for name, inj in (("clean", None),
                          ("crash", FailureInjector(fail_at_steps=(6,)))):
            runner = TrainingRunner(
                s.step, state, s.loader.get,
                RunnerConfig(ckpt_dir=str(root / name), ckpt_every=5,
                             keep_last=2), injector=inj)
            runner.run(10)
            runs[name] = runner
        took = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    crash = runs["crash"]
    steps = [h["step"] for h in crash.history]
    if crash.restarts != 1 or steps != list(range(6)) + list(range(6, 10)):
        raise AssertionError(f"restart: {crash.restarts} restarts, steps "
                             f"{steps}")
    clean = {h["step"]: h["ce"] for h in runs["clean"].history}
    rel = max(abs(h["ce"] - clean[h["step"]]) / abs(clean[h["step"]])
              for h in crash.history)
    if rel > RESTART_RTOL:
        raise AssertionError(f"restarted losses differ by {rel:.3g} (limit "
                             f"{RESTART_RTOL})")
    out["restart"] = rel
    ckpt_bytes = sum(f.stat().st_size for f in (root / "clean").rglob("*")
                     if f.is_file()) // 2
    shutil.rmtree(root, ignore_errors=True)
    _expect_no_launches("the f32 training runs")
    print(f"train f32 [{cfg.arch_id}, published widths, {F32_LAYERS} of 22 "
          f"layers, TF32 off, batch {TRAIN_F32_BATCH} x seq {TRAIN_F32_SEQ}]"
          f": microbatches=4 == one batch (ce {ce_rel:.3g}, grads "
          f"{g_rel:.3g} of each leaf's max; limit {MICRO_TOL}); crash at "
          f"step 6, restart from the step-5 checkpoint: steps 6-9 ce equal "
          f"the uninterrupted run's (largest relative difference {rel:.3g},"
          f" limit {RESTART_RTOL}, deterministic algorithms on); two 10-step"
          f" runs with {ckpt_bytes} B checkpoints in {took:.2f} s ({card})")

    # (3) the card against the CPU, one step from the same parameters
    cpu_state = _tree_to(state, "cpu")
    cpu_batch = _tree_to(batch, "cpu")
    _, mg = s.step(state, batch)
    t0 = time.perf_counter()
    _, mc = s.step(cpu_state, cpu_batch)
    cpu_s = time.perf_counter() - t0
    rels = {k: abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
            for k in ("ce", "grad_norm")}
    if max(rels.values()) > CARD_CPU_RTOL:
        raise AssertionError(f"card != CPU: {rels} (limit {CARD_CPU_RTOL})")
    out["card_cpu"] = rels
    print(f"train f32 step on the card == on the CPU from the same "
          f"parameters: ce {float(mg['ce']):.6f} / {float(mc['ce']):.6f}, "
          f"grad_norm {float(mg['grad_norm']):.6f} / "
          f"{float(mc['grad_norm']):.6f}, relative {rels} (limit "
          f"{CARD_CPU_RTOL}); the CPU step took {cpu_s:.1f} s")
    del state, cpu_state, s
    torch.cuda.empty_cache()
    return out


def train_moe(card: str) -> float:
    """deepseek-moe-16b at its published widths (d 2048, 64 routed experts
    top-6 of 1408 + 2 shared, vocab 102400, bf16), its depth cut to 2 of
    its 28 layers (the 28 with AdamW's f32 moments do not fit one card),
    batch 4 x seq 512: 2 AdamW steps through ``launch.train``'s build,
    losses finite, moe_aux > 0, and slots dropped at capacity. Returns the
    first step's ce (phase 8e's one-device reference)."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import mlp
    moe_ffn = mlp.moe_ffn
    drops = []

    def counted(p, x, moe, compute_dtype=None):
        res = moe_ffn(p, x, moe, compute_dtype)
        b, s = x.shape[:2]
        n = s * moe.top_k
        per = torch.nn.functional.one_hot(res[2].reshape(b, n),
                                          moe.n_experts).sum(1)
        drops.append(int(torch.clamp(per - mlp.capacity(n, moe),
                                     min=0).sum()))
        return res

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    args, s = _train_setup(MOE_TRAIN + ["--steps", "2"],
                           lambda c: dataclasses.replace(
                               c, n_layers=F32_LAYERS))
    state, s.state = s.state, None
    mlp.moe_ffn = counted
    recs, times = [], []
    try:
        for i in range(2):
            batch = s.loader.get(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = s.step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            recs.append(_record(metrics))
    finally:
        mlp.moe_ffn = moe_ffn
    _expect_no_launches("MoE training")
    if not all(r["moe_aux"] > 0 for r in recs) or not sum(drops):
        raise AssertionError(f"MoE training: moe_aux "
                             f"{[r['moe_aux'] for r in recs]}, slots "
                             f"dropped {drops}")
    cfg = s.cfg
    print(f"train MoE [{cfg.arch_id}, published widths, depth cut to "
          f"{cfg.n_layers} of 28 layers, {cfg.param_dtype}, AdamW, batch "
          f"{args.batch} x seq {args.seq}]: 2 steps, ce {recs[0]['ce']:.4f} -> "
          f"{recs[1]['ce']:.4f}, moe_aux {recs[0]['moe_aux']:.4g} / "
          f"{recs[1]['moe_aux']:.4g}, slots dropped at capacity per MoE "
          f"call {min(drops)}-{max(drops)} ({len(drops)} calls with remat's "
          f"recompute), {times[0]:.3f} / {times[1]:.3f} s a step, peak "
          f"memory {_gib(torch.cuda.max_memory_allocated())}; launch "
          f"counters all 0 ({card})")
    del state, s, batch, metrics
    torch.cuda.empty_cache()
    return recs[0]["ce"]


# ---- phase 7i: the attention-free and hybrid families (ROADMAP A9b) ------

# the model entry points at the published widths in bf16: prefill of
# 4 x 1024 seeded tokens, then 16 teacher-forced decode steps; the caches
# hold room for the timed steps after them
SSM_ROWS, SSM_PROMPT, SSM_STEPS, SSM_CACHE = 4, 1024, 16, 1152
SSM_SPLITS = 8                        # zamba2's split-KV run
# f32 at the published widths and reduced depth (TF32 off): zamba2-7b at 13
# layer slots (2 groups of 6 + 1 tail), rwkv6-3b at 2 layers; prefill of
# 2 x 256 tokens, 8 decode steps, against forward over all 264
SSM_F32_SLOTS = {"zamba2-7b": 13, "rwkv6-3b": 2}
SSM_F32_ROWS, SSM_F32_PROMPT, SSM_F32_STEPS, SSM_F32_CACHE = 2, 256, 8, 288
# multiport against reference decode in f32: the JAX suite's
# (tests/models/test_decode_equiv.py)
HYBRID_MODE_TOL = dict(atol=2e-4, rtol=1e-4)
# training: 2 AdamW steps at the published widths, depth cut so that the
# functional step (two AdamW states during the update, the grads and
# their clipped f32 copy) fits one card
SSM_TRAIN_SLOTS = {"rwkv6-3b": 8, "zamba2-7b": 7}
SSM_TRAIN = ["--device", "cuda", "--batch", "4", "--seq", "512",
             "--steps", "2"]


def _prefill_decode(M, cfg, params, prompt, feed, cache: int, **kw) -> tuple:
    """``prefill`` of ``prompt`` [B, P], then one ``decode_step`` per
    column of ``feed`` [B, n] (teacher-forced), or ``feed`` greedy steps
    when it is an int. Returns (prefill logits, each step's logits, the
    tokens fed [B, n], the prefill's host seconds, the decode state)."""
    state = M.init_decode_state(cfg, prompt.shape[0], cache,
                                device=prompt.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, lg = M.prefill(params, cfg, state, {"inputs": prompt})
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    greedy = isinstance(feed, int)
    out, fed, tok = [], [], lg.argmax(-1)
    for t in range(feed if greedy else feed.shape[1]):
        x = tok[:, None] if greedy else feed[:, t:t + 1]
        state, step = M.decode_step(params, cfg, state, {"inputs": x}, **kw)
        out.append(step)
        fed.append(x)
        tok = step.argmax(-1)
    return lg, out, torch.cat(fed, 1), took, state


def _host_ms(fn) -> float:
    """The host clock of one call (after one to warm up), ending in
    ``torch.cuda.synchronize()``, in ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _step_bytes(cfg, params, state) -> tuple[int, int]:
    """(the weights' bytes but the embedding table's, the bytes one decode
    step of rwkv6-3b or zamba2-7b must move besides them: the recurrent
    states read and written, each live cached K/V row of the shared block
    read once, B embedding rows)."""
    e = params["embed"]["w"]
    w = _tree_bytes(params) - e.numel() * e.element_size()
    b = state["len"].shape[0]
    live = int(state["len"].max()) + 1
    moved = b * e.shape[1] * e.element_size()
    for key, x in state.items():
        if key in ("attn_k", "attn_v"):
            moved += x[:, :, :live].numel() * x.element_size()
        elif key != "len":
            moved += 2 * _tree_bytes(x)
    return w, moved


def ssm_full_width(arch: str, dev, card: str) -> dict:
    """``arch`` at its published widths in bf16, seed-0 weights, through
    the model entry points with the launch counters set to 0 just before
    and read just after: ``prefill`` of 4 x 1024 seeded tokens, then 16
    multiport ``decode_step``s (zamba2-7b: B1 = 13 x 16, every other
    counter 0; then at num_kv_splits=8 the split pair 13 x 16, B1 0;
    rwkv6-3b: every counter 0), logits finite. Prints the peak memory, the
    prefill's host clock and a decode step's device time beside the
    weight-read bound. Returns the captured decode calls of zamba2-7b by
    split count."""
    from repro_torch import models as M
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.kernels import kv_multiport as kvmp
    from repro_torch.kernels import launch_counts, reset_launch_counts
    cfg = registry.get(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, gen, device=dev)
    ids = torch.randint(0, cfg.vocab, (SSM_ROWS, SSM_PROMPT + SSM_STEPS),
                        generator=gen, device=dev)
    prompt, feed = ids[:, :SSM_PROMPT], ids[:, SSM_PROMPT:]
    hybrid = cfg.family == "hybrid"
    groups = cfg.n_layers // cfg.hybrid.group_size if hybrid else 0
    calls, lines = {}, []
    for ns in (1, SSM_SPLITS) if hybrid else (1,):
        cap = MainPathCapture()
        cap.hook(kvmp, "fused_append_attend", "decode")
        try:
            reset_launch_counts()
            lg, steps, _, took, state = _prefill_decode(
                M, cfg, params, prompt, feed, SSM_CACHE,
                kernel_mode="multiport", num_kv_splits=ns)
            torch.cuda.synchronize()
            counts = launch_counts()
        finally:
            cap.restore()
        want = {k: 0 for k in counts}
        if hybrid and ns == 1:
            want["kv_decode_append_attend"] = groups * SSM_STEPS
        elif hybrid:
            want.update(kv_decode_split_partial=groups * SSM_STEPS,
                        kv_decode_split_combine=groups * SSM_STEPS)
        if counts != want:
            raise AssertionError(f"{arch} ns={ns}: launch counts {counts} "
                                 f"!= {want}")
        if not all(bool(torch.isfinite(g).all()) and tuple(g.shape) ==
                   (SSM_ROWS, cfg.vocab) for g in [lg, *steps]):
            raise AssertionError(f"{arch}: logits not finite or misshapen")
        if hybrid:
            calls[ns] = cap.typical("decode")
        lines.append(f"num_kv_splits={ns}: launch counters {counts}, "
                     f"prefill {took:.3f} s host clock")
        del cap
    peak = torch.cuda.max_memory_allocated()
    x = feed[:, :1]

    def step():
        M.decode_step(params, cfg, state, {"inputs": x},
                      kernel_mode="multiport")
    host_ms = _host_ms(step)
    graph_ms = _graph_ms(step)
    w_all = _tree_bytes(params)
    w, moved = _step_bytes(cfg, params, state)
    weight_bound = w_all / H100_BYTES_PER_S * 1e3
    step_bound = (w + moved) / H100_BYTES_PER_S * 1e3
    n = sum(t.numel() for t in T.leaves(params))
    shape = (f"{cfg.n_layers} layer slots = {groups} groups x "
             f"{cfg.hybrid.group_size} Mamba2 + "
             f"{cfg.n_layers - groups * cfg.hybrid.group_size} tail, d "
             f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of D "
             f"{cfg.head_dim_}, Mamba2 d_in {cfg.ssm.expand * cfg.d_model} "
             f"state {cfg.ssm.state_dim}" if hybrid else
             f"{cfg.n_layers} layers, d {cfg.d_model}, "
             f"{cfg.d_model // cfg.rwkv.head_dim} heads of "
             f"{cfg.rwkv.head_dim}, LoRA {cfg.rwkv.lora_dim}, d_ff "
             f"{cfg.d_ff}")
    print(f"{arch} [published widths, bf16: {shape}, vocab {cfg.vocab}; "
          f"{n / 1e9:.3f} B parameters, {_gib(w_all)}]: prefill of "
          f"{SSM_ROWS} x {SSM_PROMPT} + {SSM_STEPS} multiport decode steps, "
          f"logits finite; " + "; ".join(lines))
    print(f"{arch} decode step [{SSM_ROWS} rows at position "
          f"{int(state['len'][0])}]: {host_ms:.3f} ms host clock launched "
          f"op by op, {graph_ms:.3f} ms on the device as one CUDA graph "
          f"(CUDA events over its replays); weight-read bound "
          f"{w_all / 1e9:.2f} GB / 3.35 TB/s = {weight_bound:.3f} ms; the "
          f"step's byte bound "
          f"{step_bound:.3f} ms (weights once but the embedding table, "
          f"{_gib(moved)} of recurrent states read and written, live K/V "
          f"rows); peak memory {_gib(peak)} ({card})")
    _print_profile(f"{arch} decode step", _profiled(step), card)
    if not hybrid:
        from repro_torch.models import rwkv
        fresh = M.init_decode_state(cfg, SSM_ROWS, SSM_CACHE, device=dev)
        _print_profile(f"{arch} prefill of {SSM_ROWS} x {SSM_PROMPT}",
                       _profiled(lambda: M.prefill(params, cfg, fresh,
                                                   {"inputs": prompt}),
                                 rwkv, "chunked_linear_attention"), card)
        del fresh
    del params, state, lg, steps
    torch.cuda.empty_cache()
    return calls


def _print_profile(what: str, prof: dict, card: str) -> None:
    if not prof["busy_ms"]:
        print(f"{what} under torch.profiler: not measured (the profiler saw "
              f"no device time) ({card})")
        return
    top = ", ".join(f"{k} {ms:.2f} ms" for ms, _, k in prof["ops"][:6])
    line = (f"{what} under torch.profiler [{prof['wall_ms']:.1f} ms host "
            f"clock]: {prof['kernels']} kernels, {prof['busy_ms']:.2f} ms of "
            f"device time summed ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}"
            f" % of the host clock); by operator: {top}")
    if prof["range"] is not None:
        dev, host, n = prof["range"]
        line += (f"; the linear-scan engine ({n} calls) {dev:.1f} ms of the "
                 f"device time ({100 * dev / prof['busy_ms']:.1f} %), "
                 f"{host:.1f} ms of the host clock "
                 f"({100 * host / prof['wall_ms']:.1f} %)")
    print(f"{line} ({card})")


def hybrid_rows(calls: dict) -> dict:
    """B1 on zamba2-7b's decode call (G 1, D 112, Hkv 32, bf16), held
    against its plain version and timed beside it, SDPA and its bound; the
    split pair at ns 2, 4 and 8 on the same call against its plain version
    and the serial kernel, timed beside its plain version; stage 2 alone
    on the ns=8 run's own call. Returns the errors by kernel."""
    from repro_torch.kernels import kv_multiport as kvmp
    args, kw = calls[1]
    q, ck, ln = args[0], args[1], args[5]
    row = time_decode(args, kw)
    c, clusters, fits = cluster_plan(args, kw)
    print(f"kernel kv_decode_append_attend on zamba2-7b's decode call "
          f"[{row['shape']}]: max_abs_err {row['max_abs_err']:.3g}, kernel "
          f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, "
          f"{row['library']} {row['library_ms']:.5f} ms, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']}); one launch of "
          f"{clusters} clusters of {c} blocks (clusters the card holds at "
          f"once, by size: {fits})")
    base = {k: v for k, v in kw.items() if k != "num_kv_splits"}
    tile, n = kvmp.launch_geometry(ck.shape[1], base.get("seq_tile", 128),
                                   base.get("live_len"),
                                   base.get("dynamic_grid", False))
    nbytes, keys = _decode_bytes(args, n * tile)
    bound, by = _bound_ms(nbytes, 4 * q.shape[1] * ck.shape[3] * keys)
    pair = 0.0
    for ns in SPLITS:
        pair = max(pair, *_split_agree(args, base, ns))
        pair_ms = _ms(lambda: kvmp.fused_append_attend(
            *args, num_kv_splits=ns, **base))
        plain_ms = _ms(lambda: kvmp.fused_append_attend_split_plain(
            *args, seq_tile=tile, n_tiles=n,
            length_mask=base.get("length_mask", True), num_kv_splits=ns))
        print(f"split pair at ns={ns} on zamba2-7b's decode call: "
              f"{pair_ms:.5f} ms, plain {plain_ms:.5f} ms, SDPA "
              f"{row['library_ms']:.5f} ms, bound {bound:.6f} ms ({by})")
    s_args, s_kw = calls[SSM_SPLITS]
    _, combine = _hold_split_pair(s_args, s_kw, (SSM_SPLITS,))
    errs = {"kv_decode_append_attend": row["max_abs_err"],
            "kv_decode_split_partial": pair,
            "kv_decode_split_combine": combine}
    # 4e-2 of the output's scale, and never looser than 4e-2 itself
    mean, top = _plain_size(args, base)
    s_mean, s_top = _plain_size(s_args, s_kw)
    limits = {"kv_decode_append_attend": BF16_TOL * min(1.0, top),
              "kv_decode_split_partial": BF16_TOL * min(1.0, top),
              "kv_decode_split_combine": BF16_TOL * min(1.0, s_top)}
    if any(errs[k] > limits[k] for k in errs):
        raise AssertionError(f"a kernel disagrees with its plain version on "
                             f"zamba2-7b's decode call: {errs} beyond "
                             f"{BF16_TOL} x min(1, max |o_plain|): {limits}")
    print(f"zamba2-7b's decode call [q {tuple(q.shape)} {q.dtype}, caches "
          f"{tuple(ck.shape)} {ck.dtype}, lens {ln.tolist()}; plain output "
          f"|o| mean {mean:.4g}, max {top:.4g} (the ns={SSM_SPLITS} run's "
          f"call: {s_mean:.4g}, {s_top:.4g})]: B1, the split pair at ns "
          f"{SPLITS} and stage 2 alone against their plain versions {errs} "
          f"(limits {BF16_TOL} x min(1, max |o_plain|): {limits})")
    return errs


def _as_f32(args) -> tuple:
    """A call's arguments with every floating tensor cast to f32."""
    return tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def _plain_size(args, kw) -> tuple[float, float]:
    """(mean, max) |o| of the plain decode function on a copy of a call."""
    from repro_torch.kernels import kv_multiport as kvmp
    tile, n = kvmp.launch_geometry(args[1].shape[1], kw.get("seq_tile", 128),
                                   kw.get("live_len"),
                                   kw.get("dynamic_grid", False))
    o, _ = kvmp.fused_append_attend_plain(
        *_clones(args), seq_tile=tile, n_tiles=n,
        length_mask=kw.get("length_mask", True))
    o = o.float().abs()
    return float(o.mean()), float(o.max())


def hybrid_call_f32(calls: dict) -> dict:
    """zamba2-7b's decode calls cast to f32 (same rows, keys, lengths and
    tile counts): B1 and the split pair at ns 2, 4 and 8 on the serial
    run's call, stage 2 alone on the ns=8 run's, against their plain
    versions at 1e-5. Returns the errors by kernel."""
    args, kw = calls[1]
    f32 = _as_f32(args)
    s_args, s_kw = calls[SSM_SPLITS]
    base = {k: v for k, v in kw.items() if k != "num_kv_splits"}
    pair, _ = _hold_split_pair(f32, base, SPLITS)
    _, combine = _hold_split_pair(_as_f32(s_args), s_kw, (SSM_SPLITS,))
    errs = {"kv_decode_append_attend": _decode_agree(f32, base),
            "kv_decode_split_partial": pair,
            "kv_decode_split_combine": combine}
    mean, top = _plain_size(f32, base)
    if max(errs.values()) > F32_TOL:
        raise AssertionError(f"a kernel disagrees with its plain version on "
                             f"zamba2-7b's decode call in f32 (limit "
                             f"{F32_TOL}): {errs}")
    print(f"zamba2-7b's decode call cast to f32 [q {tuple(f32[0].shape)}, "
          f"caches {tuple(f32[1].shape)}, lens {f32[5].tolist()}; plain "
          f"output |o| mean {mean:.4g}, max {top:.4g}]: B1, the split pair "
          f"at ns {SPLITS} and stage 2 alone against their plain versions "
          f"{errs} (limit {F32_TOL})")
    return errs


def ssm_f32_identities(dev) -> dict:
    """zamba2-7b at 13 layer slots and rwkv6-3b at 2 layers, published
    widths, f32, TF32 off: ``prefill`` + teacher-forced ``decode_step``s
    equal ``forward`` at the same positions (atol 3e-3, rtol 1e-3, argmax
    identical); for zamba2-7b multiport (B1 = 2 a step) equals reference
    (no launch) within 2e-4 / 1e-4 with identical argmax, and split-KV at
    ns 8 (the split pair 2 a step, B1 0) gives the serial run's greedy
    tokens; the card equals the CPU on one ``forward`` (1e-4). B1 and the
    split pair are held against their plain versions on these runs' calls
    (1e-5). Returns those errors by kernel."""
    from repro_torch import models as M
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.kernels import kv_multiport as kvmp
    from repro_torch.kernels import launch_counts
    errs = {}
    for arch, slots in SSM_F32_SLOTS.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(registry.get(arch), n_layers=slots,
                                  param_dtype="float32",
                                  compute_dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(0)
        params = M.init_params(cfg, gen, device=dev)
        n = SSM_F32_PROMPT + SSM_F32_STEPS
        ids = torch.randint(0, cfg.vocab, (SSM_F32_ROWS, n), generator=gen,
                            device=dev)
        prompt, feed = ids[:, :SSM_F32_PROMPT], ids[:, SSM_F32_PROMPT:]
        full, _ = M.forward(params, cfg, {"inputs": ids})
        hybrid = cfg.family == "hybrid"
        groups = slots // cfg.hybrid.group_size if hybrid else 0
        runs = {}
        for name, kw in (("multiport", dict(kernel_mode="multiport")),
                         ("reference", dict(kernel_mode="reference")),
                         ("split 8", dict(kernel_mode="multiport",
                                          num_kv_splits=SSM_SPLITS))):
            if not hybrid and name != "multiport":
                continue
            cap = MainPathCapture()
            cap.hook(kvmp, "fused_append_attend", "decode")
            before = launch_counts()
            try:
                lg, steps, _, _, _ = _prefill_decode(
                    M, cfg, params, prompt, feed, SSM_F32_CACHE, **kw)
                torch.cuda.synchronize()
            finally:
                cap.restore()
            ran = {k: v - before[k] for k, v in launch_counts().items()
                   if v != before[k]}
            k = SSM_F32_STEPS * groups
            want = ({} if not k or name == "reference" else
                    {"kv_decode_append_attend": k} if name == "multiport"
                    else {"kv_decode_split_partial": k,
                          "kv_decode_split_combine": k})
            if ran != want:
                raise AssertionError(f"{arch} f32 {name}: launched {ran} != "
                                     f"{want}")
            _agree(lg, full[:, SSM_F32_PROMPT - 1], what=f"{arch} prefill "
                   f"vs forward", **PROMPT_TOL)
            for t, st in enumerate(steps):
                _agree(st, full[:, SSM_F32_PROMPT + t], what=f"{arch} {name}"
                       f" step {t} vs forward", **PROMPT_TOL)
                if not torch.equal(st.argmax(-1),
                                   full[:, SSM_F32_PROMPT + t].argmax(-1)):
                    raise AssertionError(f"{arch} {name}: argmax differs "
                                         f"from forward at step {t}")
            runs[name] = steps
            if name == "multiport" and hybrid:
                errs["kv_decode_append_attend"] = _decode_agree(
                    *cap.typical("decode"))
            elif name == "split 8":
                pair, comb = _hold_split_pair(*cap.typical("decode"),
                                              (SSM_SPLITS,))
                errs["kv_decode_split_partial"] = pair
                errs["kv_decode_split_combine"] = comb
            del cap
        unit = "layer slots" if hybrid else "layers"
        line = (f"{arch} [f32, published widths, {slots} {unit}, TF32 "
                f"off]: prefill of {SSM_F32_ROWS} x {SSM_F32_PROMPT} + "
                f"{SSM_F32_STEPS} decode steps == forward over {n} "
                f"positions (atol {PROMPT_TOL['atol']}, rtol "
                f"{PROMPT_TOL['rtol']}, argmax identical)")
        if hybrid:
            mode_err = max(_agree(a, b, what=f"{arch} multiport vs "
                                  f"reference", **HYBRID_MODE_TOL)
                           for a, b in zip(runs["multiport"],
                                           runs["reference"]))
            toks = {}
            for ns in (1, SSM_SPLITS):
                _, _, fed, _, _ = _prefill_decode(
                    M, cfg, params, prompt, SSM_F32_STEPS, SSM_F32_CACHE,
                    kernel_mode="multiport", num_kv_splits=ns)
                toks[ns] = fed.tolist()
            if toks[1] != toks[SSM_SPLITS]:
                raise AssertionError(f"{arch}: split and serial greedy "
                                     f"tokens differ: {toks}")
            line += (f"; multiport == reference (max |diff| {mode_err:.3g} "
                     f"within {HYBRID_MODE_TOL}, argmax identical); split "
                     f"ns {SSM_SPLITS} == serial over "
                     f"{SSM_F32_ROWS * SSM_F32_STEPS} greedy tokens")
        cpu = {"inputs": ids[:1, :64].cpu()}
        on_cpu, _ = M.forward(T.tree_map(lambda x: x.cpu(), params), cfg, cpu)
        on_card, _ = M.forward(params, cfg, {"inputs": ids[:1, :64]})
        e = _agree(on_card, on_cpu.to(dev), CARD_CPU_RTOL, CARD_CPU_RTOL,
                   f"{arch} forward card vs CPU")
        print(f"{line}; forward on the card == on the CPU over 1 x 64 "
              f"tokens (max |diff| {e:.3g}); {time.perf_counter() - t0:.1f}s")
        del params, full, runs
        torch.cuda.empty_cache()
    if max(errs.values()) > F32_TOL:
        raise AssertionError(f"a kernel disagrees with its plain version on "
                             f"the zamba2-7b f32 path: {errs}")
    return errs


def train_ssm_families(card: str) -> dict:
    """rwkv6-3b at 8 of its 32 layers and zamba2-7b at 7 of its 81 layer
    slots (one group of 6 and its shared block, one tail block), published
    widths, bf16, seed-0 weights, the chain task at batch 4 x seq 512: 2
    AdamW steps of each through ``launch.train``'s parse and build, losses
    finite, no kernel launched. Returns each arch's first ce (phase 8e's
    one-device reference)."""
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.kernels import reset_launch_counts
    first_ce = {}
    for arch, slots in SSM_TRAIN_SLOTS.items():
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        args, s = _train_setup(["--arch", arch] + SSM_TRAIN,
                               lambda c: dataclasses.replace(c,
                                                             n_layers=slots))
        state, s.state = s.state, None
        n = sum(x.numel() for x in T.leaves(state["params"]))
        recs, times = [], []
        for i in range(2):
            batch = s.loader.get(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = s.step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            recs.append(_record(metrics))
        _expect_no_launches(f"{arch} training")
        unit = "layer slots" if s.cfg.family == "hybrid" else "layers"
        print(f"train {arch} [published widths, depth cut to {slots} of "
              f"{registry.get(arch).n_layers} {unit}, {n / 1e9:.3f} B parameters, "
              f"{s.cfg.param_dtype}, AdamW, batch {args.batch} x seq "
              f"{args.seq}]: 2 steps, ce {recs[0]['ce']:.4f} -> "
              f"{recs[1]['ce']:.4f}, grad_norm {recs[0]['grad_norm']:.4g} / "
              f"{recs[1]['grad_norm']:.4g}, {times[0]:.3f} / {times[1]:.3f} s "
              f"a step, peak memory {_gib(torch.cuda.max_memory_allocated())};"
              f" launch counters all 0 ({card})")
        first_ce[arch] = recs[0]["ce"]
        del state, s, batch, metrics
        torch.cuda.empty_cache()
    return first_ce


def ssm_families(dev, card: str) -> tuple[dict, dict]:
    """Phase 7i. Returns (the kernels' errors by run, the training steps'
    first ce by arch)."""
    calls = ssm_full_width("zamba2-7b", dev, card)
    errs = {"zamba2_bf16": hybrid_rows(calls),
            "zamba2_call_f32": hybrid_call_f32(calls)}
    del calls
    torch.cuda.empty_cache()
    ssm_full_width("rwkv6-3b", dev, card)
    errs["zamba2_f32"] = ssm_f32_identities(dev)
    return errs, train_ssm_families(card)


# ---- phase 7j: the paper's comparison designs (ROADMAP A2) ---------------

BASE_Q = 8192                   # lanes a port, as the long path's gathers
PAPER = "the paper: 4x bandwidth; 1.3x / 2x area against 8T dual-port / " \
        "12T quad-port"


def _port_mixes(rng) -> list:
    """Every 1-4-port enable set x R/W role mix (80), each under a seeded
    priority permutation."""
    import itertools

    from repro_torch.core import READ, WRITE, PortConfig
    perms = list(itertools.permutations(range(4)))
    out = []
    for m in range(1, 16):
        enabled = tuple(bool(m >> i & 1) for i in range(4))
        on = [i for i in range(4) if enabled[i]]
        for bits in range(1 << len(on)):
            roles = [READ] * 4
            for k, p in enumerate(on):
                roles[p] = WRITE if bits >> k & 1 else READ
            out.append(PortConfig(enabled=enabled, roles=tuple(roles),
                                  priority=perms[int(rng.integers(24))]))
    return out


def _hazard_requests(spec, gen, dev) -> list:
    """4 port bundles of BASE_Q lanes: port 0's addresses at random, and
    the first half of every other port's on port 0's words, so any two
    ports of a mix meet on the same words in their service order; about
    70 % of the lanes on."""
    from repro_torch.core import PortRequest
    addr = torch.randint(0, spec.num_words, (4, BASE_Q), generator=gen,
                         device=dev, dtype=torch.int32)
    addr[1:, :BASE_Q // 2] = addr[0, :BASE_Q // 2]
    mask = torch.rand((4, BASE_Q), generator=gen, device=dev) < 0.7
    return [PortRequest(addr=addr[p], mask=mask[p], data=torch.randn(
        (BASE_Q, spec.word_width), generator=gen, device=dev))
        for p in range(4)]


def _encoder_graph(dev) -> int:
    """encode_dynamic (FSM reset), next_port_dynamic (4 transitions) and
    walk_order_dynamic on CUDA tensors for every mask and permutation,
    captured in ONE CUDA graph (capture fails on any host sync), replayed
    and held against the static encoder and walk. Returns the cases."""
    import itertools

    from repro_torch.core import fsm, priority as prio
    perms = list(itertools.permutations(range(4)))
    masks = [tuple(bool(m >> i & 1) for i in range(4)) for m in range(1, 16)]
    en = torch.tensor(masks, device=dev)
    pr = torch.tensor(perms, dtype=torch.int32, device=dev)

    def run():
        rows = []
        for i in range(len(masks)):
            for j in range(len(perms)):
                cur = fsm.reset_state(en[i], pr[j])
                walk = [cur]
                for _ in range(4):
                    cur = fsm.transition(cur, en[i], pr[j])
                    walk.append(cur)
                ports, active = fsm.walk_order_dynamic(en[i], pr[j])
                rows.append(torch.cat([torch.stack(walk), ports,
                                       active.to(torch.int32)]))
        return torch.stack(rows)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    graph.replay()
    got = got.cpu().tolist()
    for i, enabled in enumerate(masks):
        for j, priority in enumerate(perms):
            row = got[i * len(perms) + j]
            order = prio.order_static(enabled, priority)
            n = len(order)
            idle = [p for p in priority if not enabled[p]]
            want = ([order[k % n] for k in range(5)] + list(order) + idle
                    + [1] * n + [0] * (4 - n))
            if row != want or row[0] != prio.encode_static(enabled,
                                                           priority):
                raise AssertionError(f"tensor encoder/walk {row} != static "
                                     f"{want} for {enabled}, {priority}")
    return len(masks) * len(perms)


def _single_port_calls(args, kw) -> list:
    """B3's packed call of a mix split into one call per port: the
    N-pass schedule through the kernel."""
    from repro_torch.core.ports import WRITE
    storage, addr, payloads, mask = args
    roles, calls, w = kw["roles"], [], 0
    for i, r in enumerate(roles):
        pay = [payloads[w]] if r == WRITE else []
        w += r == WRITE
        calls.append(((storage, addr[i:i + 1], pay, mask[i:i + 1]),
                      dict(roles=(r,))))
    return calls


def paper_comparison(spec, dev, card: str) -> None:
    """Phase 7j."""
    import numpy as np

    from repro_torch.core import READ, WRITE, PortConfig, step
    from repro_torch.core.baselines import (ReplicatedReads, SinglePortNPass,
                                            XorCoded, footprint_ratio)
    from repro_torch.kernels import multiport_sram as mps
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)
    storage = torch.randn((spec.num_words, spec.word_width), generator=gen,
                          device=dev)
    single, rep, xor = (SinglePortNPass(spec), ReplicatedReads(spec, 3),
                        XorCoded(spec))
    replicas = storage.unsqueeze(0).repeat(3, 1, 1)
    banks = storage.reshape(spec.num_banks, spec.words_per_bank, -1).clone()
    parity = banks.sum(0)
    mixes = _port_mixes(np.random.default_rng(7))
    parity_err = 0.0
    for cfg in mixes:
        reqs = _hazard_requests(spec, gen, dev)
        want, want_r = step(spec, cfg, storage, reqs)
        got = {"kernel": ops.multiport_step(spec, cfg, storage.clone(), reqs),
               "SinglePortNPass": single.step(cfg, storage, reqs)}
        r_st, r_reads = rep.step(cfg, replicas, reqs)
        (x_d, x_p), x_reads = xor.step(cfg, (banks, parity), reqs)
        if not all(torch.equal(r, want) for r in r_st):
            raise AssertionError(f"ReplicatedReads storage != step, {cfg}")
        if not torch.equal(x_d.reshape(want.shape), want):
            raise AssertionError(f"XorCoded data != step, {cfg}")
        parity_err = max(parity_err, _agree(x_p, x_d.sum(0), 1e-5, 1e-5,
                                            f"XorCoded parity, {cfg}"))
        got["ReplicatedReads"] = (want, r_reads)
        got["XorCoded"] = (want, x_reads)
        for name, (st, reads) in got.items():
            if not torch.equal(st, want):
                raise AssertionError(f"{name} storage != step, {cfg}")
            for p in range(4):
                if not torch.equal(reads[p], want_r[p]):
                    raise AssertionError(f"{name} port {p} reads != step, "
                                         f"{cfg}")
        del want, want_r, got, r_st, r_reads, x_d, x_p, x_reads, reqs
    torch.cuda.synchronize()
    print(f"paper comparison [{spec.num_words} words x {spec.word_width} "
          f"{spec.dtype}, {spec.num_banks} banks, Q {BASE_Q} a port]: "
          f"{len(mixes)} enable x role mixes under seeded priorities, "
          f"SinglePortNPass, ReplicatedReads(3), XorCoded and the pool-step "
          f"kernel == multiport.step bit for bit (storage and every read); "
          f"XorCoded parity == the sum of its banks within "
          f"{parity_err:.3g} (limit 1e-5); "
          f"{time.perf_counter() - t0:.1f} s")
    cases = _encoder_graph(dev)
    print(f"paper comparison: encode_dynamic, next_port_dynamic and "
          f"walk_order_dynamic over {cases} mask x priority cases captured "
          f"in one CUDA graph (no host sync) == encode_static / "
          f"order_static")

    # the 1W+3R macro-cycle, four ways
    cfg = PortConfig(enabled=(True,) * 4, roles=(WRITE, READ, READ, READ))
    reqs = _hazard_requests(spec, gen, dev)
    cap = MainPathCapture()
    cap.hook(mps, "multiport_sram_step", "pool")
    try:
        ops.multiport_step(spec, cfg, storage.clone(), reqs)
    finally:
        cap.restore()
    args, kw = cap.typical("pool")
    st = args[0]
    singles = _single_port_calls(args, kw)
    one_ms = _ms(lambda: mps.multiport_sram_step(*args, **kw))
    four_ms = _ms(lambda: [mps.multiport_sram_step(*a, **k)
                           for a, k in singles])
    lanes, terms = _pool_bytes(args, kw)
    lanes4 = sum(_pool_bytes(a, k)[0] for a, k in singles)
    bound, by = _bound_ms(lanes, 0.0)
    row = st.shape[1] * st.element_size()
    copy = 2 * spec.num_words * row              # a storage read + written
    on_w = int(args[3][0].sum())
    single_ms = _ms(lambda: single.step(cfg, storage, reqs))
    rep_ms = _ms(lambda: rep.step(cfg, replicas, reqs))
    q = BASE_Q
    lines = [
        ("B3, one traversal of 4 ports", one_ms, lanes),
        ("B3, 4 single-port traversals", four_ms, lanes4),
        ("SinglePortNPass.step (storage copied, then 4 passes)", single_ms,
         copy + lanes),
        ("ReplicatedReads(3).step (3 replicas copied; the write lands in "
         "each)", rep_ms, 3 * copy + lanes + 2 * on_w * row)]
    print(f"paper comparison, the 1W+3R mix [{terms}] ({card}):")
    for what, ms, nbytes in lines:
        print(f"  {what}: {ms:.5f} ms, {nbytes} B moved "
              f"({nbytes / ms / 1e6:.1f} GB/s); bound of the mix "
              f"{bound:.6f} ms ({by})")
    for base in (single, rep, xor):
        c = base.counters(cfg, q)
        print(f"  {type(base).__name__}: {c}; footprint ratio "
              f"{footprint_ratio(c, spec.num_words):.4g}x the proposed "
              f"pool's")
    print(f"  traversal ratio N-pass / one traversal "
          f"{single.counters(cfg, q).storage_traversals}x, bytes ratio "
          f"{lanes4 / lanes:.4g}x, time ratio {four_ms / one_ms:.3f}x "
          f"({PAPER})")


# ---- phase 7k: data-parallel KV over a kv mesh (ROADMAP A8) --------------

KV_SHARDS = 4


def _virtual_mesh(dev):
    from repro_torch.launch.mesh import make_kv_mesh
    return make_kv_mesh(KV_SHARDS, devices=[dev] * KV_SHARDS)


def _expect_by_dev(eng) -> None:
    per = eng.steady_decode_tile_reads_by_dev
    if sum(per) != eng.steady_decode_tile_reads or eng.kv_tile_balance < 1:
        raise AssertionError(f"per-device steady tile reads {per} do not "
                             f"sum to {eng.steady_decode_tile_reads} or "
                             f"balance {eng.kv_tile_balance} < 1")
    print(f"kv mesh: {eng.n_kv_shards} shards, steady decode tile reads by "
          f"device {per} (sum {sum(per)} == {eng.steady_decode_tile_reads}), "
          f"prefill {eng.prefill_tile_reads_by_dev}, balance "
          f"{eng.kv_tile_balance:.3f}x ideal; pool tiles r/w by shard "
          f"{eng.pool.tile_reads_by_shard}/{eng.pool.tile_writes_by_shard}")


def _print_row(what: str, row: dict, calls: int, beside: dict) -> None:
    print(f"kernel {what}, one shard's call on the kv-mesh path "
          f"(x{calls} launches on that path) [{row['shape']}]: max_abs_err "
          f"{row['max_abs_err']:.3g}, kernel {row['ms']:.5f} ms (the "
          f"unsharded call of this run {beside['ms']:.5f} ms), plain "
          f"{row['plain_ms']:.5f} ms, {row['library']} "
          f"{row['library_ms']:.5f} ms, bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']})")


def _mesh_chunk(cap, beside: dict, calls: int) -> dict:
    """B2 on one shard's typical chunk call of a kv-mesh path, held
    against its plain version (the decode kernel's limits: 1e-5 in f32,
    4e-2 for bf16 queries) and printed beside the unsharded call."""
    row = time_chunk(*cap.typical("chunk"))
    q, ck = cap.typical("chunk")[0][:2]
    tol = F32_TOL if q.dtype == ck.dtype == torch.float32 else BF16_TOL
    if row["max_abs_err"] > tol:
        raise AssertionError(f"chunk kernel on a kv-mesh call "
                             f"[{row['shape']}]: max |diff| "
                             f"{row['max_abs_err']:.3g} beyond {tol}")
    _print_row("kv_chunk_append_attend", row, calls, beside)
    return row


def kv_mesh_paths(dev, unsharded: dict, f32_tokens: dict) -> dict:
    """Phase 7k. ``unsharded`` holds this run's rows of the unsharded
    calls; ``f32_tokens`` phase 6's 1-shard f32 greedy tokens. Each path
    builds the engine over the mesh directly. Returns the launch counts of
    the two paths and the kernels' errors."""
    mesh = _virtual_mesh(dev)
    paths, errs = {}, {}
    t0 = time.perf_counter()
    eng, counts, cap = serve_mesh(FULL + SHORT, mesh)
    expect_launches(eng, counts)
    expect_served(eng, 4, 8)
    _expect_by_dev(eng)
    print(f"kv mesh short path: {time.perf_counter() - t0:.2f} s host clock")
    paths["kv mesh short"] = counts
    b1 = time_decode(*cap.typical("decode"))
    b3 = time_pool(*cap.typical("pool"))
    errs["kv_decode_append_attend"] = b1["max_abs_err"]
    errs["multiport_sram_step"] = b3["max_abs_err"]
    _print_row("kv_decode_append_attend", b1,
               counts["kv_decode_append_attend"],
               unsharded["kv_decode_append_attend"])
    errs["kv_chunk_append_attend"] = _mesh_chunk(
        cap, unsharded["chunk short"],
        counts["kv_chunk_append_attend"])["max_abs_err"]
    _print_row("multiport_sram_step", b3, counts["multiport_sram_step"],
               unsharded["multiport_sram_step"])
    del eng, cap
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng, counts, cap = serve_mesh(FULL + LONG + [
        "--num-kv-splits", "8", "--trace", str(LONG_TRACE)], mesh)
    expect_launches(eng, counts)
    expect_served(eng, 4, 8)
    _expect_by_dev(eng)
    print(f"kv mesh long path at --num-kv-splits 8: "
          f"{time.perf_counter() - t0:.2f} s host clock")
    paths["kv mesh long ns 8"] = counts
    pair = time_decode(*cap.typical("decode"))
    gather = time_pool(*cap.largest("pool", _read_lanes_on))
    errs["kv_decode_split_partial"] = pair["max_abs_err"]
    _print_row("kv_decode_split_partial + kv_decode_split_combine (the "
               "pair at ns 8)", pair, counts["kv_decode_split_partial"],
               unsharded["split pair"])
    chunk = _mesh_chunk(cap, unsharded["chunk long"],
                        counts["kv_chunk_append_attend"])
    errs["kv_chunk_append_attend"] = max(errs["kv_chunk_append_attend"],
                                         chunk["max_abs_err"])
    _print_row("multiport_sram_step (largest decode gather)", gather,
               counts["multiport_sram_step"], unsharded["gather"])
    del eng, cap
    torch.cuda.empty_cache()

    eng, counts, _ = serve_mesh(F32 + SHORT, mesh)
    expect_launches(eng, counts)
    toks = _tokens(eng)
    if toks != f32_tokens:
        raise AssertionError(f"f32 tokens at {KV_SHARDS} kv shards differ "
                             f"from 1 shard: {toks} != {f32_tokens}")
    print(f"kv mesh f32 (TF32 off): greedy tokens at {KV_SHARDS} shards == "
          f"1 shard over {sum(map(len, toks.values()))} tokens")
    return paths, errs


# ---- phase 8: sharded training over a data x model mesh (ROADMAP A8b) ----

class Laps:
    """Prints each phase's seconds and the seconds since the script's
    first lap clock started (before the kernels' build)."""

    def __init__(self, card: str):
        self.card, self.t0 = card, time.perf_counter()
        self.t = self.t0

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - self.t:.1f} s ({now - self.t0:.1f} s "
              f"since the start) ({self.card})")
        self.t = now


MESH_TIMEOUT = 300              # seconds: each local job of ranks
SHARDED_STEPS = 2               # full-width sharded AdamW steps (8d holds
                                # its trace to the second one's peak)
# the JAX multidevice test's tolerances (tests/distributed/test_multidevice.py)
MESH_CE_RTOL = 1e-5
MESH_W_TOL = dict(atol=2e-5, rtol=1e-4)
# the dry run's per-rank bytes (arguments + temporaries) against a measured
# step's peak
DRYRUN_PEAK_TOL = 0.15
# the state leaves whose placements 8b and 8e print, where a model has them
PLACEMENTS_SHOWN = ("params/lm_head/w", "opt/m/lm_head/w",
                    "params/layers/attn/wk/w", "params/layers/moe/w_gate",
                    "params/layers/tm/wr/w", "params/groups/mamba/in_x/w")
# 8e: the full-width training cuts of phases 7f and 7i (layers), one AdamW
# step each over (data 2, model 2), the three in one job of ranks (a second
# step took the whole script past 15 minutes)
FAMILY_TRAIN = {"deepseek-moe-16b": (MOE_TRAIN, F32_LAYERS),
                **{a: (["--arch", a, *SSM_TRAIN[:-2]], n)
                   for a, n in SSM_TRAIN_SLOTS.items()}}
MESH_FAMILY_STEPS = 1
FAMILY_F32_STEPS = 2
# grad_norm: tests/test_torch_mesh_families.py's tolerance (RWKV6's
# gradient is ill-conditioned: a sum split over ranks moves it further
# than its ce)
MESH_GRAD_NORM_RTOL = 2e-4
# 8f: f32 at 2 layers (zamba2-7b at 8e's 7 slots: fewer leave out its
# shared attention block), TF32 off, batch 4 x 256, all five in one job of
# ranks, 2 steps: launch.train's warmup is then 1 step, so step 0's
# learning rate is 0 and step 1 moves every parameter; each step's
# grad_norm holds the gradients' size, the last lm_head/w their direction
# (a first AdamW step at the full rate moves each weight by about the rate
# whatever the size of its gradient, so a rounding difference in a
# gradient near 0 would move a weight by more than lm_head/w's tolerance;
# the CPU tests hold every family's backward to JAX's over 3 steps)
FAMILY_F32 = {"deepseek-moe-16b": F32_LAYERS, "qwen2-vl-7b": F32_LAYERS,
              "musicgen-large": F32_LAYERS, "rwkv6-3b": F32_LAYERS,
              "zamba2-7b": SSM_TRAIN_SLOTS["zamba2-7b"]}
# 8d: the dry run's train_4k cells of the moe, ssm and hybrid families, at
# these depths (zamba2-7b's 7 slots hold its shared attention block)
FAMILY_CELLS = {"deepseek-moe-16b": F32_LAYERS, "rwkv6-3b": F32_LAYERS,
                "zamba2-7b": SSM_TRAIN_SLOTS["zamba2-7b"]}


def _mesh_job(fn: str, world: int, module: str = "chip_smoke",
              **kwargs) -> list:
    """``fn`` (of this file unless ``module`` says) on ``world`` ranks that
    share the card (``launch.local_ranks``: one process each, the
    peer-memory group it chooses for them); each rank's result, in rank
    order."""
    from repro_torch.launch import local_ranks
    return local_ranks.run(f"{module}:{fn}", world, device="cuda",
                           kwargs=kwargs, timeout=MESH_TIMEOUT,
                           path=[str(ROOT)],
                           workdir=str(ROOT / "build" / "chip_smoke" /
                                       "ranks" / fn))


def _expect_backend(name: str = "peermem") -> None:
    """On a rank: its process group is ``name``'s (phase 8's ranks share
    the card, so ``local_ranks`` gives them the peer-memory one)."""
    import torch.distributed as dist
    if dist.get_backend() != name:
        raise AssertionError(f"rank {dist.get_rank()} joined "
                             f"{dist.get_backend()!r}, not {name}")


def rank_probe() -> dict:
    """8a, on each rank: ``hoststaged.probe``'s collectives on CUDA
    tensors over the peer-memory group, and the bytes they moved on the
    card."""
    from repro_torch.distributed import hoststaged, peermem
    _expect_backend()
    peermem.reset_stats()
    return {"ok": hoststaged.probe("cuda"), "moved": dict(peermem.MOVED)}


def _on_mesh(argv: list, mesh, cfg_edit=None):
    """``launch.train``'s parse and ``build_on_mesh`` (every rank calls
    it), the config edited by ``cfg_edit`` when given."""
    from repro_torch.launch import train
    args = train.parse_args(argv)
    orig = train.arch_config
    if cfg_edit is not None:
        train.arch_config = lambda a: cfg_edit(orig(a))
    try:
        return args, train.build_on_mesh(args, mesh)
    finally:
        train.arch_config = orig


def rank_families_full_width(runs: dict, steps: int) -> dict:
    """8e, on each rank: ``rank_full_width`` of each arch of ``runs`` (arch
    -> [argv, layers]) in turn, what the one before left freed first."""
    import gc
    out = {}
    for arch, (argv, layers) in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = rank_full_width(argv, steps, layers)
    return out


def rank_full_width(argv: list, steps: int, layers: int | None = None,
                    backend: str = "peermem") -> dict:
    """8b and 8e, on each rank: ``launch.train.build_on_mesh`` over (data
    2, model 2), the depth cut to ``layers`` when given, and ``steps``
    AdamW steps; each step's ce, grad_norm, host time (all ranks start it
    together, it ends at the card's sync), the collectives this rank
    counted and the bytes they moved on the card; the rank's peak memory
    and state bytes."""
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.distributed import peermem
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    _expect_backend(backend)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = make_mesh((2, 2), ("data", "model"))
    _, s = _on_mesh(argv, mesh, None if layers is None else
                    lambda c: dataclasses.replace(c, n_layers=layers))
    state, s.state = s.state, None
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    recs, peak = [], 0
    for i in range(steps):
        batch = s.loader.get(i)
        dist.barrier()
        peermem.reset_stats()
        torch.cuda.synchronize()
        # a step after the first alone: its peak, without the draw of the
        # full parameters at init (phase 8d's prediction is held to it)
        peak = max(peak, torch.cuda.max_memory_allocated())
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = s.step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = _record(metrics)
        recs.append({"ce": rec["ce"], "grad_norm": rec["grad_norm"], "s": dt,
                     "counted": dict(peermem.STATS),
                     "moved": dict(peermem.MOVED), "held": held,
                     "step_peak": torch.cuda.max_memory_allocated()})
    local = sum(x.to_local().numel() * x.element_size()
                for x in T.leaves(state))
    placed = {shd.path_str(p): str(x.placements)
              for p, x in T.leaves_with_path(state)
              if shd.path_str(p) in PLACEMENTS_SHOWN}
    return {"steps": recs, "init_s": init_s,
            "peak": max(peak, torch.cuda.max_memory_allocated()),
            "state_bytes": local, "placements": placed}


def rank_f32_identities(argv: list, ckpt_dir: str) -> dict:
    """8c, on each of 4 ranks, f32 at 2 layers, TF32 off: (1) one sharded
    step on (data 2, model 2) against the same step on one device (rank 0
    computes it): ce at rtol 1e-5, ``lm_head/w`` at 2e-5 / 1e-4; the state
    is saved and a second step taken (the elastic run's reference); (2)
    the compressed step (int8_ef, 2 pods) on (pod 2, data 1, model 2)
    against one device's, with the int8 all-reduce across the pods
    counted."""
    import torch.distributed as dist

    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import peermem
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    _expect_backend()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    out = {}
    for what, shape, axes, extra in (
            ("sharded", (2, 2), ("data", "model"), []),
            ("compressed", (2, 1, 2), ("pod", "data", "model"),
             ["--multi-pod", "--compress-grads"])):
        mesh = make_mesh(shape, axes)
        args, s = _on_mesh(argv + extra, mesh, _f32_cut(F32_LAYERS))
        peermem.reset_stats()
        state, m = s.step(s.state, s.loader.get(0))
        counted = dict(peermem.STATS)
        w = state["params"]["lm_head"]["w"].full_tensor()
        row = {"ce": float(m["ce"]), "counted": counted}
        if rank == 0:
            orig = train.arch_config
            train.arch_config = lambda a: _f32_cut(F32_LAYERS)(orig(a))
            try:
                one = train.build(args)
            finally:
                train.arch_config = orig
            s1, m1 = one.step(one.state, one.loader.get(0))
            row["ce_one"] = float(m1["ce"])
            row["ce_diff"] = _agree(torch.tensor(row["ce"]),
                                    torch.tensor(row["ce_one"]), 0.0,
                                    MESH_CE_RTOL, f"{what} ce")
            row["w_diff"] = _agree(w, s1["params"]["lm_head"]["w"],
                                   MESH_W_TOL["atol"], MESH_W_TOL["rtol"],
                                   f"{what} lm_head/w")
            del one, s1
        if what == "sharded":
            ckpt.save(ckpt_dir, 0, state)
            _, m2 = s.step(state, s.loader.get(1))
            row["ce_next"] = float(m2["ce"])
        out[what] = row
        del state, s
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def rank_elastic(argv: list, ckpt_dir: str) -> dict:
    """8c (3), on each of 2 ranks: the checkpoint saved on (data 2, model
    2) restored onto (data 2, model 1) by the JAX package's rules, and the
    next step's ce."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs as SP
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    _expect_backend()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((2, 1), ("data", "model"))
    args = train.parse_args(argv)
    cfg = _f32_cut(F32_LAYERS)(train.arch_config(args))
    tcfg = train.train_config(args)
    rules = shd.Rules.for_mesh(mesh)
    shapes = SP.train_state_shapes(cfg, tcfg)
    specs = SP.train_state_pspecs(cfg, mesh, rules, shapes)
    state, _ = ckpt.restore(ckpt_dir, shapes, shardings=shd.named(mesh, specs))
    loader = ShardedLoader(cfg, DataConfig(seed=0), batch=args.batch,
                           seq=args.seq, device="cuda",
                           shardings=shd.named(mesh, shd.batch_specs(
                               cfg, mesh, rules, global_batch=args.batch)))
    from repro_torch.train.train_step import make_train_step
    _, m = make_train_step(cfg, tcfg)(state, loader.get(1))
    return {"ce": float(m["ce"]),
            "placement": str(state["params"]["lm_head"]["w"].placements)}


def _f32_steps(s) -> tuple:
    """``FAMILY_F32_STEPS`` steps of a ``launch.train`` build from its state:
    (the last state, each step's ce, each step's grad_norm)."""
    state, ces, norms = s.state, [], []
    s.state = None
    for i in range(FAMILY_F32_STEPS):
        state, m = s.step(state, s.loader.get(i))
        ces.append(float(m["ce"]))
        norms.append(float(m["grad_norm"]))
    return state, ces, norms


def rank_family_identities(refs: dict) -> dict:
    """8f, on each of 4 ranks, f32, TF32 off, batch 4 x 256: for each arch
    of ``refs`` (arch -> [layers, the path of the one-device steps' ce,
    grad_norm and last ``lm_head/w``, which the parent computed]),
    ``FAMILY_F32_STEPS`` sharded steps on (data 2, model 2); rank 0 holds
    them to the one-device steps (``_f32_steps``): each step's ce at rtol
    1e-5 and grad_norm at 2e-4, the last ``lm_head/w`` at 2e-5 / 1e-4."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    _expect_backend()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch, (layers, ref) in refs.items():
        t0 = time.perf_counter()
        _, s = _on_mesh(_f32_argv(arch), mesh, _f32_cut(layers))
        state, ces, norms = _f32_steps(s)
        w = state["params"]["lm_head"]["w"].full_tensor()
        row = {"ce": ces, "grad_norm": norms, "s": time.perf_counter() - t0}
        del state, s
        if dist.get_rank() == 0:
            one = torch.load(ref)
            row["ce_one"], row["grad_norm_one"] = one["ce"], one["grad_norm"]
            row["ce_diff"] = _agree(torch.tensor(ces), torch.tensor(one["ce"]),
                                    0.0, MESH_CE_RTOL, f"8f {arch} ce")
            row["grad_norm_diff"] = _agree(
                torch.tensor(norms), torch.tensor(one["grad_norm"]), 0.0,
                MESH_GRAD_NORM_RTOL, f"8f {arch} grad_norm")
            row["w_diff"] = _agree(w, one["w"].to(w.device),
                                   MESH_W_TOL["atol"], MESH_W_TOL["rtol"],
                                   f"8f {arch} lm_head/w")
            del one
        del w
        torch.cuda.empty_cache()
        dist.barrier()
        out[arch] = row
    return out


def _f32_argv(arch: str) -> list:
    return ["--arch", arch, "--device", "cuda", "--batch",
            str(TRAIN_F32_BATCH), "--seq", str(TRAIN_F32_SEQ), "--steps",
            str(FAMILY_F32_STEPS)]


def family_f32_references(root: Path) -> dict:
    """8f's one-device steps, in this process before the ranks start (a
    one-device f32 AdamW step of deepseek-moe-16b at 2 layers holds about
    45 GB: beside 4 ranks it does not fit the card): arch -> [layers, the
    saved steps' ce, grad_norm and last ``lm_head/w``]."""
    import gc
    root.mkdir(parents=True, exist_ok=True)
    refs = {}
    for arch, layers in FAMILY_F32.items():
        _, one = _train_setup(_f32_argv(arch), _f32_cut(layers))
        state, ces, norms = _f32_steps(one)
        path = root / f"{arch}.pt"
        torch.save({"ce": ces, "grad_norm": norms,
                    "w": state["params"]["lm_head"]["w"].cpu()}, path)
        refs[arch] = [layers, str(path)]
        del one, state
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def _counted_line(counted: dict) -> str:
    return ", ".join(f"{k} x{n} {b / 2**20:.1f} MiB"
                     for k, (n, b) in sorted(counted.items()))


def _moved_line(moved: dict) -> str:
    """A rank's bytes moved on the card through the peer-memory group."""
    return (f"{moved.get('written', 0) / 2**20:.1f} MiB written to its slot, "
            f"{moved.get('read', 0) / 2**20:.1f} MiB read from the slots, "
            f"{moved.get('rounds', 0)} rounds")


def _print_cell(rec: dict, card: str, cut: str = "") -> None:
    if rec["status"] != "ok" or rec["traced_on"] != "cuda":
        raise AssertionError(f"8d: dry run {rec['arch']} x {rec['shape']} x "
                             f"{rec['mesh']}: {rec['status']} on "
                             f"{rec['traced_on']}: "
                             f"{rec.get('traceback', '')}")
    m, o = rec["memory"], rec["ops"]
    coll = ", ".join(f"{k} {v / 2**30:.3f} GiB"
                     for k, v in o["collective_bytes"].items() if v)
    print(f"dry run 8d [prediction, {rec['chips']} ranks, traced on "
          f"{rec['traced_on']}, {rec['trace_s']:.1f} s{cut}] {rec['arch']} x "
          f"{rec['shape']} x {rec['mesh']}: {rec['status']}; a rank's "
          f"arguments {_gib(m['argument_bytes'])}, temporaries "
          f"{_gib(m['temp_bytes'])}, dot_flops {o['dot_flops']:.4g}, "
          f"collective bytes {coll or 'none'} ({card})")


def dry_run(card: str, r0: dict) -> None:
    """8d: 8b's step traced on fake CUDA tensors as rank 0 of a counting
    world of 4, held to rank 0's counted collectives (exact) and its peak
    in a step after the first (15 %); then the dry run's cells of
    tinyllama-1.1b, llama3-405b ``train_4k`` on 512 ranks, and the
    ``train_4k`` cells of the moe, ssm and hybrid families, at their
    published widths and 2 layers (``FAMILY_CELLS``' for those families):
    which rule a layer meets does not depend on the depth; the full depths
    are the sweep's (``python -m repro_torch.launch.dryrun --all``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeCell, applicable_shapes
    from repro_torch.distributed import countgroup
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, op_analysis, train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import make_train_step
    args = train.parse_args(TRAIN + ["--steps", str(SHARDED_STEPS)])
    cfg, tcfg = train.arch_config(args), train.train_config(args)
    cell = ShapeCell("8b", args.seq, args.batch, "train")
    t0 = time.perf_counter()
    with countgroup.world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        with FakeTensorMode(allow_non_fake_inputs=True):
            state, batch = dryrun.train_args(cfg, tcfg, cell, mesh,
                                             shd.Rules.for_mesh(mesh))
        _, ops = op_analysis.analyze(make_train_step(cfg, tcfg), state,
                                     batch)
    took = time.perf_counter() - t0
    last = r0["steps"][-1]
    want, got = last["counted"], ops["staged"]
    if got != want:
        raise AssertionError(
            "8d: the traced collectives differ from rank 0's counted ones: "
            + "; ".join(f"{k}: traced {got.get(k)} counted {want.get(k)}"
                        for k in sorted(set(got) | set(want))
                        if got.get(k) != want.get(k)))
    predicted = ops["argument_bytes"] + ops["temp_bytes"]
    ratio = predicted / last["step_peak"]
    if abs(ratio - 1) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"8d: predicted {predicted} bytes a rank, "
                             f"rank 0's step peak {last['step_peak']} "
                             f"(x{ratio:.3f}, limit {DRYRUN_PEAK_TOL})")
    print(f"dry run 8d [8b's step traced on fake CUDA tensors, rank 0 of a "
          f"counting world of 4, {took:.1f} s]: collectives == rank 0's "
          f"peermem tally exactly ({_counted_line(got)}); predicted "
          f"arguments {_gib(ops['argument_bytes'])} + temporaries "
          f"{_gib(ops['temp_bytes'])} = {_gib(predicted)} against rank 0's "
          f"peak in step {len(r0['steps']) - 1} alone "
          f"{_gib(last['step_peak'])} ({_gib(last['held'])} held as it "
          f"started): x{ratio:.4f} (limit "
          f"{DRYRUN_PEAK_TOL}); dot_flops {ops['dot_flops']:.4g} ({card})")
    cells = [("tinyllama-1.1b", c.name, "single", F32_LAYERS) for c in
             applicable_shapes(registry.get("tinyllama-1.1b"))]
    cells += [("llama3-405b", "train_4k", "multi", F32_LAYERS)]
    cells += [(a, "train_4k", "single", n) for a, n in FAMILY_CELLS.items()]
    cut_cells(card, ROOT / "build" / "chip_smoke" / "dryrun", cells)


def cut_cells(card: str, out: Path, cells: list) -> None:
    """The dry run's cells (arch, shape, mesh, layers) at their published
    widths, the depth cut to ``layers``: each ``ok``, traced on the card's
    path."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    get = registry.get
    for arch, shape, mk, layers in cells:
        registry.get = lambda a, **kw: dataclasses.replace(get(a, **kw),
                                                           n_layers=layers)
        try:
            rec = dryrun.run_cell(arch, shape, mk, str(out), force=True)
        finally:
            registry.get = get
        _print_cell(rec, card, f", {layers} of {get(arch).n_layers} layers")


def _vals(xs: list) -> str:
    return ", ".join(f"{x:.7f}" for x in xs)


def _secs(rank: dict, i: int) -> str:
    return f"{rank['steps'][i]['s']:.3f}"


def family_training(card: str, family_ce: dict, lap) -> None:
    """8e: deepseek-moe-16b, rwkv6-3b and zamba2-7b at their published
    widths and phases 7f / 7i's depth cuts over (data 2, model 2), 4
    ranks on the card, the three in one job: one AdamW step each, its ce
    within 4e-2 of that phase's one-device first step. 8f: the five
    non-dense families in f32 at 2 layers (zamba2-7b at 7 slots), TF32
    off, 2 steps (lr 0 in the first): sharded == one device (each step's
    ce rtol 1e-5 and grad_norm 2e-4, the last ``lm_head/w`` 2e-5 / 1e-4),
    the one-device steps in this process first, then the five in one job
    of ranks."""
    import gc
    import shutil
    gc.collect()
    torch.cuda.empty_cache()
    n = 4
    t0 = time.perf_counter()
    jobs = _mesh_job("rank_families_full_width", n, steps=MESH_FAMILY_STEPS,
                     runs={a: [argv + ["--steps", str(MESH_FAMILY_STEPS)],
                               layers]
                           for a, (argv, layers) in FAMILY_TRAIN.items()})
    for arch, (_, layers) in FAMILY_TRAIN.items():
        ranks = [job[arch] for job in jobs]
        r0 = ranks[0]
        ce, want = r0["steps"][0]["ce"], family_ce[arch]
        if abs(ce - want) > BF16_TOL:
            raise AssertionError(f"8e {arch}: sharded step 1 ce {ce} != one "
                                 f"device's {want} (limit {BF16_TOL})")
        if any(r["steps"][i]["ce"] != r0["steps"][i]["ce"]
               for r in ranks for i in range(MESH_FAMILY_STEPS)):
            raise AssertionError(f"8e {arch}: ranks disagree on the ce")
        for i, rec in enumerate(r0["steps"]):
            print(f"mesh 8e [{arch}, published widths, {layers} layers, "
                  f"bf16, AdamW, batch 4 x 512, data 2 x model 2, {n} ranks "
                  f"on the card] step {i}: ce {rec['ce']:.4f}, grad_norm "
                  f"{rec['grad_norm']:.4f}; seconds by rank "
                  f"{', '.join(_secs(r, i) for r in ranks)}"
                  f"; rank 0's collectives {_counted_line(rec['counted'])}; "
                  f"rank 0 moved {_moved_line(rec['moved'])} ({card})")
        counted = [sum(b for _, b in r["steps"][-1]["counted"].values())
                   for r in ranks]
        print(f"mesh 8e {arch}: step 1 ce {ce:.6f} vs one device "
              f"{want:.6f} (|diff| {abs(ce - want):.3g}, limit {BF16_TOL}); "
              f"peak memory by rank {', '.join(_gib(r['peak']) for r in ranks)}"
              f"; collective bytes in step {MESH_FAMILY_STEPS - 1} by rank "
              f"{', '.join(f'{b / 2**30:.2f} GiB' for b in counted)}; state "
              f"bytes by rank "
              f"{', '.join(_gib(r['state_bytes']) for r in ranks)}; init "
              f"{r0['init_s']:.1f} s; placements {r0['placements']} ({card})")
    print(f"mesh 8e: {', '.join(FAMILY_TRAIN)} in one job of {n} ranks, "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    lap("8e")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke" / "f32_refs"
    refs = family_f32_references(root)
    print(f"mesh 8f: the one-device f32 steps in {time.perf_counter() - t0:.1f}"
          f" s ({card})")
    t0 = time.perf_counter()
    got = _mesh_job("rank_family_identities", n, refs=refs)[0]
    for arch, row in got.items():
        print(f"mesh 8f [{arch}, f32, {FAMILY_F32[arch]} layers, TF32 off, "
              f"batch {TRAIN_F32_BATCH} x {TRAIN_F32_SEQ}, "
              f"{FAMILY_F32_STEPS} steps, lr 0 in step 0]: sharded (data 2, "
              f"model 2) == one device: ce {_vals(row['ce'])} / "
              f"{_vals(row['ce_one'])} (|diff| {row['ce_diff']:.3g}, rtol "
              f"{MESH_CE_RTOL}), grad_norm {_vals(row['grad_norm'])} / "
              f"{_vals(row['grad_norm_one'])} (|diff| "
              f"{row['grad_norm_diff']:.3g}, rtol {MESH_GRAD_NORM_RTOL}), "
              f"last lm_head/w |diff| {row['w_diff']:.3g} ({MESH_W_TOL}); "
              f"sharded steps with their build {row['s']:.1f} s ({card})")
    print(f"mesh 8f: {', '.join(got)} in one job of {n} ranks, "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    shutil.rmtree(root, ignore_errors=True)
    lap("8f")


def sharded_training(card: str, one_device: dict, family_ce: dict,
                     lap) -> None:
    """Phase 8: 8a the collective probe, 8b tinyllama-1.1b at its
    published widths over (data 2, model 2) with 4 ranks on the card,
    8c the f32 identities (sharded == one device, the compressed step's
    int8 pod all-reduce, the elastic restart on 2 ranks), 8d the dry run
    held to 8b, 8e and 8f the non-dense families (``family_ce``: their
    one-device first ce by arch)."""
    import gc
    import shutil
    n = 4
    # the ranks share the card with this process: free what earlier
    # phases left unreferenced
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mesh: this process holds {_gib(torch.cuda.memory_allocated())} "
          f"allocated, {_gib(torch.cuda.memory_reserved())} reserved as the "
          f"ranks start ({card})")
    t0 = time.perf_counter()
    probe = _mesh_job("rank_probe", n)
    bad = {r: [k for k, v in res["ok"].items() if not v]
           for r, res in enumerate(probe)}
    if any(bad.values()):
        raise AssertionError(f"collectives on CUDA tensors disagree with "
                             f"their local reductions: {bad}")
    print(f"mesh 8a [{n} ranks on the card, peer memory]: "
          f"{len(probe[0]['ok'])} collectives on CUDA tensors == their local "
          f"reductions on every rank ({', '.join(probe[0]['ok'])}); rank 0 "
          f"moved {_moved_line(probe[0]['moved'])} "
          f"({time.perf_counter() - t0:.1f} s) ({card})")
    lap("8a")

    t0 = time.perf_counter()
    argv = TRAIN + ["--steps", str(SHARDED_STEPS)]
    ranks = _mesh_job("rank_full_width", n, argv=argv, steps=SHARDED_STEPS)
    took = time.perf_counter() - t0
    r0 = ranks[0]
    ce = r0["steps"][0]["ce"]
    if abs(ce - one_device["ce"]) > BF16_TOL:
        raise AssertionError(f"sharded full-width step 1 ce {ce} != one "
                             f"device's {one_device['ce']} (limit {BF16_TOL})")
    if any(abs(r["steps"][i]["ce"] - r0["steps"][i]["ce"]) > 0
           for r in ranks for i in range(SHARDED_STEPS)):
        raise AssertionError("ranks disagree on the replicated ce")
    times = [rec["s"] for rec in r0["steps"]]
    steady = statistics.median(times[1:])
    for i, rec in enumerate(r0["steps"]):
        print(f"mesh 8b [tinyllama-1.1b, published widths, bf16, AdamW, "
              f"batch 8 x 1024, data 2 x model 2, {n} ranks on the card] "
              f"step {i}: ce {rec['ce']:.4f}, grad_norm "
              f"{rec['grad_norm']:.4f}, {rec['s']:.3f} s; rank 0's "
              f"collectives {_counted_line(rec['counted'])}; rank 0 moved "
              f"{_moved_line(rec['moved'])} ({card})")
    per_rank = [sum(b for _, b in r["steps"][-1]["counted"].values())
                for r in ranks]
    moved = [f"{_gib(r['steps'][-1]['moved'].get('written', 0))} / "
             f"{_gib(r['steps'][-1]['moved'].get('read', 0))}" for r in ranks]
    print(f"mesh 8b: step 1 ce {ce:.6f} vs one device {one_device['ce']:.6f}"
          f" (|diff| {abs(ce - one_device['ce']):.3g}, limit {BF16_TOL}); "
          f"median of steps 1-{SHARDED_STEPS - 1} {steady:.3f} s against "
          f"the recorded one-device {RECORDED_STEP_S} s and this run's "
          f"{one_device['step_s']:.4f} s "
          f"(x{steady / one_device['step_s']:.1f})"
          f"; peak memory by rank "
          f"{', '.join(_gib(r['peak']) for r in ranks)}; state bytes by rank "
          f"{', '.join(_gib(r['state_bytes']) for r in ranks)}; collective "
          f"bytes a step by rank "
          f"{', '.join(f'{b / 2**30:.2f} GiB' for b in per_rank)}, moved on "
          f"the card by rank (written / read) "
          f"{', '.join(moved)}"
          f"; peak in step {SHARDED_STEPS - 1} alone by rank "
          f"{', '.join(_gib(r['steps'][-1]['step_peak']) for r in ranks)}"
          f"; init {r0['init_s']:.1f} s; placements {r0['placements']}; job "
          f"{took:.1f} s ({card})")
    lap("8b")

    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke" / "mesh_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    argv = TRAIN_ARCH + ["--batch", str(TRAIN_F32_BATCH), "--seq",
                         str(TRAIN_F32_SEQ), "--steps", "2"]
    ident = _mesh_job("rank_f32_identities", n, argv=argv,
                      ckpt_dir=str(root))[0]
    sh, cp = ident["sharded"], ident["compressed"]
    int8 = {k: v for k, v in cp["counted"].items()
            if k.startswith("all_reduce int8 x2")}
    if not int8:
        raise AssertionError(f"compressed step: no int8 all-reduce across "
                             f"the 2 pods; counted {cp['counted']}")
    print(f"mesh 8c [f32, {F32_LAYERS} of 22 layers, TF32 off, batch "
          f"{TRAIN_F32_BATCH} x {TRAIN_F32_SEQ}]: sharded (data 2, model 2) "
          f"== one device: ce {sh['ce']:.7f} / {sh['ce_one']:.7f} (|diff| "
          f"{sh['ce_diff']:.3g}, rtol {MESH_CE_RTOL}), lm_head/w |diff| "
          f"{sh['w_diff']:.3g} ({MESH_W_TOL}); compressed int8_ef (pod 2, "
          f"data 1, model 2) == one device's 2-pod step: ce {cp['ce']:.7f} / "
          f"{cp['ce_one']:.7f} (|diff| {cp['ce_diff']:.3g}), lm_head/w "
          f"|diff| {cp['w_diff']:.3g}; the pods' int8 all-reduce "
          f"{_counted_line(int8)} of rank 0's {_counted_line(cp['counted'])} "
          f"({card})")
    elastic = _mesh_job("rank_elastic", 2, argv=argv, ckpt_dir=str(root))
    d = _agree(torch.tensor(elastic[0]["ce"]), torch.tensor(sh["ce_next"]),
               0.0, MESH_CE_RTOL, "elastic restart ce")
    shutil.rmtree(root, ignore_errors=True)
    print(f"mesh 8c elastic: saved on (data 2, model 2) by 4 ranks, "
          f"restored onto (data 2, model 1) by 2 ranks (lm_head/w "
          f"{elastic[0]['placement']}): next step ce {elastic[0]['ce']:.7f} "
          f"vs {sh['ce_next']:.7f} going on at (2, 2) (|diff| {d:.3g}, rtol "
          f"{MESH_CE_RTOL}); 8c in {time.perf_counter() - t0:.1f} s ({card})")
    lap("8c")
    dry_run(card, r0)
    lap("8d")
    family_training(card, family_ce, lap)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # before cuBLAS starts: the restart check (train_f32_identity) runs
    # under torch.use_deterministic_algorithms, which needs a fixed cuBLAS
    # workspace (this is the size PyTorch takes on Hopper by default)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    lap = Laps(card)
    t0 = time.perf_counter()
    took = K.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s "
          f"(nvcc per source: { {k: round(v, 1) for k, v in took.items()} })")
    lap("1")
    for log in sorted(K._build.BUILD_DIR.glob("*.ptxas.txt")):
        text = log.read_text()
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                               text))
        print(f"  ptxas {log.name.split('.')[0]}: {len(regs)} kernels, "
              f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
              f"{spill} bytes of spill stores")


    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flash = check_flash(dev, gen)
    errs = {"kv_decode_append_attend": check_decode(dev, gen),
            "kv_chunk_append_attend": check_chunk(dev, gen),
            "multiport_sram_step": check_pool_step(dev, gen),
            "flash_attention": {"f32": flash["f32"]},
            "flash_attention_tc": {"bf16": flash["bf16"]}}
    split_errs = check_split(dev, gen)
    errs["kv_decode_split_partial"] = {k: v for k, v in split_errs.items()
                                       if k != "combine"}
    errs["kv_decode_split_combine"] = {"combine": split_errs["combine"]}
    for name, e in errs.items():
        print(f"check {name}: agrees with its plain version {e}")
    lap("2")

    found = {}      # kernel name -> (timing row, launches on its path)
    paths = {}      # path -> its launch counts
    counts, cap = serve_full_width()
    paths["short"] = counts
    for name, timer, call in (("kv_decode_append_attend", time_decode,
                               "decode"),
                              ("kv_chunk_append_attend", time_chunk, "chunk"),
                              ("multiport_sram_step", time_pool, "pool")):
        found[name] = (timer(*cap.typical(call)), counts[name])
    cap.calls.clear()
    _print_pool("the short path's typical call", found["multiport_sram_step"][0],
                counts["multiport_sram_step"], PREVIOUS_MS["pool short"])
    counts, cap, split_tokens, long_spec = serve_long_context()
    paths["long ns 8"] = counts
    partial, combine, sweep = time_long_decode(*cap.typical("decode"))
    long_pair = time_decode(*cap.typical("decode"))
    long_chunk = time_chunk(*cap.typical("chunk"))
    # the pool's largest call, and its largest decode gather
    long_pool = time_pool(*cap.largest("pool", _lanes_on))
    gather = time_pool(*cap.largest("pool", _read_lanes_on))
    cap.calls.clear()
    print("\n".join(sweep))
    _print_pool("the long-context path's largest call", long_pool,
                counts["multiport_sram_step"], PREVIOUS_MS["pool long"])
    _print_pool("the long-context path's largest decode gather", gather,
                counts["multiport_sram_step"], None)
    print(f"kernel kv_chunk_append_attend on the long-context path's typical "
          f"call (x{counts['kv_chunk_append_attend']} on that path) "
          f"[{long_chunk['shape']}]: max_abs_err "
          f"{long_chunk['max_abs_err']:.3g}, kernel {long_chunk['ms']:.5f} ms, "
          f"plain {long_chunk['plain_ms']:.5f} ms, {long_chunk['library']} "
          f"{long_chunk['library_ms']:.5f} ms, bound "
          f"{long_chunk['bound_ms']:.6f} ms ({long_chunk['bound_by']})")
    found["kv_decode_split_partial"] = (partial,
                                        counts["kv_decode_split_partial"])
    found["kv_decode_split_combine"] = (combine,
                                        counts["kv_decode_split_combine"])

    counts, cap = serve_long_serial(split_tokens)
    paths["long ns 1"] = counts
    call = cap.typical("decode")
    cap.calls.clear()
    b1_long = time_decode(*call)
    c, clusters, fits = cluster_plan(*call)
    print(f"kernel kv_decode_append_attend on the long path's decode call at "
          f"--num-kv-splits 1 (x{counts['kv_decode_append_attend']} on that "
          f"path) [{b1_long['shape']}]: max_abs_err "
          f"{b1_long['max_abs_err']:.3g}, kernel {b1_long['ms']:.5f} ms "
          f"(previous design {PREVIOUS_MS['decode long']:.5f} ms), plain "
          f"{b1_long['plain_ms']:.5f} ms, {b1_long['library']} "
          f"{b1_long['library_ms']:.5f} ms, bound {b1_long['bound_ms']:.6f} ms "
          f"({b1_long['bound_by']}); one launch of {clusters} clusters of "
          f"{c} blocks; clusters the card holds at once, by size: {fits}")
    del call
    lap("3-5")

    counts, flash_errs, (q, k, v) = whole_prompt(dev)
    paths["whole prompt f32"] = counts
    errs["flash_attention"]["whole_prompt"] = flash_errs["f32"]
    errs["flash_attention"]["vs_model"] = flash_errs["vs_model"]
    errs["flash_attention_tc"]["f32_layers_cast"] = flash_errs["bf16"]
    found["flash_attention"] = (time_flash(q, k, v), counts["flash_attention"])
    f32_row = found["flash_attention"][0]
    print(f"kernel flash_attention (f32 route, design: scores in f32 FMA on "
          f"the CUDA cores, P V in 3xTF32 on the tensor cores, mma.sync "
          f"m16n8k8): largest |diff| to its plain version on the "
          f"{counts['flash_attention']} whole-prompt layers "
          f"{flash_errs['f32']:.3g} (limit {FLASH_TOL[torch.float32]}); "
          f"at q, k 3.5-4x N(0, 1) within the limit (check_flash); layer 0 "
          f"{f32_row['ms']:.5f} ms (first design {PREVIOUS_MS['flash f32']:.5f}"
          f" ms, both products in 3xTF32 {PREVIOUS_MS['flash f32 3xtf32']:.5f}"
          f" ms), bound {f32_row['bound_ms']:.6f} ms (scores at the CUDA "
          f"cores' 67 TFLOP/s), {f32_row['bound_cuda_cores_ms']:.6f} ms with "
          f"both products there")
    del q, k, v
    torch.cuda.empty_cache()
    counts, tc_errs, (q, k, v) = whole_prompt_bf16(dev)
    paths["whole prompt bf16"] = counts
    errs["flash_attention_tc"]["whole_prompt"] = tc_errs["bf16"]
    errs["flash_attention_tc"]["vs_model"] = tc_errs["vs_model"]
    found["flash_attention_tc"] = (time_flash(q, k, v),
                                   counts["flash_attention_tc"])
    del q, k, v
    torch.cuda.empty_cache()
    wide = time_flash(*head_dim_128(dev))
    torch.cuda.empty_cache()
    print(f"kernel flash_attention_tc at qwen2-vl-7b's heads (G = 7, "
          f"D = 128) [{wide['shape']}]: max_abs_err "
          f"{wide['max_abs_err']:.3g}, "
          f"kernel {wide['ms']:.5f} ms, plain {wide['plain_ms']:.5f} ms, "
          f"{wide['library']} {wide['library_ms']:.5f} ms, bound "
          f"{wide['bound_ms']:.6f} ms ({wide['bound_by']})")

    floor = _ms(lambda: K._build.launch_floor(dev))
    above = {what: found[name][0]["ms"] - floor for what, name in (
        ("B1 short", "kv_decode_append_attend"),
        ("B3 short", "multiport_sram_step"))}
    print(f"launch floor: an empty kernel through ctypes {floor:.5f} ms per "
          f"launch (the same timing); above it: "
          + ", ".join(f"{k} {v:.5f} ms" for k, v in above.items())
          + " (B4b is a programmatic dependent launch, not held against "
          "this floor: its cost on the path is on the split pair lines)")

    lap("6, 9")
    f32_tokens = fused_equals_reference()
    split_equals_serial()
    chaos_open_loop()
    lap("identities and chaos")

    torch.cuda.empty_cache()
    counts, cap = serve_moe()
    moe_errs = {"moe_bf16": moe_rows(counts, cap)}
    del cap
    moe_errs["moe_f32"] = moe_identity()
    for what, by_kernel in moe_errs.items():
        for name, e in by_kernel.items():
            errs[name][what] = e
    family_entry_points(dev)
    ssm_errs, family_ce = ssm_families(dev, card)
    for what, by_kernel in ssm_errs.items():
        for name, e in by_kernel.items():
            errs[name][what] = e
    lap("7a-7e, 7i")
    torch.cuda.empty_cache()
    paper_comparison(long_spec, dev, card)
    lap("7j")
    torch.cuda.empty_cache()
    mesh_paths, mesh_errs = kv_mesh_paths(
        dev, {"kv_decode_append_attend": found["kv_decode_append_attend"][0],
              "chunk short": found["kv_chunk_append_attend"][0],
              "multiport_sram_step": found["multiport_sram_step"][0],
              "split pair": long_pair, "chunk long": long_chunk,
              "gather": gather}, f32_tokens)
    paths.update(mesh_paths)
    for name, e in mesh_errs.items():
        errs[name]["kv_mesh"] = e
    lap("7k")
    torch.cuda.empty_cache()

    one_device = train_full_width(card)
    train_f32_identity(card)
    family_ce["deepseek-moe-16b"] = train_moe(card)
    torch.cuda.empty_cache()
    lap("7f-7h")
    sharded_training(card, one_device, family_ce, lap)

    rows = []
    for name, (src, replaces) in KERNELS.items():
        k, launches = found[name]
        k["max_abs_err"] = max([k["max_abs_err"], *errs[name].values()])
        lib = ("n/a" if k["library_ms"] is None
               else f"{k['library_ms']:.5f} ms")
        before = {"kv_decode_append_attend": "decode short",
                  "flash_attention": "flash f32"}.get(name)
        before = (f" (previous design {PREVIOUS_MS[before]:.5f} ms)"
                  if before else "")
        print(f"kernel {name} on its path's typical call [{k['shape']}]: "
              f"max_abs_err {k['max_abs_err']:.3g}, kernel {k['ms']:.5f} ms"
              f"{before}, plain {k['plain_ms']:.5f} ms, {k['library']} {lib}, "
              f"bound {k['bound_ms']:.6f} ms ({k['bound_by']})")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     **{f: k[f] for f in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
                     "launches_by_path": {
                         path: c[name] for path, c in paths.items()
                         if c.get(name)}})

    print("kernels: " + ", ".join(
        f"{r['name']} x{r['launches']} ("
        + ", ".join(f"{p} x{n}" for p, n in r["launches_by_path"].items())
        + ")" for r in rows))
    print(json.dumps({"kernels": rows}))
    lap("9-10")
    print(card)
    # the run used one device, whatever else the host shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
