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
   bit-exact on a 4-port mix. The split-KV pair (stage 1 + stage 2) is held
   against its plain version at the long-context shapes (caches
   [4, 2048, 4, 64], seq_tile 64, num_kv_splits 2, 4, 8), and its caches
   and tile counts against the serial kernel's; num_kv_splits=1 launches
   the serial kernel only;
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
   serial kernel and the split pair at 2, 4 and 8 splits;
5. check that greedy tokens are identical between the fused kernels and
   the two-pass reference, and between split and serial decode on a
   long-prompt trace, at the same full width in f32 (TF32 off);
6. serve an open-loop Poisson schedule at full width in f32, fault-free
   and under the seeded chaos plan 23: every invariant audit clean, every
   request served or shed exactly once, survivors' tokens identical to the
   fault-free run;
7. print the kernel table as JSON, the card's name and power limit, and
   finally ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
F32_TOL, BF16_TOL = 1e-5, 4e-2
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
}


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


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _clones(args) -> tuple:
    return tuple(a.clone() if torch.is_tensor(a) else a for a in args)


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
    from repro_torch.kernels import multiport_sram as mps
    a, p = _clones(args), _clones(args)
    r_k = mps.multiport_sram_step(*a, **kw)
    r_p = mps.multiport_sram_step_plain(*p, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(a[0], p[0]) and torch.equal(r_k, r_p)):
        raise AssertionError(f"pool step differs from plain for {kw}")
    return 0.0


def check_decode(dev, gen) -> dict:
    hkv, g, d, s, tile = 4, 8, 64, 128, 64          # full tinyllama, defaults

    def case(lens, qdt, cdt=torch.float32):
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
    if errs["f32"] > F32_TOL or errs["bf16"] > BF16_TOL:
        raise AssertionError(f"decode kernel disagrees: {errs}")
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


def _combine_agree(acc, stats, dtype, hkv: int) -> float:
    """Stage 2 alone against its plain version on the same partials."""
    from repro_torch.kernels import kv_multiport as kvmp
    out = kvmp.split_combine(acc, stats, dtype, hkv)
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
                                  _combine_agree(acc, st, torch.float32, hkv))
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
    from repro_torch.core.ports import READ, WRITE
    words, width = 8192, 22 * 2 * 4 * 64            # full tinyllama pool
    storage = torch.randn((words, width), generator=gen, device=dev)

    def ports(roles, q, lanes_on):
        p = len(roles)
        addr = torch.randint(0, words, (p, q), generator=gen, device=dev,
                             dtype=torch.int32)
        addr[1:, : q // 2] = addr[0, : q // 2]      # later ports hit port 0's
        mask = torch.zeros((p, q), dtype=torch.bool, device=dev)
        mask[:, :lanes_on] = True
        for s, r in enumerate(roles):               # dedup write lanes
            if r == WRITE:
                a = addr[s].tolist()
                last = {w: i for i, w in enumerate(a)}
                mask[s] &= torch.tensor([last[w] == i for i, w in enumerate(a)],
                                        device=dev)
        data = torch.randn((p, q, width), generator=gen, device=dev)
        return storage, addr, data, mask

    for roles, q, on in (((WRITE, READ, WRITE, READ), 64, 48),  # 4-port mix
                         ((WRITE, WRITE, READ), 128, 128),       # 2W+1R, WAW
                         ((READ,), 16, 9)):
        _pool_agree(ports(roles, q, on), dict(roles=roles))
    return {"exact": 0.0}


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
            key = (tuple(tuple(a.shape) if torch.is_tensor(a) else a
                         for a in args), tuple(sorted(kw.items())))
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


def serve_path(argv: list) -> tuple:
    """Drive one serving path through the launcher with every launch count
    set to 0 just before it and read just after it. Returns (engine,
    chaos harness or None, launch counts, the captured kernel calls)."""
    from repro_torch.kernels import kv_multiport as kvmp
    from repro_torch.kernels import kv_prefill_chunk as kvpc
    from repro_torch.kernels import launch_counts, multiport_sram as mps
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import serve
    cap = MainPathCapture()
    cap.hook(kvmp, "fused_append_attend", "decode")
    cap.hook(kvpc, "fused_chunk_append_attend", "chunk")
    cap.hook(mps, "multiport_sram_step", "pool")
    try:
        reset_launch_counts()
        eng, harness = serve.run(serve.parse_args(argv))
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        cap.restore()
    return eng, harness, counts, cap


def expect_launches(eng, counts: dict) -> None:
    """The path went through its kernels: one decode launch (the serial
    kernel, or the split pair) per layer per decode cycle, one chunk
    launch per layer per prefill cycle, one pool step per traversal."""
    L = eng.cfg.n_layers
    dec = L * eng.decode_steps
    split = eng.num_kv_splits > 1
    want = {"kv_decode_append_attend": 0 if split else dec,
            "kv_decode_split_partial": dec if split else 0,
            "kv_decode_split_combine": dec if split else 0,
            "kv_chunk_append_attend": L * eng.prefill_steps,
            "multiport_sram_step": eng.pool.traversals}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if not (dec and eng.prefill_steps and eng.pool.traversals):
        raise AssertionError(f"a kernel of the path never ran: {counts}")
    print(f"serve: launch counters {counts} match {L} x {eng.decode_steps} "
          f"decode cycles, {L} x {eng.prefill_steps} prefill cycles, "
          f"{eng.pool.traversals} pool traversals")


def expect_served(eng, n: int, max_new: int) -> None:
    done = eng.finished
    if len(done) != n or any(len(r.generated) != max_new or
                             not all(0 <= t < eng.cfg.vocab
                                     for t in r.generated) for r in done):
        raise AssertionError(f"serve run did not produce {n} x {max_new} "
                             f"valid tokens")
    if eng.pool.utilization != 0.0 or float(eng.pool.storage.abs().max()):
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


def serve_long_context() -> tuple:
    path = ROOT / "build" / "chip_smoke" / "long_2k.jsonl"
    write_long_trace(path, 1500, 2001, seed=0)
    eng, _, counts, cap = serve_path(FULL + LONG + [
        "--num-kv-splits", "8", "--trace", str(path)])
    expect_launches(eng, counts)
    expect_served(eng, 4, 8)
    return counts, cap


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
    qf, kt, vt = q.float()[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2)
    return _ms(lambda: _sdpa(qf, kt, vt, mask))


def time_decode(args, kw) -> dict:
    from repro_torch.kernels import kv_multiport as kvmp
    q, ck, ln = args[0], args[1], args[5]
    s, d = ck.shape[1], ck.shape[3]
    h = q.shape[1]
    tile, n = kvmp.launch_geometry(s, kw.get("seq_tile", 128),
                                   kw.get("live_len"),
                                   kw.get("dynamic_grid", False))
    err = _decode_agree(args, kw)
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


def time_long_decode(args, kw) -> tuple:
    """The serial kernel and the split pair at 2, 4 and 8 splits on the
    long-context path's decode call, and the path's own split count stage
    by stage. Returns (partial row, combine row, sweep line)."""
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
    pair_ms = {k: _ms(lambda k=k: kvmp.fused_append_attend(
        *args, num_kv_splits=k, **base)) for k in SPLITS}
    skw = dict(seq_tile=tile, n_tiles=n,
               length_mask=base.get("length_mask", True), num_kv_splits=ns)
    partial_ms = _ms(lambda: kvmp.split_partials(*args, **skw))
    partial_plain_ms = _ms(lambda: kvmp.split_partials_plain(*args, **skw))
    acc, st, _ = kvmp.split_partials(*_clones(args), **skw)
    err_combine = _combine_agree(acc, st, q.dtype, hkv)
    combine_ms = _ms(lambda: kvmp.split_combine(acc, st, q.dtype, hkv))
    combine_plain_ms = _ms(lambda: kvmp.split_combine_plain(acc, st, q.dtype))
    lib_ms = _decode_library_ms(args)
    part_bytes = b * ns * h * (d + 2) * 4
    out_bytes = q.numel() * q.element_size()
    serial_bound, _ = _bound_ms(nbytes, flops)
    p_bound, p_by = _bound_ms(nbytes - out_bytes + part_bytes, flops)
    c_bound, c_by = _bound_ms(part_bytes + out_bytes, 6 * b * ns * h * d)
    shape = (f"q {tuple(q.shape)} {q.dtype}, caches {tuple(ck.shape)} "
             f"{ck.dtype}, lens {ln.tolist()}, {ns} splits")
    sweep = (f"long-context decode [{shape}]: serial kernel {serial_ms:.5f} "
             f"ms (bound {serial_bound:.6f} ms, bytes); split pair "
             + ", ".join(f"ns={k} {v:.5f} ms" for k, v in pair_ms.items())
             + f"; SDPA (attend only) {lib_ms:.5f} ms")
    partial = {"max_abs_err": err_pair, "ms": partial_ms,
               "plain_ms": partial_plain_ms, "bound_ms": p_bound,
               "bound_by": p_by, "library_ms": lib_ms,
               "library": "scaled_dot_product_attention (attend only)",
               "shape": shape}
    combine = {"max_abs_err": err_combine, "ms": combine_ms,
               "plain_ms": combine_plain_ms, "bound_ms": c_bound,
               "bound_by": c_by, "library_ms": None,
               "library": "no single PyTorch call", "shape": shape}
    return partial, combine, sweep


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
    idx = addr[0][mask[0]].long()
    if roles[0] == WRITE:
        rows = data[0][mask[0]]
        lib_ms = _ms(lambda: st.index_copy_(0, idx, rows))
        lib = "index_copy_ (the first port alone)"
    else:
        lib_ms = _ms(lambda: st.index_select(0, idx))
        lib = "index_select (the first port alone)"
    on = mask.sum(dim=1).tolist()
    el, width = storage.element_size(), storage.shape[1]
    moved = sum(n * (2 if r == WRITE else 1) for n, r in zip(on, roles))
    nbytes = (moved * width * el             # payload in + words out; reads
              + data.numel() * el            # the [P, Q, W] read output
              + addr.numel() * 4 + mask.numel())
    bound, by = _bound_ms(nbytes, 0.0)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library": lib,
            "shape": f"storage {tuple(storage.shape)} {storage.dtype}, ports "
                     f"{roles} (0=R, 1=W), Q {addr.shape[1]}, lanes on {on}"}


F32 = FULL + ["--dtype", "float32"]


def fused_equals_reference() -> None:
    """The short path's requests in f32: fused kernels == two-pass
    reference."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    took = K.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s "
          f"(nvcc per source: { {k: round(v, 1) for k, v in took.items()} })")
    for log in sorted(K._build.BUILD_DIR.glob("*.ptxas.txt")):
        for line in sorted(set(log.read_text().splitlines())):
            if "registers" in line or "spill" in line:
                print(f"  ptxas {log.stem}: {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"kv_decode_append_attend": check_decode(dev, gen),
            "kv_chunk_append_attend": check_chunk(dev, gen),
            "multiport_sram_step": check_pool_step(dev, gen)}
    split_errs = check_split(dev, gen)
    errs["kv_decode_split_partial"] = {k: v for k, v in split_errs.items()
                                       if k != "combine"}
    errs["kv_decode_split_combine"] = {"combine": split_errs["combine"]}
    for name, e in errs.items():
        print(f"check {name}: agrees with its plain version {e}")

    found = {}      # kernel name -> (timing row, launches on its path)
    counts, cap = serve_full_width()
    for name, timer, call in (("kv_decode_append_attend", time_decode,
                               "decode"),
                              ("kv_chunk_append_attend", time_chunk, "chunk"),
                              ("multiport_sram_step", time_pool, "pool")):
        found[name] = (timer(*cap.typical(call)), counts[name])
    cap.calls.clear()
    counts, cap = serve_long_context()
    partial, combine, sweep = time_long_decode(*cap.typical("decode"))
    cap.calls.clear()
    print(sweep)
    found["kv_decode_split_partial"] = (partial,
                                        counts["kv_decode_split_partial"])
    found["kv_decode_split_combine"] = (combine,
                                        counts["kv_decode_split_combine"])

    rows = []
    for name, (src, replaces) in KERNELS.items():
        k, launches = found[name]
        k["max_abs_err"] = max([k["max_abs_err"], *errs[name].values()])
        lib = ("n/a" if k["library_ms"] is None
               else f"{k['library_ms']:.5f} ms")
        print(f"kernel {name} on its path's typical call [{k['shape']}]: "
              f"max_abs_err {k['max_abs_err']:.3g}, kernel {k['ms']:.5f} ms, "
              f"plain {k['plain_ms']:.5f} ms, {k['library']} {lib}, bound "
              f"{k['bound_ms']:.6f} ms ({k['bound_by']})")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     **{f: k[f] for f in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}})

    fused_equals_reference()
    split_equals_serial()
    chaos_open_loop()

    print("kernels: " + ", ".join(f"{r['name']} x{r['launches']}"
                                  for r in rows))
    print(json.dumps({"kernels": rows}))
    print(card)
    # the run used one device, whatever else the host shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
