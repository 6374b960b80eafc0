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
   bit-exact on a 4-port mix;
3. serve 4 requests x 8 new tokens of tinyllama-1.1b at full width (bf16,
   as published; random weights from a fixed seed) through
   ``repro_torch.launch.serve`` and check that the path went through the
   kernels: decode launches = 22 x decode cycles, chunk launches = 22 x
   prefill cycles, pool-step launches = pool traversals. The inputs of each
   kernel's most frequent call on that path are kept; on them the kernel is
   held against its plain version once more and timed (CUDA events over a
   queue of launches, median of batches) beside the plain version, the
   one-call PyTorch yardstick and the bound from bytes and operations;
4. check that greedy tokens are identical between the fused kernels and
   the two-pass reference at the same full width in f32 (TF32 off);
5. print the kernel table as JSON, the card's name and power limit, and
   finally ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "kv_decode_append_attend": ("src/repro_torch/csrc/kv_multiport.cu",
                                "src/repro/kernels/kv_multiport.py:92"),
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


def serve_full_width() -> tuple:
    from repro_torch.kernels import kv_multiport as kvmp
    from repro_torch.kernels import kv_prefill_chunk as kvpc
    from repro_torch.kernels import launch_counts, multiport_sram as mps
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import serve
    argv = ["--arch", "tinyllama-1.1b", "--no-reduced", "--device", "cuda",
            "--requests", "4", "--max-new", "8", "--seed", "0"]
    cap = MainPathCapture()
    cap.hook(kvmp, "fused_append_attend", "kv_decode_append_attend")
    cap.hook(kvpc, "fused_chunk_append_attend", "kv_chunk_append_attend")
    cap.hook(mps, "multiport_sram_step", "multiport_sram_step")
    try:
        reset_launch_counts()
        eng = serve.main(argv)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        cap.restore()
    L = eng.cfg.n_layers
    want = {"kv_decode_append_attend": L * eng.decode_steps,
            "kv_chunk_append_attend": L * eng.prefill_steps,
            "multiport_sram_step": eng.pool.traversals}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if min(want.values()) == 0:
        raise AssertionError(f"a kernel of the path never ran: {counts}")
    done = eng.finished
    if len(done) != 4 or any(len(r.generated) != 8 or
                             not all(0 <= t < eng.cfg.vocab
                                     for t in r.generated) for r in done):
        raise AssertionError("serve run did not produce 4 x 8 valid tokens")
    if eng.pool.utilization != 0.0 or float(eng.pool.storage.abs().max()):
        raise AssertionError("pool not drained and scrubbed after the run")
    print(f"serve: launch counters {counts} match {L} x {eng.decode_steps} "
          f"decode cycles, {L} x {eng.prefill_steps} prefill cycles, "
          f"{eng.pool.traversals} pool traversals")
    prompts = [r.prompt for r in sorted(done, key=lambda r: r.rid)]
    return counts, prompts, cap


def _sdpa(q, k, v, mask):
    """The one-call PyTorch yardstick: attention alone (no append)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def time_decode(args, kw) -> dict:
    from repro_torch.kernels import kv_multiport as kvmp
    q, ck, cv, nk, nv, ln = args
    b, s, hkv, d = ck.shape
    h = q.shape[1]
    tile, n = kvmp.launch_geometry(s, kw.get("seq_tile", 128),
                                   kw.get("live_len"),
                                   kw.get("dynamic_grid", False))
    err = _decode_agree(args, kw)
    ms = _ms(lambda: kvmp.fused_append_attend(*args, **kw))
    plain_ms = _ms(lambda: kvmp.fused_append_attend_plain(
        *args, seq_tile=tile, n_tiles=n,
        length_mask=kw.get("length_mask", True)))
    kpos = torch.arange(s, device=q.device)
    mask = (kpos[None] <= ln[:, None].long())[:, None, None, :]
    qf, kt, vt = q.float()[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2)
    lib_ms = _ms(lambda: _sdpa(qf, kt, vt, mask))
    live = [p for p in ln.tolist() if p >= 0]
    keys = sum(min(p + 1, n * tile, s) for p in live)
    new = sum(1 for p in live if p < min(n * tile, s))
    ce = ck.element_size()
    nbytes = (2 * q.numel() * q.element_size()         # q read, out written
              + 2 * (keys - new) * hkv * d * ce        # cached K,V read
              + 2 * new * hkv * d * (nk.element_size() + ce)  # new K,V in
              + 2 * 4 * b)                             # lens, tiles
    bound, by = _bound_ms(nbytes, 4 * h * d * keys)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention (attend only)",
            "shape": f"q {tuple(q.shape)} {q.dtype}, caches {tuple(ck.shape)}"
                     f" {ck.dtype}, lens {ln.tolist()}"}


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


def fused_equals_reference(prompts) -> None:
    from repro_torch.configs import registry
    from repro_torch.models import init_params
    from repro_torch.serve.engine import MultiPortEngine
    cfg = dataclasses.replace(registry.get("tinyllama-1.1b"),
                              param_dtype="float32", compute_dtype="float32")
    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    toks = {}
    for mode in ("pallas", "reference"):
        t0 = time.perf_counter()
        eng = MultiPortEngine(params, cfg, slots=4, max_slots=64, max_len=128,
                              chunk_tokens=16, seq_tile=64, kernel_mode=mode,
                              prefix_cache=True, device=dev)
        reqs = [eng.submit(p, max_new=8) for p in prompts]
        eng.run()
        toks[mode] = [r.generated for r in reqs]
        print(f"f32 full width, kernel_mode={mode}: {eng.cycles} cycles, "
              f"{eng.pool.traversals} pool traversals, "
              f"{time.perf_counter() - t0:.2f}s")
    if toks["pallas"] != toks["reference"]:
        raise AssertionError(f"fused and reference tokens differ: {toks}")
    print(f"f32 token identity fused == reference over "
          f"{sum(map(len, toks['pallas']))} greedy tokens")


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
    for name, e in errs.items():
        print(f"check {name}: agrees with its plain version {e}")

    counts, prompts, cap = serve_full_width()
    timers = {"kv_decode_append_attend": time_decode,
              "kv_chunk_append_attend": time_chunk,
              "multiport_sram_step": time_pool}
    rows = []
    for name, timer in timers.items():
        k = timer(*cap.typical(name))
        k["max_abs_err"] = max([k["max_abs_err"], *errs[name].values()])
        print(f"kernel {name} on the path's typical call [{k['shape']}]: "
              f"max_abs_err {k['max_abs_err']:.3g}, kernel {k['ms']:.5f} ms, "
              f"plain {k['plain_ms']:.5f} ms, {k['library']} "
              f"{k['library_ms']:.5f} ms, bound {k['bound_ms']:.6f} ms "
              f"({k['bound_by']})")
        src, rep = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": counts[name],
                     **{f: k[f] for f in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}})
    cap.calls.clear()
    fused_equals_reference(prompts)

    print("kernels: " + ", ".join(f"{r['name']} x{r['launches']}"
                                  for r in rows))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
