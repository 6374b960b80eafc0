"""Spans and counters taken from the benchmark's side, and the reduction of
a ``torch.profiler`` trace to what the per-layer metrics read.

``Spans`` wraps ``torch.profiler.record_function`` around the calls into
each layer of the serving program (the engine's macro-cycle, the pool's
traversal, the model's decode step and prefill chunk) by
replacing the names the program calls through, and restores them on
``close``. While ``recording`` it also keeps what each call was asked to
do, read from its arguments on the host: the words each pool traversal
writes and reads, and each prefill chunk's rows. A prefill chunk's
offsets are read back from the card; the engine waits on that chunk's
results right after the call anyway.
"""
from __future__ import annotations

import bisect
import re

import torch

STEP, POOL, DECODE, PREFILL = ("engine.step", "pool.cycle",
                               "model.decode_step", "model.prefill_chunk")
TRAFFIC, WINDOW = "harness.traffic", "harness.window"
SPAN_NAMES = (STEP, POOL, DECODE, PREFILL, TRAFFIC, WINDOW)
# the port's hand-written kernels, by the name of their __global__ function
KERNELS = {"B1": r"\bdecode_kernel\b", "B2": r"\bchunk_kernel\b",
           "B3": r"\bmultiport_sram_kernel\b", "B4a": r"\bsplit_kernel\b",
           "B4b": r"\bcombine_kernel\b"}
SHORT_GAP_US = 20.0


def _ranged(name, fn):
    def wrapped(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapped


class Spans:
    """The benchmark's spans around one engine's layers."""

    def __init__(self, eng):
        from repro_torch.serve import engine as engine_mod
        self.recording = False
        self.pool_lanes: list = []          # (words written, words read)
        self.prefill_rows: list = []        # (offset, tokens) per live row
        self._undo = []

        def patch(owner, attr, new):
            self._undo.append((owner, attr, getattr(owner, attr),
                               attr in vars(owner)))
            setattr(owner, attr, new)

        patch(eng, "step", _ranged(STEP, eng.step))
        cycle = eng.pool.cycle

        def pool_cycle(**streams):
            if self.recording:
                self.pool_lanes.append(_lanes(streams, eng.pool.page_tokens))
            with torch.profiler.record_function(POOL):
                return cycle(**streams)
        patch(eng.pool, "cycle", pool_cycle)
        patch(engine_mod, "decode_step",
              _ranged(DECODE, engine_mod.decode_step))
        chunk = engine_mod.prefill_chunk

        def prefill_chunk(params, cfg, state, batch, **kw):
            if self.recording:
                offs = state["len"].tolist()
                lens = batch["chunk_len"].tolist()
                self.prefill_rows += [(o, n) for o, n in zip(offs, lens)
                                      if n > 0]
            with torch.profiler.record_function(PREFILL):
                return chunk(params, cfg, state, batch, **kw)
        patch(engine_mod, "prefill_chunk", prefill_chunk)

    def close(self) -> None:
        for owner, attr, old, own in reversed(self._undo):
            if own:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._undo = []


def _lanes(streams: dict, page_tokens: int) -> tuple:
    def rows(s):
        if s is None:
            return []
        return [s] if isinstance(s, dict) else list(s)
    w = sum(int(s["vectors"].shape[0]) for k in ("append", "prefill")
            for s in rows(streams.get(k)))
    w += len(streams.get("scrub") or ()) * page_tokens
    r = sum(len(s["positions"]) for s in rows(streams.get("read")))
    return w, r


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_ms(e) -> float:
    if hasattr(e, "device_time_total"):
        return e.device_time_total
    return e.cuda_time_total


def reduce(prof) -> dict:
    """What the metrics read from a finished profile: device busy seconds
    (the union of every kernel, copy and set on the card, within the
    ``WINDOW`` span), seconds by device operation, the device seconds and
    calls under each span, and idle seconds by the span the host was in
    (innermost) at each gap."""
    from torch.autograd import DeviceType
    events = prof.events()
    dev, spans = [], []
    span_dev, span_calls = {}, {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if e.name in SPAN_NAMES:       # a span's own device annotation
                continue
            dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name in SPAN_NAMES:
            spans.append((e.time_range.start, e.time_range.end, e.name))
            span_dev[e.name] = span_dev.get(e.name, 0.0) + _device_ms(e)
            span_calls[e.name] = span_calls.get(e.name, 0) + 1
    dev.sort()
    spans.sort()
    win = [(a, b) for a, b, n in spans if n == WINDOW]
    if win:
        lo, hi = win[0]
        dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev
               if b > lo and a < hi]
    by_op: dict = {}
    for a, b, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    busy, gaps = 0.0, []
    cur_a = cur_b = None
    for a, b, _ in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    starts = [s[0] for s in spans]
    idle: dict = {}
    for a, b in gaps:
        if b - a < SHORT_GAP_US:
            key = f"gaps under {SHORT_GAP_US:g} us"
        else:
            key = _innermost(spans, starts, (a + b) / 2) or "outside spans"
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
    return {"busy_s": busy / 1e6, "device_ops": by_op,
            "span_device_s": {k: v / 1e6 for k, v in span_dev.items()},
            "span_calls": span_calls, "idle_by_span": idle,
            "device_events": len(dev)}


def _innermost(spans: list, starts: list, t: float, look: int = 400):
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - look), -1):
        a, b, name = spans[j]
        if a <= t <= b:
            return name
    return None


def kernel_s(trace: dict, *keys: str) -> float:
    """Device seconds of the port's kernels named (``KERNELS``), summed."""
    pat = re.compile("|".join(KERNELS[k] for k in keys))
    return sum(s for n, s in trace["device_ops"].items() if pat.search(n))


def memcpy_s(trace: dict) -> float:
    """Device seconds of host<->device copies."""
    return sum(s for n, s in trace["device_ops"].items()
               if n.startswith("Memcpy") and ("HtoD" in n or "DtoH" in n))


def breakdown(trace: dict) -> dict:
    top = sorted(trace["device_ops"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(trace["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}
