"""The serving driver: set-up, the measured window, and the check of what
the window served, for every cell whose workload names ``"driver":
"serve"``.

The window drives ``repro_torch.serve.engine.MultiPortEngine`` through its
client calls (``submit``, ``step``, ``flush``) and times every request on
the host's clock from its due time, at step boundaries: a token counts as
served at the end of the step after which the engine holds it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from portbench import tracing, weights
from portbench.reference import compare
from portbench.reference import model as ref_model
from portbench.traffic import generator as tg

STREAM_SAMPLE = 3                 # the seed's draw of the checked requests
# a traced run measures the first TRACE_SECONDS of its window, and at least
# TRACE_CYCLES macro-cycles: the profiler's records of a whole window take
# longer to read than a run may last
TRACE_SECONDS, TRACE_CYCLES = 15.0, 3
# the numbers a workload's check can compare (``compare.readings``)
NUMBERS = {"max_logit_gap": "widest", "mean_logit_gap": "mean"}


def arch_config(cfg: dict):
    """The program's ``ArchConfig`` of a dense decoder's configuration
    file."""
    from repro_torch.configs.base import ArchConfig
    if "n_routed_experts" in cfg:
        raise ValueError(f"{cfg['name']}: the serving driver and the "
                         "reference hold dense decoders only")
    return ArchConfig(
        arch_id=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], qkv_bias=cfg["qkv_bias"],
        head_dim=cfg.get("head_dim"), rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"],
        param_dtype=cfg["torch_dtype"], compute_dtype=cfg["torch_dtype"])


@dataclasses.dataclass
class Rec:
    """One request as the harness saw it (host clock, seconds)."""
    req: object
    due: float
    tokens: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Run:
    """What the metrics' readers read."""
    cfg: dict
    workload: dict
    mix: dict
    setup_s: float = 0.0
    build_s: float = 0.0
    t0: float = 0.0
    t_end: float = 0.0
    recs: list = dataclasses.field(default_factory=list)
    counters0: dict = dataclasses.field(default_factory=dict)
    counters1: dict = dataclasses.field(default_factory=dict)
    decode_lens: list = dataclasses.field(default_factory=list)
    pool_lanes: list = dataclasses.field(default_factory=list)
    prefill_rows: list = dataclasses.field(default_factory=list)
    word_width: int = 0
    trace: Optional[dict] = None
    memory_peak_bytes: int = 0
    sample: tuple = ((), (), ())   # the checked requests' sequences
    readings: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    correct: bool = False

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    def in_window(self, t: float) -> bool:
        return self.t0 < t <= self.t_end

    def itl_gaps(self) -> list:
        """Every gap between consecutive tokens of a request, both served
        in the window."""
        return [b - a for r in self.recs for a, b in zip(r.tokens,
                                                          r.tokens[1:])
                if self.in_window(a) and self.in_window(b)]

    def attempted(self) -> list:
        """Requests sent in the window and those live at its start."""
        return [r for r in self.recs if r.due <= self.t_end
                and not (r.req.done and r.tokens[-1] <= self.t0)]


def _counters(eng) -> dict:
    return {"cycles": eng.cycles, "steady_steps": eng.steady_decode_steps,
            "steady_traversals": eng.steady_decode_traversals}


class _Loop:
    """The engine, the live requests, and their stamps."""

    def __init__(self, eng, run: Run, spans):
        self.eng, self.run, self.spans = eng, run, spans
        self.live: list = []

    def submit(self, spec: tg.Spec, due: float) -> Rec:
        req = self.eng.submit(spec.prompt, max_new=spec.max_new)
        rec = Rec(req, due)
        self.run.recs.append(rec)
        if req.shed_reason is None:
            self.live.append(rec)
        return rec

    def step(self) -> list:
        """One macro-cycle; returns the requests that finished in it."""
        self.eng.step()
        now = time.perf_counter()
        inf = self.eng._inflight
        if (self.spans is not None and self.spans.recording
                and inf is not None and inf.cycle == self.eng.cycles - 1):
            self.run.decode_lens.append(inf.lens[inf.lens >= 0].tolist())
        done, keep = [], []
        for rec in self.live:
            req = rec.req
            rec.tokens += [now] * (len(req.generated) - len(rec.tokens))
            (done if req.done else keep).append(rec)
        self.live = keep
        return done


def run_cell(cfg: dict, workload: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> Run:
    """Set up, measure ``seconds`` of the cell's traffic, check the served
    tokens against the reference, and return what the readers read."""
    from repro_torch.serve.engine import MultiPortEngine
    run = Run(cfg, workload, mix)
    if (tg.Traffic(mix, seed, cfg["vocab_size"]).longest()
            > workload["engine"]["max_len"]):
        raise ValueError("the mix's longest request exceeds max_len")
    if device.type == "cuda":
        from repro_torch.kernels import build
        t = time.perf_counter()
        build()                       # every kernel, compiled at once if new
        run.build_s = time.perf_counter() - t
    params = weights.make(cfg, seed, device)
    eng = MultiPortEngine(params, arch_config(cfg), device=device,
                          **workload["engine"])
    run.word_width = int(np.prod(eng._kv_dims))
    spans = tracing.Spans(eng) if trace else None
    loop = _Loop(eng, run, spans)
    traffic = tg.Traffic(mix, seed, cfg["vocab_size"])
    _warm(loop, traffic, workload)
    _sync(device)
    with (tracing.profiler() if trace else contextlib.nullcontext()) as prof:
        if trace:
            spans.recording = True
        run.counters0 = _counters(eng)
        run.t0 = time.perf_counter()
        run.setup_s = run.t0 - t_start
        if trace:
            stop = _Stop(run.t0 + min(seconds, TRACE_SECONDS), eng,
                         TRACE_CYCLES, run.t0 + seconds)
        else:
            stop = _Stop(run.t0 + seconds, eng)
        with torch.profiler.record_function(tracing.WINDOW):
            _window(loop, traffic, stop)
            run.t_end = time.perf_counter()
            run.counters1 = _counters(eng)
            if trace:
                _sync(device)
    if trace:
        spans.recording = False
        run.trace = tracing.reduce(prof)
        run.pool_lanes, run.prefill_rows = spans.pool_lanes, spans.prefill_rows
        del prof
        spans.close()
    eng.flush()
    _sync(device)
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    run.sample = served_positions(
        _sample(run, workload["correct"]["requests"], seed))
    del eng, params, loop, spans
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.readings = _check(cfg, seed, run.sample, device)
    number, limit = workload["correct"]["number"], workload["correct"]["limit"]
    value = run.readings[NUMBERS[number]]
    run.checks = {number: {"value": value, "limit": limit}}
    run.correct = value <= limit
    return run


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm(loop: _Loop, traffic: tg.Traffic, workload: dict) -> None:
    """Every client's first request submitted and prefilled, then
    ``warmup_steps`` steps of the closed loop: two fill both of the
    engine's alternating staging buffers and run the decode shapes."""
    clients = [loop.submit(spec, time.perf_counter())
               for spec in traffic.firsts()]
    while not all(r.tokens for r in clients):
        _resubmit(loop, traffic, loop.step())
    for _ in range(workload["warmup_steps"]):
        _resubmit(loop, traffic, loop.step())


def _resubmit(loop: _Loop, traffic: tg.Traffic, done: list) -> None:
    for _ in done:
        loop.submit(traffic.next(), time.perf_counter())


class _Stop:
    """When a window ends: at ``t_stop``, but not before ``cycles``
    macro-cycles have run in it, unless ``t_last`` has passed."""

    def __init__(self, t_stop: float, eng, cycles: int = 0,
                 t_last: Optional[float] = None):
        self.t_stop, self.eng, self.t_last = t_stop, eng, t_last or t_stop
        self.until = eng.cycles + cycles

    def __call__(self, now: float) -> bool:
        if now >= self.t_last:
            return True
        return now >= self.t_stop and self.eng.cycles >= self.until


def _window(loop: _Loop, traffic: tg.Traffic, stop: _Stop) -> None:
    while not stop(time.perf_counter()):
        done = loop.step()
        with torch.profiler.record_function(tracing.TRAFFIC):
            _resubmit(loop, traffic, done)


def _sample(run: Run, n: int, seed: int) -> list:
    """The requests checked: the one with the most served tokens, and the
    rest drawn from the seed among every request that served a token."""
    served = [r.req for r in run.recs if r.req.generated]
    if not served:
        return []
    longest = max(served, key=lambda q: len(q.generated))
    rest = [q for q in served if q is not longest]
    rng = np.random.default_rng([seed, STREAM_SAMPLE])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def _check(cfg: dict, seed: int, sample: tuple, device) -> dict:
    """The served tokens' gaps below the reference's best logit over the
    sampled requests (``compare.readings``); inf when nothing was served."""
    seqs, pos, toks = sample
    if not seqs:
        return {k: float("inf") for k in ("widest", "mean", "not_first")}
    ref = ref_model.logits(cfg, seed, seqs, pos, device)
    return compare.readings(ref, toks)


def served_positions(sample: list) -> tuple:
    """(sequences, positions, served tokens): each request's prompt and
    served tokens as one sequence, and the positions whose logits produced
    each served token."""
    seqs, pos, toks = [], [], []
    for q in sample:
        p, g = len(q.prompt), list(q.generated)
        seqs.append(list(q.prompt) + g[:-1])
        pos.append(list(range(p - 1, p - 1 + len(g))))
        toks.append(g)
    return seqs, pos, toks
