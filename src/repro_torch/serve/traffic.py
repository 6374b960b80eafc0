"""Open-loop traffic generation: seeded arrival processes with heavy-tailed
prompt/output lengths drawn over the config registry's scenario spread.

Every bench before this one was CLOSED-loop: all requests submitted up
front, the engine drained at its own pace, and the gates were ratio-shaped
(traversals, tiles, traces). The paper's pitch — bandwidth for
multi-connected devices under real traffic — only cashes out if the
configurable port mix holds tail latency when arrivals are bursty and
lengths are heavy-tailed, the regime the flexible multi-port memory
controller literature (arXiv 1712.03477) evaluates with open-loop request
streams. This module provides that stream:

* :func:`poisson_arrivals` — a seeded Poisson process (exponential
  inter-arrivals at ``rate`` requests per VIRTUAL TICK — see below) whose
  per-request prompt/output lengths are bounded-Pareto heavy-tailed
  (``alpha`` ~ 1.2: most requests short, a fat tail of long ones), scaled
  per request by a scenario drawn from the registry spread.
* :func:`trace_arrivals` / :func:`write_trace` — JSONL trace replay (and
  its inverse), so measured or hand-built schedules rerun bit-identically.
* :func:`scenario_spread` — one scenario per registry architecture, its
  length scale derived deterministically from the arch's reduced geometry
  (layers x heads x head_dim as a proxy for the context its deployments
  carry). The engine under test serves ONE architecture's weights, so
  scenarios modulate LENGTHS (and tag the request), not token ids.

**Shared-prefix pools.** Real traffic is not i.i.d. tokens:
requests reusing one deployment share its system prompt / few-shot
header, which is exactly what the pool's refcounted prefix cache
exploits. A :class:`Scenario` can therefore carry a CONTENT pool —
``shared_prefixes`` distinct headers of ``prefix_tokens`` tokens each —
and every request drawn under that scenario has its prompt's head
replaced by one of those headers (at least one trailing token always
stays request-private, so prompts never fully collide). The headers come
from a PER-SCENARIO rng seeded by ``(seed, crc32(name))`` — ``crc32``
because ``hash(str)`` is randomized per process — so the MAIN rng stream
is consumed identically with pools on or off: lengths, arrival ticks and
body tokens of every other scenario are bit-identical, and the default
(pool-less) spread reproduces the length-only schedules exactly. Prompts
serialize whole, so traces round-trip with no special casing.

**The clock is virtual.** Arrival times are in POOL-TRAVERSAL ticks — the
engine's hardware time unit (one tick = one physical pool traversal; an
idle macro-cycle costs one tick). Scheduling arrivals in ticks is what
makes the harness genuinely open-loop: the arrival process does not slow
down because the server got slower, so a scheduler that spends more
traversals per macro-cycle (``schedule_mode="static"``) faces the same
tick schedule with less capacity and its queues — and tail latency — grow.
Determinism on CI falls out: same seed, same schedule, same percentiles;
wall-clock timing is recorded alongside but never gates.

Same seed => identical arrival schedule, bit-for-bit — and the same
schedule as the JAX package's generator, whose numpy streams this module
consumes in the same order (``tests/test_torch_traffic.py`` pins it).
"""
from __future__ import annotations

import dataclasses
import json
import time
import zlib
from collections import deque
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import registry


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop request: arrival time in virtual ticks + its payload."""

    arrival_tick: int
    prompt: tuple                  # token ids
    max_new: int
    scenario: str = ""

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A traffic profile: length scale factors applied to the base
    heavy-tailed prompt/output draws, tagged with the registry arch that
    induced it — plus an optional shared-header content pool
    (``shared_prefixes`` headers x ``prefix_tokens`` tokens) modelling
    the deployment's common system prompt / few-shot preamble."""

    name: str
    prompt_scale: float
    output_scale: float
    shared_prefixes: int = 0       # pool size; 0 = length-only scenario
    prefix_tokens: int = 0         # header length in tokens

    def __post_init__(self):
        if self.shared_prefixes < 0 or self.prefix_tokens < 0:
            raise ValueError(f"negative prefix pool geometry: {self}")
        if bool(self.shared_prefixes) != bool(self.prefix_tokens):
            raise ValueError(
                "shared_prefixes and prefix_tokens must be both zero or "
                f"both positive, got {self.shared_prefixes}/"
                f"{self.prefix_tokens}")


def scenario_spread(arch_ids: Optional[Sequence[str]] = None, *,
                    shared_prefixes: int = 0, prefix_tokens: int = 0
                    ) -> tuple[Scenario, ...]:
    """One scenario per registry architecture, length scales spread over
    [0.5x, 2.0x] by the arch's reduced attention geometry (layers x heads x
    head_dim — a deterministic, config-derived proxy for how long that
    arch's deployments run). The spread is what keeps the traffic mix from
    collapsing to one effective length distribution. ``shared_prefixes``/
    ``prefix_tokens`` give EVERY scenario in the spread its own header
    pool of that geometry (the headers themselves still differ per
    scenario — each pool is seeded off the scenario name); the zero
    default keeps the spread length-only."""
    ids = tuple(arch_ids) if arch_ids is not None else registry.ARCH_IDS
    sizes = {}
    for a in ids:
        cfg = registry.get(a, reduced=True)
        hd = cfg.head_dim or cfg.d_model // cfg.n_heads
        sizes[a] = cfg.n_layers * cfg.n_heads * hd
    lo, hi = min(sizes.values()), max(sizes.values())
    span = max(hi - lo, 1)

    def _scale(v: int) -> float:
        return 0.5 * 4.0 ** ((v - lo) / span)          # 0.5 .. 2.0

    return tuple(
        Scenario(name=a, prompt_scale=_scale(sizes[a]),
                 # outputs skew shorter than prompts but keep the spread
                 output_scale=0.5 + 0.5 * _scale(sizes[a]),
                 shared_prefixes=shared_prefixes,
                 prefix_tokens=prefix_tokens)
        for a in ids)


def _bounded_pareto(rng: np.random.Generator, alpha: float, lo: float,
                    hi: float, size: int) -> np.ndarray:
    """Bounded Pareto(alpha) on [lo, hi] via inverse-CDF — heavy-tailed
    (most mass near ``lo``, a fat tail toward ``hi``) yet hard-bounded so
    every draw fits the engine's ``max_len`` budget."""
    u = rng.random(size)
    ratio = (lo / hi) ** alpha
    return lo / (1.0 - u * (1.0 - ratio)) ** (1.0 / alpha)


def poisson_arrivals(n_requests: int, rate: float, *, seed: int, vocab: int,
                     max_prompt: int, max_output: int, min_prompt: int = 2,
                     min_output: int = 1, alpha: float = 1.2,
                     scenarios: Optional[Sequence[Scenario]] = None
                     ) -> tuple[Arrival, ...]:
    """A seeded open-loop schedule: ``n_requests`` Poisson arrivals at
    ``rate`` requests per virtual tick, each with bounded-Pareto prompt and
    output lengths scaled by a per-request scenario drawn uniformly from
    ``scenarios`` (default: the full registry spread). Deterministic in
    ``seed``; token ids uniform over ``vocab``.

    Scenarios carrying a shared-prefix pool overlay one of their headers
    onto each request's prompt head (the body keeps the request-private
    draw, and at least the final token always stays private). Headers and
    header picks come from per-scenario rngs seeded ``(seed,
    crc32(name))`` so the main stream is consumed identically whether any
    scenario has a pool or not — ticks, lengths, scenario assignment and
    body tokens never move when pools are switched on."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if not min_prompt <= max_prompt:
        raise ValueError(f"bad prompt bounds [{min_prompt}, {max_prompt}]")
    if not min_output <= max_output:
        raise ValueError(f"bad output bounds [{min_output}, {max_output}]")
    scen = tuple(scenarios) if scenarios is not None else scenario_spread()
    rng = np.random.default_rng(seed)
    headers: dict = {}      # scenario index -> (header tuples, pick rng)
    for j, s in enumerate(scen):
        if s.shared_prefixes:
            hrng = np.random.default_rng(
                [seed, zlib.crc32(s.name.encode())])
            headers[j] = (tuple(
                tuple(int(t) for t in rng_row)
                for rng_row in hrng.integers(
                    0, vocab, (s.shared_prefixes, s.prefix_tokens))), hrng)
    gaps = rng.exponential(1.0 / rate, n_requests)
    ticks = np.floor(np.cumsum(gaps)).astype(np.int64)
    plen = _bounded_pareto(rng, alpha, min_prompt, max_prompt, n_requests)
    olen = _bounded_pareto(rng, alpha, min_output, max_output, n_requests)
    which = rng.integers(0, len(scen), n_requests)
    out = []
    for i in range(n_requests):
        s = scen[which[i]]
        p = int(np.clip(round(plen[i] * s.prompt_scale),
                        min_prompt, max_prompt))
        o = int(np.clip(round(olen[i] * s.output_scale),
                        min_output, max_output))
        prompt = tuple(int(t) for t in rng.integers(0, vocab, p))
        if which[i] in headers:
            pool, hrng = headers[which[i]]
            head = pool[int(hrng.integers(0, len(pool)))]
            k = min(len(head), p - 1)   # last token stays request-private
            if k > 0:
                prompt = head[:k] + prompt[k:]
        out.append(Arrival(arrival_tick=int(ticks[i]), prompt=prompt,
                           max_new=o, scenario=s.name))
    return tuple(out)


@dataclasses.dataclass
class DriveResult:
    """What one open-loop run did: the per-cycle ready-queue-depth samples
    and wall seconds the pre-overload harness returned, plus the
    load-shedding ledger (every overload decision the engine made, counted
    by reason) the bench's overload section gates on. Iterates as the
    legacy ``(qdepth, wall)`` pair so existing unpacking call sites keep
    working."""

    qdepth: list
    wall: float
    submitted: int = 0
    served: int = 0
    shed: int = 0                   # total, any reason
    shed_deadline: int = 0
    shed_queue_full: int = 0
    shed_capacity: int = 0
    capacity_recoveries: int = 0    # parked heads later admitted
    cancelled: int = 0              # chaos mid-stream cancellations
    degraded_cycles: int = 0        # cycles the overload controller degraded
    overload_transitions: int = 0

    def __iter__(self):
        return iter((self.qdepth, self.wall))


def drive(eng, arrivals: Sequence[Arrival], max_cycles: int = 20_000,
          on_cycle=None) -> DriveResult:
    """The open-loop host loop: submit each arrival once the engine's
    virtual clock reaches its tick, step macro-cycles continuously
    (fast-forwarding idle stretches with :meth:`advance_idle` so the clock
    never stalls), and retire the last in-flight dispatch at the end.
    Returns a :class:`DriveResult` (unpacks as the legacy ``(qdepth,
    wall)`` pair); latency stamps land on the engine's request objects and
    shed requests land in ``eng.shed`` with their reason. ``on_cycle``
    (the chaos harness's injection point) is called with the engine after
    each cycle's arrivals are submitted and ONLY on cycles that will
    actually step a macro-cycle, immediately before that step — a fault
    injected there shapes the very cycle it is due in. Idle fast-forwards
    deliberately skip it: injecting before discovering there is no pending
    work would land the fault on a cycle that never runs a traversal, so
    its effective tick silently drifts past ``advance_idle``'s jump (the
    harness stamps any residual drift on each injected record)."""
    pending = deque(arrivals)
    qdepth: list[int] = []
    t0 = time.perf_counter()
    while pending or eng.pending_work() or eng.has_inflight:
        while pending and pending[0].arrival_tick <= eng.vclock:
            a = pending.popleft()
            eng.submit(list(a.prompt), a.max_new, arrival_tick=a.arrival_tick)
        if not eng.pending_work():
            if pending:
                # idle until the next scheduled arrival — the virtual
                # clock keeps ticking, the engine does not spin
                eng.advance_idle(max(int(pending[0].arrival_tick)
                                     - eng.vclock, 1))
                continue
            eng.flush()
            continue
        if on_cycle is not None:
            on_cycle(eng)
        eng.step()
        qdepth.append(eng.admission.ready_depth(eng.vclock))
        if eng.cycles >= max_cycles:
            break
    eng.flush()
    ov = getattr(eng, "overload", None)
    return DriveResult(
        qdepth=qdepth, wall=time.perf_counter() - t0,
        submitted=len(arrivals), served=len(eng.finished),
        shed=len(eng.shed), shed_deadline=eng.shed_deadline,
        shed_queue_full=eng.shed_queue_full,
        shed_capacity=eng.shed_capacity,
        capacity_recoveries=eng.capacity_recoveries,
        cancelled=eng.cancelled,
        degraded_cycles=ov.degraded_cycles if ov is not None else 0,
        overload_transitions=len(ov.transitions) if ov is not None else 0)


def write_trace(path: str, arrivals: Sequence[Arrival]) -> None:
    """Persist a schedule as JSONL — one ``{"arrival", "prompt", "max_new",
    "scenario"}`` object per line — the replayable inverse of
    :func:`trace_arrivals`."""
    with open(path, "w") as f:
        for a in arrivals:
            f.write(json.dumps({"arrival": a.arrival_tick,
                                "prompt": list(a.prompt),
                                "max_new": a.max_new,
                                "scenario": a.scenario}) + "\n")


def trace_arrivals(path: str, *, vocab: int, seed: int = 0
                   ) -> tuple[Arrival, ...]:
    """Replay a JSONL trace. Each line needs ``arrival`` and ``max_new``
    plus EITHER ``prompt`` (explicit token ids) or ``prompt_len`` (ids
    filled deterministically from ``seed``). Lines must be sorted by
    arrival; malformed lines raise with their line number."""
    rng = np.random.default_rng(seed)
    out: list[Arrival] = []
    last = None
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                tick = int(rec["arrival"])
                max_new = int(rec["max_new"])
                if "prompt" in rec:
                    prompt = tuple(int(t) for t in rec["prompt"])
                else:
                    prompt = tuple(
                        int(t) for t in
                        rng.integers(0, vocab, int(rec["prompt_len"])))
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"{path}:{ln}: bad trace line: {e}") from e
            if not prompt:
                raise ValueError(f"{path}:{ln}: empty prompt")
            if last is not None and tick < last:
                raise ValueError(
                    f"{path}:{ln}: arrivals must be sorted "
                    f"({tick} after {last})")
            last = tick
            out.append(Arrival(arrival_tick=tick, prompt=prompt,
                               max_new=max_new,
                               scenario=str(rec.get("scenario", "trace"))))
    return tuple(out)
