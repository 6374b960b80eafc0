"""The port's open-loop traffic module against the JAX package's.

The generators consume the same numpy streams in the same order, so the
same seed gives the same schedule in both packages, exactly: Poisson
arrivals (with and without shared-prefix pools), the scenario spread and
trace replay. The open-loop host loop ``drive`` then runs the port engine
and the JAX engine (parameters bridged across) on the workloads of
tests/serve/test_traffic.py and a slot-contended one: tokens, every
latency stamp on the virtual clock, the clock itself and every
``DriveResult`` field but the wall time are identical.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import init_params as j_init
from repro.serve import traffic as jtraffic
from repro.serve.engine import MultiPortEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.models import params_from_numpy
from repro_torch.serve import traffic
from repro_torch.serve.engine import MultiPortEngine as TEngine

VOCAB = treg.get("tinyllama-1.1b", reduced=True).vocab


def _fields(xs) -> list:
    """Dataclass records as plain tuples (the two packages' classes differ)."""
    return [dataclasses.astuple(x) for x in xs]


@pytest.mark.parametrize("seed,n,rate", [(7, 24, 0.4), (3, 64, 1.5),
                                         (0, 5, 0.05)])
def test_poisson_arrivals_match_jax(seed, n, rate):
    kw = dict(seed=seed, vocab=VOCAB, max_prompt=40, max_output=10)
    got = traffic.poisson_arrivals(n, rate, **kw)
    assert _fields(got) == _fields(jtraffic.poisson_arrivals(n, rate, **kw))
    assert got == traffic.poisson_arrivals(n, rate, **kw)     # seeded


def test_shared_prefix_arrivals_match_jax():
    ids = ("tinyllama-1.1b", "qwen2-0.5b")
    kw = dict(seed=9, vocab=VOCAB, max_prompt=30, max_output=6)
    got = traffic.poisson_arrivals(
        16, 0.7, scenarios=traffic.scenario_spread(
            ids, shared_prefixes=2, prefix_tokens=12), **kw)
    want = jtraffic.poisson_arrivals(
        16, 0.7, scenarios=jtraffic.scenario_spread(
            ids, shared_prefixes=2, prefix_tokens=12), **kw)
    assert _fields(got) == _fields(want)


def test_scenario_spread_matches_jax():
    assert _fields(traffic.scenario_spread()) == \
        _fields(jtraffic.scenario_spread())
    scales = sorted(s.prompt_scale for s in traffic.scenario_spread())
    assert scales[0] == pytest.approx(0.5) and scales[-1] == pytest.approx(2.0)
    with pytest.raises(ValueError):
        traffic.Scenario("x", 1.0, 1.0, shared_prefixes=2)


def test_bounded_pareto_matches_jax():
    a = traffic._bounded_pareto(np.random.default_rng(0), 1.2, 2.0, 40.0, 500)
    b = jtraffic._bounded_pareto(np.random.default_rng(0), 1.2, 2.0, 40.0, 500)
    np.testing.assert_array_equal(a, b)


def test_trace_round_trip_and_jax_replay(tmp_path):
    arr = traffic.poisson_arrivals(8, 0.4, seed=11, vocab=VOCAB,
                                   max_prompt=40, max_output=10)
    p = tmp_path / "trace.jsonl"
    traffic.write_trace(str(p), arr)
    assert traffic.trace_arrivals(str(p), vocab=VOCAB) == arr
    assert _fields(jtraffic.trace_arrivals(str(p), vocab=VOCAB)) == \
        _fields(arr)
    q = tmp_path / "lens.jsonl"
    q.write_text('{"arrival": 0, "prompt_len": 5, "max_new": 2}\n'
                 '{"arrival": 3, "prompt_len": 3, "max_new": 1}\n')
    got = traffic.trace_arrivals(str(q), vocab=VOCAB, seed=4)
    assert [a.prompt_len for a in got] == [5, 3]
    assert _fields(got) == _fields(
        jtraffic.trace_arrivals(str(q), vocab=VOCAB, seed=4))


def test_trace_errors_carry_line_numbers(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"arrival": 5, "prompt_len": 2, "max_new": 1}\n'
                 '{"arrival": 3, "prompt_len": 2, "max_new": 1}\n')
    with pytest.raises(ValueError, match=r"bad\.jsonl:2.*sorted"):
        traffic.trace_arrivals(str(p), vocab=VOCAB)
    p.write_text('{"arrival": 0, "max_new": 1}\n')
    with pytest.raises(ValueError, match=r"bad\.jsonl:1"):
        traffic.trace_arrivals(str(p), vocab=VOCAB)
    p.write_text('{"arrival": 0, "prompt": [], "max_new": 1}\n')
    with pytest.raises(ValueError, match=r"bad\.jsonl:1: empty prompt"):
        traffic.trace_arrivals(str(p), vocab=VOCAB)


# ---------------------------------------------------------------------------
# drive() on both engines

@pytest.fixture(scope="module")
def served():
    cfg_j = jreg.get("tinyllama-1.1b", reduced=True)
    cfg_t = treg.get("tinyllama-1.1b", reduced=True)
    params_j = j_init(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                                 "cpu")
    return cfg_j, cfg_t, params_j, params_t


STAMPS = ("rid", "generated", "arrival_tick", "admit_tick", "admit_cycle",
          "first_token_tick", "first_token_cycle", "finish_tick",
          "finish_cycle", "ttft_ticks", "tpot_ticks", "shed_reason")
RESULT = ("qdepth", "submitted", "served", "shed", "shed_deadline",
          "shed_queue_full", "shed_capacity", "capacity_recoveries",
          "cancelled", "degraded_cycles", "overload_transitions")


def _requests(eng) -> list:
    reqs = sorted(eng.finished + eng.shed, key=lambda r: r.rid)
    return [tuple(getattr(r, f) for f in STAMPS) for r in reqs]


@pytest.mark.parametrize("workload", ["open_eq_closed", "contended"])
def test_drive_matches_jax(served, workload):
    cfg_j, cfg_t, params_j, params_t = served
    if workload == "open_eq_closed":      # test_traffic's identity smoke
        arrivals = traffic.poisson_arrivals(4, 0.3, seed=5, vocab=VOCAB,
                                            max_prompt=12, max_output=4)
        kw = dict(slots=4, max_slots=4, max_len=32, seq_tile=8,
                  chunk_tokens=8)
    else:                                 # queueing behind 2 slots
        arrivals = traffic.poisson_arrivals(8, 0.8, seed=3, vocab=VOCAB,
                                            max_prompt=16, max_output=4)
        kw = dict(slots=2, max_slots=2, max_len=32, seq_tile=8,
                  chunk_tokens=8, max_queue_depth=5)
    j_arrivals = tuple(jtraffic.Arrival(*dataclasses.astuple(a))
                       for a in arrivals)
    ej = JEngine(params_j, cfg_j, **kw)
    et = TEngine(params_t, cfg_t, device="cpu", **kw)
    rj = jtraffic.drive(ej, j_arrivals)
    rt = traffic.drive(et, arrivals)
    assert _requests(et) == _requests(ej)
    assert et.vclock == ej.vclock and et.idle_ticks == ej.idle_ticks
    assert et.cycles == ej.cycles
    for f in RESULT:
        assert getattr(rt, f) == getattr(rj, f), f
    qdepth, wall = rt                     # unpacks as the legacy pair
    assert qdepth == rt.qdepth and wall >= 0.0
    assert not et.has_inflight
    if workload == "open_eq_closed":
        closed = TEngine(params_t, cfg_t, device="cpu", **kw)
        for a in arrivals:
            closed.submit(list(a.prompt), a.max_new, arrival_tick=0)
        closed.run()
        assert ({r.rid: r.generated for r in closed.finished}
                == {r.rid: r.generated for r in et.finished})


def test_advance_idle_moves_only_the_clock(served):
    et = TEngine(served[3], served[1], slots=2, max_len=32, device="cpu")
    et.advance_idle(7)
    assert (et.vclock, et.cycles, et.idle_ticks) == (7, 0, 7)
    with pytest.raises(ValueError):
        et.advance_idle(-1)
