"""The port's fault-injection harness against the JAX package's.

``FaultPlan.generate`` draws the same plan from the same seed in both
packages. The invariant audit has teeth on the port's pool (a corrupted
pool raises). End to end, a chaos run on the port engine keeps its
survivors' tokens identical to the fault-free run, a pure stall changes no
token, and the port and the JAX engine (parameters bridged across) driven
through the same plan inject the same actions, cancel and stall the same
requests, run the same number of audits and generate the same tokens.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import init_params as j_init
from repro.serve import chaos as jchaos
from repro.serve import traffic as jtraffic
from repro.serve.engine import MultiPortEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.distributed.fault import (FailureInjector, Heartbeat,
                                           InjectedFailure)
from repro_torch.models import params_from_numpy
from repro_torch.serve.chaos import (KINDS, ChaosHarness, Fault, FaultPlan,
                                     InvariantViolation, check_invariants)
from repro_torch.serve.engine import MultiPortEngine as TEngine
from repro_torch.serve.traffic import Arrival, drive, poisson_arrivals

ENGINE = dict(slots=2, max_slots=2, max_len=32, seq_tile=8, chunk_tokens=8)


@pytest.mark.parametrize("args", [(7, 40, {}), (23, 18, dict(max_squeeze=4)),
                                  (5, 8, dict(n_faults=9, kinds=("stall",
                                                                 "cancel")))])
def test_fault_plan_matches_jax(args):
    seed, horizon, kw = args
    got = FaultPlan.generate(seed, horizon, **kw)
    want = jchaos.FaultPlan.generate(seed, horizon, **kw)
    assert got.seed == want.seed
    assert ([dataclasses.astuple(f) for f in got.faults]
            == [dataclasses.astuple(f) for f in want.faults])
    assert got == FaultPlan.generate(seed, horizon, **kw)


def test_fault_validation():
    for kw in (dict(kind="meteor"), dict(kind="stall", tick=-1),
               dict(kind="squeeze", magnitude=0),
               dict(kind="cancel", choice=1.0)):
        with pytest.raises(ValueError):
            Fault(**{"tick": 0, **kw})
    with pytest.raises(ValueError):
        FaultPlan.generate(0, horizon=0)
    with pytest.raises(ValueError):
        FaultPlan.generate(0, 10, kinds=("squeeze", "meteor"))


@pytest.fixture(scope="module")
def served():
    cfg_j = jreg.get("tinyllama-1.1b", reduced=True)
    cfg_t = treg.get("tinyllama-1.1b", reduced=True)
    params_j = j_init(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                                 "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _engine(served):
    return TEngine(served[3], served[1], device="cpu", **ENGINE)


def _arrivals(n=10):
    return poisson_arrivals(n, 0.8, seed=3, vocab=256, max_prompt=16,
                            max_output=4)


def _tokens(eng):
    return {r.rid: tuple(r.generated) for r in eng.finished}


# ---------------------------------------------------------------------------
# the invariant audit has teeth

def test_check_invariants_clean_engine(served):
    eng = _engine(served)
    check_invariants(eng)
    eng.submit([1, 2, 3], max_new=2)
    eng.step()
    check_invariants(eng)


@pytest.mark.parametrize("corrupt", ["duplicate_free", "orphan_table",
                                     "refcount_drift", "slot_len"])
def test_check_invariants_catches_a_corrupted_pool(served, corrupt):
    eng = _engine(served)
    pool = eng.pool
    if corrupt == "duplicate_free":
        pool.free_by_shard[0].append(pool.free_by_shard[0][0])
    elif corrupt == "orphan_table":
        pool.tables[999] = [pool.free_by_shard[0].pop()]  # rid in no slot
    else:
        eng.submit([1, 2, 3, 4, 5], max_new=3)
        eng.step()
        eng.flush()
        if corrupt == "refcount_drift":
            page = pool.tables[0][0]
            pool.refcounts[page] += 1
        else:
            eng.slot_len[0] += 1
    with pytest.raises(InvariantViolation):
        check_invariants(eng)


# ---------------------------------------------------------------------------
# end to end

@pytest.fixture(scope="module")
def chaos_runs(served):
    """The fault-free and seed-23 chaos runs of one schedule, on the port
    engine and on the JAX engine."""
    cfg_j, _, params_j, _ = served
    arrivals = _arrivals()
    j_arrivals = tuple(jtraffic.Arrival(*dataclasses.astuple(a))
                       for a in arrivals)
    horizon = arrivals[-1].arrival_tick + 1
    runs = {}
    ref = _engine(served)
    drive(ref, arrivals)
    runs["ref"] = ref
    eng = _engine(served)
    harness = ChaosHarness(FaultPlan.generate(23, horizon=horizon,
                                              max_squeeze=4))
    drive(eng, arrivals, on_cycle=harness)
    harness.finalize(eng)
    runs["torch"] = (eng, harness)
    ej = JEngine(params_j, cfg_j, **ENGINE)
    jh = jchaos.ChaosHarness(jchaos.FaultPlan.generate(23, horizon=horizon,
                                                       max_squeeze=4))
    jtraffic.drive(ej, j_arrivals, on_cycle=jh)
    jh.finalize(ej)
    runs["jax"] = (ej, jh)
    return arrivals, runs


def test_chaos_run_survivor_token_identity(chaos_runs):
    arrivals, runs = chaos_runs
    ref_toks = _tokens(runs["ref"])
    assert len(ref_toks) == len(arrivals)
    eng, harness = runs["torch"]
    assert harness.invariant_checks >= len(harness.plan.faults) + 1
    assert [i["kind"] for i in harness.injected if i["kind"] in KINDS]
    survivors = [r for r in eng.finished
                 if not r.cancelled and r.shed_reason is None]
    assert survivors, "chaos run must still serve someone"
    for r in survivors:
        assert tuple(r.generated) == ref_toks[r.rid], r.rid
    served_rids = {r.rid for r in eng.finished}
    shed_rids = {r.rid for r in eng.shed}
    assert served_rids | shed_rids == set(ref_toks)      # everyone, once
    assert not served_rids & shed_rids
    check_invariants(eng)


def test_chaos_run_matches_jax(chaos_runs):
    _, runs = chaos_runs
    (et, th), (ej, jh) = runs["torch"], runs["jax"]
    assert th.injected == jh.injected
    assert th.invariant_checks == jh.invariant_checks
    assert th.straggler_events == jh.straggler_events
    for name in ("cancelled", "stalled_retirements", "retire_stall_cycles",
                 "capacity_parked_cycles", "capacity_recoveries", "vclock",
                 "cycles"):
        assert getattr(et, name) == getattr(ej, name), name
    assert _tokens(et) == _tokens(ej)
    assert ({r.rid for r in et.finished if r.cancelled}
            == {r.rid for r in ej.finished if r.cancelled})
    assert ([(r.rid, r.shed_reason) for r in et.shed]
            == [(r.rid, r.shed_reason) for r in ej.shed])


def test_chaos_stall_preserves_tokens(served, chaos_runs):
    """A pure-stall plan (delayed retirement only): every request still
    finishes, tokens untouched — the stall moves retirement, not data."""
    arrivals = _arrivals()
    plan = FaultPlan(seed=0, faults=(
        Fault(tick=1, kind="stall", magnitude=2),
        Fault(tick=4, kind="stall", magnitude=3),
    ))
    eng = _engine(served)
    harness = ChaosHarness(plan)
    drive(eng, arrivals, on_cycle=harness)
    harness.finalize(eng)
    assert eng.stalled_retirements > 0
    assert _tokens(eng) == _tokens(chaos_runs[1]["ref"])


def test_cancel_during_a_stalled_decode_spares_the_next_occupant(served):
    """The retire guard: a slot cancelled while its decode is in flight
    (and reused by a new admission) never receives the stale row."""
    eng = _engine(served)
    a = eng.submit([5, 7, 11], max_new=6)
    eng.submit([9, 9, 9, 9], max_new=6)
    for _ in range(3):
        eng.step()
    assert eng.has_inflight
    eng.stall_retirement(3)
    assert eng.cancel(a.rid) and not eng.cancel(a.rid)
    c = eng.submit([2, 4, 6], max_new=3)
    eng.run()
    assert a.cancelled and c.slot == a.slot
    ref = _engine(served)
    rc = ref.submit([2, 4, 6], max_new=3)
    ref.run()
    assert c.generated == rc.generated
    with pytest.raises(ValueError):
        eng.stall_retirement(0)


def test_fault_in_idle_stretch_fires_on_real_cycle(served):
    """A fault planned inside an idle gap fires on the first real cycle
    after it, with its plan tick and drift stamped."""
    arrivals = (Arrival(arrival_tick=0, prompt=(5, 7, 11, 13), max_new=2),
                Arrival(arrival_tick=500, prompt=(3, 9, 2, 6), max_new=2))
    ref = _engine(served)
    drive(ref, arrivals)
    harness = ChaosHarness(FaultPlan(seed=0, faults=(
        Fault(tick=400, kind="stall", magnitude=2),)))
    seen = []

    def hook(eng):
        seen.append((eng.vclock, eng.pending_work()))
        harness(eng)

    eng = _engine(served)
    drive(eng, arrivals, on_cycle=hook)
    harness.finalize(eng)
    assert seen and all(pw for _, pw in seen)
    assert all(not (400 <= v < 500) for v, _ in seen)
    rec = next(i for i in harness.injected if i["kind"] == "stall")
    assert rec["plan_tick"] == 400 and rec["tick"] >= 500
    assert rec["drift"] == rec["tick"] - 400 > 0
    assert eng.retire_stall_cycles == 0
    assert _tokens(eng) == _tokens(ref)


def test_chaos_harness_heartbeat_and_straggler(served, tmp_path):
    harness = ChaosHarness(FaultPlan.generate(5, horizon=8),
                           heartbeat_dir=str(tmp_path), worker="chaos0",
                           straggler_multiplier=0.5)
    eng = _engine(served)
    drive(eng, _arrivals(n=6), on_cycle=harness)
    harness.finalize(eng)
    step, stamp = (tmp_path / "heartbeat_chaos0").read_text().split()
    assert int(step) <= eng.cycles and float(stamp) <= time.time()
    assert Heartbeat.stale_workers(str(tmp_path), timeout_s=3600) == []
    assert harness.straggler_events > 0 and harness.straggler.events


def test_failure_injector_fires_once():
    inj = FailureInjector(fail_at_steps=(2,))
    inj.maybe_fail(1)
    with pytest.raises(InjectedFailure):
        inj.maybe_fail(2)
    inj.maybe_fail(2)
