"""The trace's reduction beside the program's own spans: those spans are
host operator ranges that carry no device-side annotation, so a profile
with them reduces exactly as one with the benchmark's spans alone, and
every user annotation a traced run records is one the reduction knows."""
import types

import pytest

from portbench import tracing
from portbench.tests import small

CUDA, CPU = "cuda", "cpu"
PROGRAM_SPANS = ("engine.retire", "staging.retire", "engine.evict",
                 "engine.prefill", "engine.decode", "engine.status",
                 "staging.prefill", "engine.schedule", "engine.commit",
                 "staging.pool", "pool.step", "engine.dispatch",
                 "staging.decode")


class _Event:
    def __init__(self, kind, name, start, end, device_us=0.0):
        from torch.autograd import DeviceType
        self.device_type = DeviceType.CUDA if kind == CUDA else DeviceType.CPU
        self.name = name
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_time_total = device_us


class _Profile:
    def __init__(self, events):
        self._events = [_Event(*e) for e in events]

    def events(self):
        return self._events


# a window of two engine steps, in us: the first step's pool traversal
# launches a kernel (its span's device annotation beside it), its decode
# step a kernel and, 10 us later, another; the second step one kernel
BENCH_ONLY = [
    (CPU, "harness.window", 0, 1000), (CPU, "engine.step", 10, 500),
    (CPU, "pool.cycle", 100, 200, 60.0), (CPU, "model.decode_step", 300, 400),
    (CPU, "engine.step", 510, 990),
    (CUDA, "Memcpy HtoD (Pageable -> Device)", 50, 90),
    (CUDA, "multiport_sram_kernel", 120, 180),
    (CUDA, "pool.cycle", 120, 180), (CUDA, "decode_kernel", 310, 330),
    (CUDA, "decode_kernel", 340, 345), (CUDA, "fill_kernel", 600, 605)]
# the program's spans in the same window, as host ranges alone: the commit
# around the pool traversal, the dispatch and its staging after the decode
# step, the next step's retire
PROGRAM = [
    (CPU, "engine.commit", 90, 210, 60.0), (CPU, "staging.pool", 95, 110),
    (CPU, "pool.step", 110, 200, 60.0), (CPU, "engine.dispatch", 290, 500),
    (CPU, "staging.decode", 400, 500), (CPU, "engine.retire", 520, 700),
    (CPU, "staging.retire", 600, 700)]


@pytest.mark.parametrize("extra", [(), PROGRAM], ids=["bench", "program"])
def test_a_profile_reduces_as_with_the_benchmarks_spans_alone(extra):
    got = tracing.reduce(_Profile(BENCH_ONLY + list(extra)))
    want = {
        "busy_s": 130e-6,
        "device_ops": {"Memcpy HtoD (Pageable -> Device)": 40e-6,
                       "multiport_sram_kernel": 60e-6,
                       "decode_kernel": 25e-6, "fill_kernel": 5e-6},
        "span_device_s": {"harness.window": 0.0, "engine.step": 0.0,
                          "pool.cycle": 60e-6, "model.decode_step": 0.0},
        "span_calls": {"harness.window": 1, "engine.step": 2,
                       "pool.cycle": 1, "model.decode_step": 1},
        "idle_by_span": {"pool.cycle": 30e-6, "engine.step": 385e-6,
                         "gaps under 20 us": 10e-6},
        "device_events": 5}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k


def test_every_annotation_a_traced_run_records_is_known(monkeypatch):
    seen, ranges = set(), set()
    reduce = tracing.reduce

    def spy(prof):
        for e in prof.events():
            (seen if e.is_user_annotation else ranges).add(e.name)
        return reduce(prof)

    monkeypatch.setattr(tracing, "reduce", spy)
    run = small.run("qwen2.5-3b.long_decode", seconds=0.5, trace=True)
    assert run.trace is not None
    assert {"engine.retire", "staging.decode", "pool.step"} <= ranges
    assert seen <= set(tracing.SPAN_NAMES)
    assert not seen & set(PROGRAM_SPANS)
