"""The serving engine's spans and staging byte counters, on the CPU: under
a ``torch.profiler`` a few requests emit every phase's span, each an
operator range and no user annotation, each staging span inside the phase
that owns it; with no profiler recording no span enters the profiler and
nothing served changes; and ``staging_bytes`` after a steady decode step
is the arithmetic of the shapes it staged."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans as spans_mod
from repro_torch.configs import registry
from repro_torch.memory.paged_kv import _bucket
from repro_torch.models import init_params
from repro_torch.serve.engine import MultiPortEngine

SPANS = ("engine.retire", "staging.retire", "engine.evict", "engine.prefill",
         "engine.decode", "engine.status", "staging.prefill",
         "engine.schedule", "engine.commit", "staging.pool", "pool.step",
         "engine.dispatch", "staging.decode")
COUNTERS = ("cycles", "pool_traversals", "decode_steps", "decode_traversals",
            "steady_decode_steps", "prefill_chunks", "decode_tile_reads",
            "evictions", "vclock", "staging_bytes")
# two slots for three requests: the third waits on an eviction
PROMPTS = ((list(range(1, 12)), 4), (list(range(5, 25)), 6),
           (list(range(3, 9)), 3))


@pytest.fixture(scope="module")
def model():
    cfg = registry.get("tinyllama-1.1b", reduced=True)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _engine(model, **kw):
    cfg, params = model
    kw = {"slots": 2, "max_len": 48, "chunk_tokens": 8, "page_tokens": 8,
          "seq_tile": 8, **kw}
    return MultiPortEngine(params, cfg, device="cpu", **kw)


def _serve(model) -> tuple:
    """(every request's tokens, the engine's counters) of PROMPTS served to
    the end."""
    eng = _engine(model)
    reqs = [eng.submit(p, max_new=n) for p, n in PROMPTS]
    eng.run()
    return ([r.generated for r in reqs],
            {k: getattr(eng, k) for k in COUNTERS})


@pytest.fixture(scope="module")
def traced(model):
    """The spans (name, start, end) of PROMPTS served under a profiler,
    and what was served."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        served = _serve(model)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name in SPANS]
    annotations = {e.name for e in prof.events() if e.is_user_annotation}
    return spans, served, annotations


def test_every_span_is_emitted_under_a_profiler(traced):
    spans, _, _ = traced
    assert {n for n, _, _ in spans} == set(SPANS)


def test_a_span_is_an_operator_range_and_no_user_annotation(traced):
    """Kineto copies each user annotation to the device's timeline, where
    it would cover the idle it is meant to explain; an operator range has
    no such copy."""
    _, _, annotations = traced
    assert not annotations & set(SPANS)


@pytest.mark.parametrize("child, parent", [
    ("staging.retire", "engine.retire"), ("staging.prefill", "engine.prefill"),
    ("staging.pool", "engine.commit"), ("pool.step", "engine.commit"),
    ("staging.decode", "engine.dispatch")])
def test_a_staging_span_lies_inside_its_phase(traced, child, parent):
    spans, _, _ = traced
    outer = [(a, b) for n, a, b in spans if n == parent]
    inner = [(a, b) for n, a, b in spans if n == child]
    assert inner
    for a, b in inner:
        assert any(lo <= a and b <= hi for lo, hi in outer), (child, a, b)


def test_no_profiler_enters_no_span_and_changes_nothing(model, traced,
                                                        monkeypatch):
    def entered(name):
        raise AssertionError(f"span {name!r} entered the profiler")

    plain = _serve(model)
    monkeypatch.setattr(spans_mod, "_range", entered)
    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert _serve(model) == plain
    assert traced[1] == plain


@pytest.mark.parametrize("kernel_mode", ["pallas", "reference"])
def test_staging_bytes_of_a_steady_decode_step(model, kernel_mode):
    """One steady step of four decoding slots: the retire's indices, words
    and tokens, the pool's port requests (one 1W+1R traversal, or a W then
    an R one in the reference's two passes), the gathers, and the two
    pinned stages of the decode batch."""
    cfg, _ = model
    eng = _engine(model, slots=4, max_len=64, chunk_tokens=16, seq_tile=16,
                  kernel_mode=kernel_mode)
    for k in range(4):
        eng.submit(list(range(1 + k, 9 + 2 * k)), max_new=20)
    for _ in range(3):                 # prefill, a first decode, a steady one
        eng.step()
    prev = eng._inflight
    before = eng.staging_bytes
    steady = eng.steady_decode_steps
    eng.step()
    after = eng.staging_bytes
    assert eng.steady_decode_steps == steady + 1 and not eng._prefilling

    nl, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    w = nl * 2 * hkv * hd                     # f32 elements of a pool word
    n, nb_prev = len(prev.active), prev.logits.shape[0]
    lens = eng._inflight.lens
    nb, gathered = len(lens), int(lens[lens > 0].sum())
    stage_s = 64        # the padded capacity, and the reference's max_len
    if kernel_mode == "pallas":               # addr int32 + mask bool a lane
        q = _bucket(max(n, gathered))
        pool_up = q * w * 4 + 2 * 5 * q
    else:
        qa, qr = _bucket(n), _bucket(gathered)
        pool_up = qa * w * 4 + 5 * qa + 5 * qr
    want = {
        # retire's row and position indices (int64), the pool's requests,
        # the decode batch's lengths and last tokens (int32)
        "h2d_pageable_bytes": 2 * n * 8 + pool_up + 2 * nb * 4,
        "h2d_pinned_bytes": 2 * nl * nb * stage_s * hkv * hd * 4,
        # the gathers, then the retired words and every row's token (int64)
        "d2h_bytes": 4 * w * gathered + n * w * 4 + nb_prev * 8,
    }
    assert {k: after[k] - before[k] for k in want} == want
    assert n == 4 and gathered == sum(eng.slot_len)
