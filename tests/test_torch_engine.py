"""The port's serving engine against the JAX engine, stepped in lockstep on
the workloads of tests/serve/test_engine_paged.py and test_prefix_cache.py,
in both kernel modes, with the JAX parameters bridged across. Greedy
tokens, traversal and tile counters, the schedule log, the per-mix
traversal histogram and every prefix-cache counter are identical; the pool
storage agrees after every macro-cycle (f32, 1e-5: its words are K/V
vectors each framework computes with its own matmuls). The same holds
over the port-budget / schedule / prefix-cache sweep, and for the MoE
family (reduced deepseek-moe-16b and llama4-scout-17b-a16e) with capacity
drops in the prefill chunks."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import init_params as j_init
from repro.serve.engine import MultiPortEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.models import init_params as t_init
from repro_torch.models import mlp as tmlp
from repro_torch.models import params_from_numpy
from repro_torch.serve.engine import MultiPortEngine as TEngine
from test_torch_moe import slots_over_capacity

COUNTERS = ("cycles", "pool_traversals", "decode_steps", "decode_traversals",
            "steady_decode_steps", "steady_decode_traversals",
            "prefill_steps", "prefill_traversals", "prefill_tokens",
            "prefill_chunks", "decode_tile_reads", "steady_decode_tile_reads",
            "steady_decode_tile_bound", "decode_critical_tiles",
            "prefill_tile_reads", "multi_phase_cycles", "coscheduled_cycles",
            "evictions", "idle_ticks", "vclock")


def _bridge(arch):
    cfg_j = jreg.get(arch, reduced=True)
    cfg_t = treg.get(arch, reduced=True)
    params_j = j_init(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                                 "cpu")
    return cfg_j, cfg_t, params_j, params_t


@pytest.fixture(scope="module")
def served():
    return _bridge("tinyllama-1.1b")


def _pair(served, **kw):
    cfg_j, cfg_t, params_j, params_t = served
    return (JEngine(params_j, cfg_j, **kw),
            TEngine(params_t, cfg_t, device="cpu", **kw))


def _same_storage(ej, et):
    js = np.asarray(ej.pool.storage)[:, :ej.pool.io_width]
    np.testing.assert_allclose(et.pool.storage.numpy(), js, atol=1e-5,
                               rtol=1e-5)


def _lockstep(ej, et, max_cycles=500):
    while ej.pending_work() and ej.cycles < max_cycles:
        assert et.pending_work()
        ej.step()
        et.step()
        _same_storage(ej, et)
    assert not et.pending_work()
    ej.flush()
    et.flush()


def _assert_same(ej, et):
    tok = lambda e: {r.rid: tuple(r.generated) for r in e.finished}  # noqa: E731
    assert tok(et) == tok(ej)
    for name in COUNTERS:
        assert getattr(et, name) == getattr(ej, name), name
    assert et.schedule_log == ej.schedule_log
    assert et.port_log == ej.port_log
    assert et.pool.mix_counts == ej.pool.mix_counts
    assert (et.pool.tile_reads, et.pool.tile_writes) == \
        (ej.pool.tile_reads, ej.pool.tile_writes)
    assert et.prefix_stats == ej.prefix_stats
    _same_storage(ej, et)


@pytest.mark.parametrize("mode", ["pallas", "reference"])
def test_paged_engine_matches_jax(served, mode):
    """test_engine_paged's workload: 4 requests through 2 slots, prefill ->
    decode -> evict."""
    cfg = served[1]
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab,
                                             int(rng.integers(3, 8)))]
               for _ in range(4)]
    ej, et = _pair(served, slots=2, max_len=64, prefill_bucket=8,
                   kernel_mode=mode)
    for p in prompts:
        ej.submit(p, max_new=5)
        et.submit(p, max_new=5)
    _lockstep(ej, et)
    _assert_same(ej, et)
    assert len(et.finished) == 4


@pytest.mark.parametrize("mode", ["pallas", "reference"])
def test_prefix_cache_engine_matches_jax(served, mode):
    """test_prefix_cache's staggered workload: one registrant decoding while
    two sharers arrive (a full match and a partial-page match), so attach,
    copy-on-write and detach all run."""
    ej, et = _pair(served, slots=2, max_slots=2, max_len=32, seq_tile=8,
                   chunk_tokens=8, page_tokens=8, kernel_mode=mode,
                   prefix_cache=True)
    prompt = list(range(7, 19))
    for e in (ej, et):
        e.submit(prompt, max_new=8)
    for _ in range(4):
        ej.step()
        et.step()
        _same_storage(ej, et)
    for e in (ej, et):
        e.submit(prompt, max_new=4)
        e.submit(prompt[:10] + [99, 98], max_new=4)
    _lockstep(ej, et)
    _assert_same(ej, et)
    assert et.prefix_stats["hits"] >= 2 and et.pool.cow_copies >= 1
    assert et.pool.free_page_count == et.pool.plan.n_pages
    assert not et.pool.refcounts and not et.pool.prefix_index


def test_static_bucketed_two_port_engine_matches_jax(served):
    """The rigid static schedule, the bucketed stage ladder and a 2-port
    budget on the fused path."""
    cfg = served[1]
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in (3, 9, 5)]
    ej, et = _pair(served, slots=2, max_len=64, chunk_tokens=4, seq_tile=8,
                   kernel_mode="pallas", schedule_mode="static",
                   dynamic_grid=False, max_ports=2)
    for p in prompts:
        ej.submit(p, max_new=4)
        et.submit(p, max_new=4)
    _lockstep(ej, et)
    _assert_same(ej, et)
    assert et.stage_lens_seen == ej.stage_lens_seen


def test_engine_refuses_unported_options(served):
    """Split-KV is ported (its count is validated as in the JAX engine).
    What the JAX engine refuses, the port refuses with the same exception:
    the families without a KV cache (rwkv6-3b, zamba2-7b: ValueError at
    construction) and embedding-input models (qwen2-vl-7b, musicgen-large:
    NotImplementedError at admission)."""
    cfg_t, params_t = served[1], served[3]
    with pytest.raises(ValueError, match="num_kv_splits"):
        TEngine(params_t, cfg_t, num_kv_splits=0, device="cpu")
    assert TEngine(params_t, cfg_t, num_kv_splits=2,
                   device="cpu").num_kv_splits == 2
    for arch in ("rwkv6-3b", "zamba2-7b"):
        for engine in (JEngine, TEngine):
            kw = {"device": "cpu"} if engine is TEngine else {}
            with pytest.raises(ValueError, match="KV-cache families"):
                engine(params_t, treg.get(arch, reduced=True), **kw)
    for arch in ("qwen2-vl-7b", "musicgen-large"):
        cfg = treg.get(arch, reduced=True)
        eng = TEngine(t_init(cfg, torch.Generator().manual_seed(0), "cpu"),
                      cfg, slots=2, max_len=32, device="cpu")
        eng.submit([1, 2, 3], max_new=2)
        with pytest.raises(NotImplementedError, match="token models"):
            eng.step()


def test_engine_staging_is_a_device_copy(served):
    """The staged tensor handed to the model is a copy, never a view of
    the double-buffered host staging memory."""
    et = _pair(served, slots=2, max_len=32)[1]
    buf = et._stage_bufs.get(("t", "k"), (2, 3))
    staged = et._stage_bufs.to_device(buf)
    staged += 1.0
    assert float(torch.from_numpy(buf).abs().max()) == 0.0


def _shared_prefix_prompts(vocab):
    """Four prompts through 2 slots, three sharing a 16-token prefix; the
    first sharer decodes longest, so later sharers find it resident."""
    rng = np.random.default_rng(7)
    head = [int(t) for t in rng.integers(0, vocab, 16)]
    tails = [[int(t) for t in rng.integers(0, vocab, n)] for n in (3, 5, 2)]
    other = [int(t) for t in rng.integers(0, vocab, 9)]
    return [(head + tails[0], 8), (other, 2), (head + tails[1], 3),
            (head + tails[2], 3)]


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("schedule_mode", ["ooo", "static"])
@pytest.mark.parametrize("max_ports", [1, 3])
def test_port_budget_schedule_and_prefix_sweep_matches_jax(
        served, max_ports, schedule_mode, prefix_cache):
    """The parity sweep of the engine's options in pallas mode: a 1- and a
    3-port budget, both schedules, the prefix cache on and off."""
    ej, et = _pair(served, slots=2, max_slots=2, max_len=48, chunk_tokens=8,
                   page_tokens=8, seq_tile=8, kernel_mode="pallas",
                   max_ports=max_ports, schedule_mode=schedule_mode,
                   prefix_cache=prefix_cache)
    for prompt, max_new in _shared_prefix_prompts(served[1].vocab):
        ej.submit(prompt, max_new=max_new)
        et.submit(prompt, max_new=max_new)
    _lockstep(ej, et)
    _assert_same(ej, et)
    assert len(et.finished) == 4
    assert (et.prefix_stats["hits"] > 0) == prefix_cache


class _DropCounter:
    """Wraps ``mlp.moe_ffn``, the serving steps' MoE layer, to count, per
    call, the slots its capacity drops (routed as both sides route: stable
    descending sort)."""

    def __init__(self):
        self.chunk_drops = self.calls = 0
        self._orig = tmlp.moe_ffn

    def __call__(self, p, x, cfg, compute_dtype=None):
        if x.shape[1] > 1:
            self.chunk_drops += slots_over_capacity(p, x, cfg)
        self.calls += 1
        return self._orig(p, x, cfg, compute_dtype)


@pytest.fixture(scope="module", params=["deepseek-moe-16b",
                                        "llama4-scout-17b-a16e"])
def moe_served(request):
    return _bridge(request.param)


@pytest.mark.parametrize("mode", ["pallas", "reference"])
def test_moe_engine_matches_jax(moe_served, mode, monkeypatch):
    """deepseek at its own capacity factor (its chunks drop slots: a padded
    chunk routes its pad rows alike), llama4-scout at capacity 0.25 (drops
    forced everywhere); 4 requests through 2 slots, prefix cache on."""
    cfg_j, cfg_t, params_j, params_t = moe_served
    if cfg_t.arch_id.startswith("llama4"):
        cfg_j, cfg_t = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=0.25)) for c in (cfg_j, cfg_t))
    drops = _DropCounter()
    monkeypatch.setattr(tmlp, "moe_ffn", drops)
    ej, et = _pair((cfg_j, cfg_t, params_j, params_t), slots=2, max_len=48,
                   chunk_tokens=8, page_tokens=8, seq_tile=8,
                   kernel_mode=mode, prefix_cache=True)
    for prompt, max_new in _shared_prefix_prompts(cfg_t.vocab):
        ej.submit(prompt, max_new=max_new)
        et.submit(prompt, max_new=max_new)
    _lockstep(ej, et)
    _assert_same(ej, et)
    assert len(et.finished) == 4
    assert drops.calls and drops.chunk_drops > 0
