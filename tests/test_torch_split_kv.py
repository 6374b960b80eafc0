"""Split-KV decode in the port against the JAX package.

The plain split version (what the wrapper runs on CPU tensors) goes through
the same numpy-drawn inputs as the JAX ``fused_append_attend(
num_kv_splits=ns)`` in interpret mode, on the ragged cases of
tests/kernels/test_split_kv.py: outputs agree at f32 1e-5 (each side sums
its banks in its own order), caches and serviced tiles are identical, and
``num_kv_splits=1`` is the serial path bit for bit. At engine level the
port with ``num_kv_splits=4`` matches the JAX engine on the workload of
tests/serve/test_engine_dynamic.py: tokens and every tile counter,
the critical-path chains included. The CUDA kernels are held against the
plain version on the card by test_torch_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels.kv_multiport import fused_append_attend as j_fused
from repro.models import init_params as j_init
from repro.serve.engine import MultiPortEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.kernels import kv_multiport as kvmp
from repro_torch.models import params_from_numpy
from repro_torch.serve.engine import MultiPortEngine as TEngine

F32_TOL = 1e-5
LENS_CASES = [
    [0, 17, 60],        # ragged: fresh row, mid row, near-capacity row
    [-1, 17, -1],       # dead-row sentinels around a live row
    [5, 5, 5],          # every row shorter than one split at high splits
    [63, 0, 31],        # append at the last slot of the last tile
    [7, 8, 9],          # straddling one tile boundary (tile=8)
    [0, 1, 2],          # fewer live tiles than splits: surplus banks empty
]


def _case(rng, b=3, s=64, hkv=2, g=2, d=16):
    h = hkv * g
    return [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, h, d), (b, s, hkv, d), (b, s, hkv, d),
                       (b, hkv, d), (b, hkv, d))]


@functools.lru_cache(maxsize=None)
def _j_step(items: tuple):
    """The JAX decode step for one set of static arguments, jitted once:
    the lens are traced, so every case of a split count shares a trace."""
    return jax.jit(functools.partial(j_fused, seq_tile=8, return_tiles=True,
                                     interpret=True, **dict(items)))


def _both(arrs, lens, **kw):
    """(JAX result, port result) of one decode step, as numpy."""
    j = _j_step(tuple(sorted(kw.items())))(
        *[jnp.asarray(a) for a in arrs], jnp.asarray(lens, jnp.int32))
    tk = [torch.from_numpy(a.copy()) for a in arrs]
    t = kvmp.fused_append_attend(*tk, torch.tensor(lens, dtype=torch.int32),
                                 seq_tile=8, return_tiles=True, **kw)
    assert t[1] is tk[1] and t[2] is tk[2]                 # updated in place
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_match(arrs, lens, **kw):
    j, t = _both(arrs, lens, **kw)
    np.testing.assert_allclose(t[0], j[0], atol=F32_TOL, rtol=F32_TOL)
    for a, b in zip(t[1:], j[1:]):                         # caches + tiles
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("splits", [2, 3, 4, 8])
@pytest.mark.parametrize("lens", LENS_CASES, ids=[str(c) for c in LENS_CASES])
def test_split_matches_jax_dynamic_grid(rng, lens, splits):
    _assert_match(_case(rng), lens, dynamic_grid=True, num_kv_splits=splits)


@pytest.mark.parametrize("splits,mode", [
    (2, dict(live_len=61)),
    (4, dict(live_len=61)),
    (3, dict(length_mask=False)),
    (4, dict(live_len=40, length_mask=False)),
])
def test_split_matches_jax_static_prefix_and_unbounded(rng, splits, mode):
    """The static live prefix, and the unbounded comparator whose tiles
    past a row's live range clip into its banks (they add no score)."""
    _assert_match(_case(rng), [0, 17, 39], num_kv_splits=splits, **mode)


def test_split_one_is_the_serial_path(rng):
    """num_kv_splits=1 runs the serial function itself: bitwise equal."""
    arrs = _case(rng)
    lens = torch.tensor([0, 17, 60], dtype=torch.int32)
    outs = []
    for kw in (dict(), dict(num_kv_splits=1)):
        tk = [torch.from_numpy(a.copy()) for a in arrs]
        outs.append(kvmp.fused_append_attend(*tk, lens, seq_tile=8,
                                             dynamic_grid=True,
                                             return_tiles=True, **kw))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_split_stages_compose_and_dead_rows_zero(rng):
    """Stage 1's empty banks are (acc 0, m -inf, l 0); stage 2 turns an
    all-empty row into zeros; the two stages compose to the split path."""
    arrs = _case(rng)
    lens = torch.tensor([-1, 17, 2], dtype=torch.int32)
    tk = [torch.from_numpy(a.copy()) for a in arrs]
    acc, st, tiles = kvmp.split_partials_plain(
        *tk, lens, seq_tile=8, n_tiles=8, length_mask=True, num_kv_splits=4)
    assert tiles.tolist() == [0, 3, 1]
    assert torch.isinf(st[0, :, :, 0]).all() and not st[0, :, :, 1].any()
    assert not acc[0].any()
    assert torch.isinf(st[2, 1:, :, 0]).all()       # one tile: banks 1.. empty
    out = kvmp.split_combine_plain(acc, st, torch.float32)
    assert not out[0].any()
    ref, *_ = kvmp.fused_append_attend(
        *[torch.from_numpy(a.copy()) for a in arrs], lens, seq_tile=8,
        dynamic_grid=True, num_kv_splits=4)
    assert torch.equal(out, ref)


def test_ops_routes_splits_to_the_fused_path_only(rng):
    """``port_mix="wr"`` runs the split path; ``"w+r"`` (a 1-port budget)
    is the two-pass oracle, which has no traversal to split and ignores
    ``num_kv_splits``, as in the JAX package."""
    from repro_torch.kernels import ops, ref
    arrs = _case(rng)
    lens = torch.tensor([0, 17, 60], dtype=torch.int32)

    def run(fn, **kw):
        return fn(*[torch.from_numpy(a.copy()) for a in arrs], lens, **kw)

    got = run(ops.fused_decode_attention, seq_tile=8, dynamic_grid=True,
              num_kv_splits=4)
    want = run(kvmp.fused_append_attend, seq_tile=8, dynamic_grid=True,
               num_kv_splits=4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    got = run(ops.fused_decode_attention, num_kv_splits=4, port_mix="w+r")
    for a, b in zip(got, run(ref.decode_attention_ref)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# engine level: the workload of test_engine_dynamic's split-KV test

@pytest.fixture(scope="module")
def split_runs():
    cfg_j = jreg.get("tinyllama-1.1b", reduced=True)
    cfg_t = treg.get("tinyllama-1.1b", reduced=True)
    params_j = j_init(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                                 "cpu")
    rng = np.random.default_rng(23)
    prompts = [[int(t) for t in rng.integers(0, cfg_t.vocab, n)]
               for n in (3, 9, 18, 30)]
    runs = {}
    for name, cls, params, cfg, splits in (
            ("jax4", JEngine, params_j, cfg_j, 4),
            ("torch4", TEngine, params_t, cfg_t, 4),
            ("torch1", TEngine, params_t, cfg_t, 1)):
        kw = {} if cls is JEngine else {"device": "cpu"}
        eng = cls(params, cfg, slots=2, max_len=64, seq_tile=8,
                  num_kv_splits=splits, **kw)
        for p in prompts:
            eng.submit(p, max_new=4)
        eng.run(max_cycles=500)
        runs[name] = eng
    return runs


SPLIT_COUNTERS = ("cycles", "pool_traversals", "decode_steps",
                  "steady_decode_steps", "decode_tile_reads",
                  "steady_decode_tile_reads", "steady_decode_tile_bound",
                  "decode_critical_tiles", "steady_decode_critical_tiles",
                  "prefill_tile_reads", "vclock")


def _tokens(eng):
    return {r.rid: tuple(r.generated) for r in eng.finished}


def test_split_engine_matches_jax_engine(split_runs):
    j, t = split_runs["jax4"], split_runs["torch4"]
    assert t.num_kv_splits == j.num_kv_splits == 4
    assert _tokens(t) == _tokens(j)
    for name in SPLIT_COUNTERS:
        assert getattr(t, name) == getattr(j, name), name


def test_split_engine_equals_serial_engine(split_runs):
    """Splits parallelize chains: same tokens and serviced tiles as the
    serial engine, a strictly shorter critical chain."""
    t1, t4 = split_runs["torch1"], split_runs["torch4"]
    assert _tokens(t4) == _tokens(t1)
    assert t4.steady_decode_tile_reads == t1.steady_decode_tile_reads
    assert t4.steady_decode_tile_bound == t1.steady_decode_tile_bound
    assert (t4.steady_decode_critical_tiles
            < t1.steady_decode_critical_tiles)


def test_split_forced_off_for_the_two_pass_compute(split_runs):
    """The reference compute has no traversal to split (as in JAX); a
    1-port budget's two-pass compute likewise."""
    t = split_runs["torch4"]
    for kw in (dict(kernel_mode="reference"), dict(max_ports=1)):
        eng = TEngine(t.params, t.cfg, slots=2, max_len=64,
                      num_kv_splits=4, device="cpu", **kw)
        assert eng.num_kv_splits == 1
