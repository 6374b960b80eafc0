"""Data-parallel KV serving of the port on CPU meshes
(``make_kv_mesh(n, devices=["cpu"] * n)``): the mesh, the shard geometry,
the sharded pool step against the unsharded one, the fused kernels run
once per shard, and the engine's greedy tokens and per-device accounting
against the unsharded port, the JAX unsharded engine and (in one
subprocess with forced host devices) the JAX sharded engine. Mirrors
tests/distributed/test_paged_sharding.py."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import init_params as j_init
from repro.serve.engine import MultiPortEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.distributed.sharding import (KVShardPlan, kv_pool_spec,
                                              kv_shard_plan, shard_apply)
from repro_torch.kernels import kv_multiport as kvmp
from repro_torch.kernels import ops
from repro_torch.launch.mesh import KVMesh, make_kv_mesh
from repro_torch.memory.paged_kv import PagedPool, PoolCapacityError
from repro_torch.models import params_from_numpy
from repro_torch.serve.engine import MultiPortEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = [1, 2, 4, 8]


def cpu_mesh(n: int) -> KVMesh:
    return make_kv_mesh(n, devices=["cpu"] * n)


# ---- the mesh ----------------------------------------------------------------

def test_make_kv_mesh_shape_devices_and_errors():
    mesh = cpu_mesh(4)
    assert mesh.axis_names == ("kv",)
    assert mesh.shape["kv"] == 4
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert make_kv_mesh(2, axis="data", devices=["cpu"] * 3).shape == \
        {"data": 2}
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        make_kv_mesh(0, devices=["cpu"])
    with pytest.raises(ValueError, match="kv mesh needs 3 devices but only "
                                         "2 are visible.*devices="):
        make_kv_mesh(3, devices=["cpu"] * 2)
    # no devices: the visible CUDA devices, none on this host
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {n + 1} devices but only "
                                         f"{n} are visible"):
        make_kv_mesh(n + 1)


# ---- shard geometry (mirrors) ------------------------------------------------

def test_kv_shard_plan_page_aligned():
    plan = kv_shard_plan(4, n_pages=10, page_tokens=8)
    assert plan.n_pages == 12 and plan.pages_per_shard == 3
    assert plan.words_per_shard == 24
    assert [plan.shard_of_page(p) for p in range(12)] == \
        [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3]
    assert [plan.shard_of_word(w) for w in (0, 23, 24, 95)] == [0, 0, 1, 3]
    with pytest.raises(ValueError, match="page-aligned"):
        KVShardPlan(n_shards=4, n_pages=10, page_tokens=8)
    pool = PagedPool.create(n_pages=10, page_tokens=8, word_width=8,
                            num_banks=4, kv_shards=4, device="cpu")
    assert pool.plan.n_pages == 12
    assert len(pool.free_pages) == 12


def test_kv_pool_spec_validation():
    """kv_pool_spec rejects straddling geometry and missing axes even on a
    one-shard mesh, and the sharded pool allocates the geometry it
    returns."""
    mesh = cpu_mesh(1)
    plan = kv_pool_spec(mesh, num_words=96, page_tokens=8)
    assert (plan.n_shards, plan.words_per_shard, plan.n_pages) == (1, 96, 12)
    with pytest.raises(ValueError, match="straddles a page"):
        kv_pool_spec(mesh, num_words=96, page_tokens=5)
    with pytest.raises(ValueError, match="no 'model' axis"):
        kv_pool_spec(mesh, num_words=96, page_tokens=8, axis="model")
    with pytest.raises(ValueError, match="does not divide"):
        kv_pool_spec(cpu_mesh(5), num_words=96, page_tokens=8)
    pool = PagedPool.create(n_pages=10, page_tokens=8, word_width=24,
                            num_banks=4, mesh=mesh, device="cpu")
    assert pool.storage.shape == (80, 24) and not pool.sharded
    pool4 = PagedPool.create(n_pages=10, page_tokens=8, word_width=24,
                             num_banks=4, mesh=cpu_mesh(4), device="cpu")
    four = kv_pool_spec(cpu_mesh(4), num_words=96, page_tokens=8)
    assert [tuple(s.shape) for s in pool4.storage] == \
        [(four.words_per_shard, 24)] * 4
    assert pool4.spec_local.num_words == 24
    with pytest.raises(ValueError, match="disagrees"):
        PagedPool.create(n_pages=8, page_tokens=4, word_width=8,
                         kv_shards=2, mesh=cpu_mesh(4), device="cpu")
    with pytest.raises(ValueError, match="no 'kv' axis"):
        PagedPool.create(n_pages=8, page_tokens=4, word_width=8,
                         mesh=make_kv_mesh(2, axis="x", devices=["cpu"] * 2),
                         device="cpu")


def _ones(n):
    return np.ones((n, 8), np.float32)


@pytest.mark.parametrize("mesh", [None, 2], ids=["control-plane", "mesh"])
def test_capacity_error_full_home_shard_before_mutation(mesh):
    """A full home shard raises the named error BEFORE any mutation even
    though other shards hold free pages; with and without sharded
    storage."""
    pool = PagedPool.create(n_pages=8, page_tokens=4, word_width=8,
                            num_banks=4, kv_shards=2, device="cpu",
                            mesh=cpu_mesh(mesh) if mesh else None)
    pool.cycle(prefill={"seq": 1, "vectors": _ones(16)})
    assert pool.home_of(1) == 0
    assert len(pool.free_by_shard[0]) == 0
    assert len(pool.free_by_shard[1]) == 4
    free_before = [list(f) for f in pool.free_by_shard]
    tables_before = {k: list(v) for k, v in pool.tables.items()}
    with pytest.raises(PoolCapacityError, match="home shard 0"):
        pool.cycle(append={"seq": 1, "vectors": _ones(1)})
    assert [list(f) for f in pool.free_by_shard] == free_before
    assert {k: list(v) for k, v in pool.tables.items()} == tables_before
    assert pool.lengths == {1: 16}
    pool.cycle(prefill={"seq": 2, "vectors": _ones(8)})
    assert pool.home_of(2) == 1
    assert pool.lengths[2] == 8
    pool.free(1)
    assert len(pool.free_by_shard[0]) == 4
    pool.cycle(prefill={"seq": 3, "vectors": _ones(4)})
    assert pool.home_of(3) == 0


def test_refused_read_does_not_leak_home_assignment():
    pool = PagedPool.create(n_pages=8, page_tokens=4, word_width=8,
                            num_banks=4, kv_shards=2, device="cpu",
                            mesh=cpu_mesh(2))
    with pytest.raises(IndexError):
        pool.cycle(prefill={"seq": 9, "vectors": _ones(4)},
                   read={"seq": 9, "positions": np.arange(99)})
    assert pool.home_of(9) is None
    assert not pool.home and not pool.tables and not pool.lengths
    assert len(pool.free_pages) == 8


def test_multi_admission_precheck_is_per_shard():
    pool = PagedPool.create(n_pages=8, page_tokens=4, word_width=8,
                            num_banks=4, kv_shards=2, device="cpu",
                            mesh=cpu_mesh(2))
    with pytest.raises(PoolCapacityError, match="never straddle"):
        pool.cycle(prefill=[{"seq": s, "vectors": _ones(12)}
                            for s in (5, 6, 7)])
    assert not pool.tables and not pool.lengths and not pool.home
    assert len(pool.free_pages) == 8
    pool.cycle(prefill=[{"seq": s, "vectors": _ones(12)} for s in (5, 6)])
    assert {pool.home_of(5), pool.home_of(6)} == {0, 1}


# ---- the sharded pool step against the unsharded one -------------------------

def _words(pool) -> torch.Tensor:
    return torch.cat(pool.storage) if pool.sharded else pool.storage


def _script(pool, rng) -> list:
    """A pool session touching every port, both hazard orders of a shared
    traversal, a copy-on-write through an attached prefix, the staging
    gather and a scrub; returns every read result and the storage after
    each step."""
    w = pool.io_width
    vec = lambda n: rng.normal(size=(n, w)).astype(np.float32)  # noqa: E731
    got = []

    def keep(res):
        reads = res["read"]
        if reads is not None:
            got.extend(reads if isinstance(reads, list) else [reads])
        got.append(_words(pool).clone())

    keep(pool.cycle(prefill=[{"seq": 1, "vectors": vec(10)},
                             {"seq": 2, "vectors": vec(7)},
                             {"seq": 3, "vectors": vec(5)}]))
    keep(pool.cycle(append=[{"seq": 1, "vectors": vec(1)},
                            {"seq": 2, "vectors": vec(1)}],
                    read=[{"seq": 1, "positions": np.arange(11)},
                          {"seq": 3, "positions": np.arange(5)}]))
    # reads serviced BEFORE this traversal's appends, then after
    for prio in ((1, 0, 3, 2), (0, 3, 2, 1)):
        keep(pool.cycle(append={"seq": 2, "vectors": vec(1)},
                        read={"seq": 2, "positions": np.arange(8)},
                        priority=prio))
    # a prefix shared by refcount, then written: copy-on-write
    pool.register_prefix(1, tuple(range(10)))
    match = pool.match_prefix(tuple(range(10)) + (77,))
    pool.attach_prefix(4, match)
    got.append(torch.from_numpy(pool.gather_words(4, np.arange(10))))
    keep(pool.cycle(append={"seq": 4, "vectors": vec(2)},
                    read={"seq": 4, "positions": np.arange(12)}))
    dead = pool.free(3)
    outs = pool.cycle_batch([
        ({"scrub": dead, "read": {"seq": 1, "positions": np.arange(11)}},
         None),
        ({"prefill": {"seq": 5, "vectors": vec(6)}}, (2, 0, 1, 3))])
    for res in outs:
        keep(res)
    return got


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_pool_step_equals_unsharded(n, use_kernel):
    """The same session on a pool sharded over n CPU shards and on the
    unsharded storage with the same control plane: every read and the
    storage (the shards joined) after every traversal are bit-identical,
    and so are the per-shard tile counters."""
    kw = dict(n_pages=64, page_tokens=4, word_width=6, num_banks=4,
              kv_shards=n, use_kernel=use_kernel, device="cpu")
    flat = PagedPool.create(**kw)
    sharded = PagedPool.create(mesh=cpu_mesh(n), **kw)
    assert sharded.sharded == (n > 1)
    a = _script(flat, np.random.default_rng(n))
    b = _script(sharded, np.random.default_rng(n))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert sharded.cow_copies == flat.cow_copies == 1
    for name in ("traversals", "tile_reads", "tile_writes",
                 "tile_reads_by_shard", "tile_writes_by_shard", "mix_counts"):
        assert getattr(sharded, name) == getattr(flat, name), name
    assert sharded.device == torch.device("cpu")


# ---- the fused kernels once per shard ----------------------------------------

def _decode_case(rng, b=8, s=32, hkv=2, g=2, d=8):
    lens = rng.integers(-1, s - 1, b).astype(np.int32)
    t = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.normal(size=sh).astype(np.float32))
    return (t(b, hkv * g, d), t(b, s, hkv, d), t(b, s, hkv, d), t(b, hkv, d),
            t(b, hkv, d), torch.from_numpy(lens))


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_decode_kernel_equals_unsharded(n, splits):
    """fused_decode_attention with a mesh == without, outputs and caches
    (updated in place); each shard's call returns its own rows' tile
    counts, joined in row order by shard_apply."""
    rng = np.random.default_rng(n + splits)
    args = _decode_case(rng)
    ref = tuple(a.clone() for a in args)
    kw = dict(seq_tile=8, dynamic_grid=True, num_kv_splits=splits)
    out, ck, cv = ops.fused_decode_attention(*args, mesh=cpu_mesh(n), **kw)
    want, rk, rv = ops.fused_decode_attention(*ref, **kw)
    assert ck is args[1] and cv is args[2]
    assert torch.equal(out, want)
    assert torch.equal(ck, rk) and torch.equal(cv, rv)
    fn = lambda *a: kvmp.fused_append_attend(  # noqa: E731
        *a, return_tiles=True, **kw)
    tiles = shard_apply(cpu_mesh(n), fn, *(a.clone() for a in ref))[3]
    assert torch.equal(tiles, fn(*(a.clone() for a in ref))[3])


def test_sharded_chunk_kernel_equals_unsharded():
    rng = np.random.default_rng(5)
    b, c, s, hkv, g, d = 4, 4, 32, 2, 2, 8
    t = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.normal(size=sh).astype(np.float32))
    offs = torch.tensor([0, -1, 9, 20], dtype=torch.int32)
    clen = torch.tensor([4, 0, 3, 4], dtype=torch.int32)
    args = (t(b, c, hkv * g, d), t(b, s, hkv, d), t(b, s, hkv, d),
            t(b, c, hkv, d), t(b, c, hkv, d), offs, clen)
    ref = tuple(a.clone() for a in args)
    got = ops.fused_prefill_chunk_attention(*args, seq_tile=8,
                                            dynamic_grid=True,
                                            mesh=cpu_mesh(2))
    want = ops.fused_prefill_chunk_attention(*ref, seq_tile=8,
                                             dynamic_grid=True)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match=r"batch \(4\) to divide across "
                                         r"the 8-way 'kv' axis"):
        ops.fused_prefill_chunk_attention(*ref, mesh=cpu_mesh(8))


# ---- the engine: tokens and per-device accounting ----------------------------

@pytest.fixture(scope="module")
def served():
    cfg_j = jreg.get("tinyllama-1.1b", reduced=True)
    cfg_t = treg.get("tinyllama-1.1b", reduced=True)
    params_j = j_init(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                                 "cpu")
    return cfg_j, cfg_t, params_j, params_t


VOCAB = treg.get("tinyllama-1.1b", reduced=True).vocab


def _prompts(seed: int, lens=None) -> list:
    """The JAX test's prompts: ``lens`` tokens each, or 5 prompts of 3-8."""
    rng = np.random.default_rng(seed)
    if lens is None:
        return [list(map(int, rng.integers(0, VOCAB,
                                           int(rng.integers(3, 9)))))
                for _ in range(5)]
    return [list(map(int, rng.integers(0, VOCAB, n))) for n in lens]


PROMPTS_GROW = _prompts(17)
PROMPTS_SPLIT = _prompts(23, (24, 3, 11, 5))
GROW = dict(slots=2, max_slots=8, max_len=64, chunk_tokens=8, seq_tile=8)
SPLIT = dict(slots=4, max_slots=8, max_len=64, chunk_tokens=8, seq_tile=8)


def _serve_grow(make):
    """The JAX test's mid-stream admission workload: 3 prompts, 3 cycles,
    2 more prompts, run to the end."""
    eng = make(**GROW)
    for p in PROMPTS_GROW[:3]:
        eng.submit(list(p), max_new=3)
    for _ in range(3):
        if eng.pending_work():
            eng.step()
    for p in PROMPTS_GROW[3:]:
        eng.submit(list(p), max_new=3)
    done = eng.run(max_cycles=1000)
    assert len(done) == len(PROMPTS_GROW)
    return eng, {r.rid: tuple(r.generated) for r in done}


def _serve_split(make, splits):
    eng = make(num_kv_splits=splits, **SPLIT)
    for p in PROMPTS_SPLIT:
        eng.submit(list(p), max_new=4)
    done = eng.run(max_cycles=1000)
    assert len(done) == len(PROMPTS_SPLIT)
    return eng, {r.rid: tuple(r.generated) for r in done}


def _port(served, mesh=None, mode="pallas"):
    _, cfg_t, _, params_t = served
    return lambda **kw: MultiPortEngine(params_t, cfg_t, kernel_mode=mode,
                                        mesh=mesh, device="cpu", **kw)


@pytest.fixture(scope="module")
def oracles(served):
    """The unsharded port and the JAX unsharded engine (its reference mode:
    tokens are identical across kernel modes) on both workloads."""
    cfg_j, _, params_j, _ = served
    jmake = lambda **kw: JEngine(params_j, cfg_j,  # noqa: E731
                                 kernel_mode="reference", **kw)
    grow_t = _serve_grow(_port(served))[1]
    split_t = _serve_split(_port(served), 1)[1]
    assert grow_t == _serve_grow(jmake)[1]
    assert split_t == _serve_split(jmake, 1)[1]
    return grow_t, split_t


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_engine_token_identical(served, oracles, n):
    """Greedy decode is token-identical across device counts and kernel
    modes — sharded fused vs sharded reference vs the unsharded port and
    JAX — with requests admitted mid-stream and the slot pool growing."""
    for mode in ("pallas", "reference"):
        eng, toks = _serve_grow(_port(served, cpu_mesh(n), mode))
        assert toks == oracles[0], mode
        assert eng.n_slots > 2, "slot pool must have grown"
        assert eng.n_kv_shards == n == eng.pool.kv_shards
        assert eng.pool.sharded == (n > 1)
        assert sum(eng.steady_decode_tile_reads_by_dev) == \
            eng.steady_decode_tile_reads
        assert sum(eng.prefill_tile_reads_by_dev) == eng.prefill_tile_reads
        assert eng.kv_tile_balance >= 1.0
        assert eng._service_status()["kv_shards"] == n


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_split_kv_token_identical(served, oracles, n):
    """Split-KV decode with both stages inside each shard's call stays
    token-identical to the unsharded serial oracle, and split counts never
    perturb the per-device tile accounting."""
    by_dev = None
    for splits in (1, 4):
        eng, toks = _serve_split(_port(served, cpu_mesh(n)), splits)
        assert toks == oracles[1], splits
        assert eng.n_kv_shards == n
        assert sum(eng.steady_decode_tile_reads_by_dev) == \
            eng.steady_decode_tile_reads
        by_dev = by_dev or eng.steady_decode_tile_reads_by_dev
        assert eng.steady_decode_tile_reads_by_dev == by_dev


def test_engine_refuses_a_mesh_without_the_axis(served):
    mesh = make_kv_mesh(2, axis="data", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="has no 'kv' axis"):
        _port(served, mesh)(**GROW)


def test_engine_and_pool_refuse_a_mesh_of_another_device_type(served):
    """The mesh does not decide where the work runs: a CPU engine refuses
    a mesh of cards, and a pool on the card a mesh of CPUs, before any
    storage is allocated."""
    cards = make_kv_mesh(2, devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="not all cpu devices"):
        _port(served, cards)(**GROW)
    with pytest.raises(ValueError, match="not all cuda devices"):
        PagedPool.create(n_pages=8, page_tokens=4, word_width=8,
                         mesh=cpu_mesh(2), device="cuda")


JAX_SHARDED = """
import json
import jax, numpy as np
from repro.configs import registry
from repro.launch.mesh import make_kv_mesh
from repro.models import init_params
from repro.serve.engine import MultiPortEngine

cfg = registry.get("tinyllama-1.1b", reduced=True)
params = init_params(jax.random.PRNGKey(0), cfg)
prompts = {prompts}
out = {{}}
for n in (2, 4):
    eng = MultiPortEngine(params, cfg, kernel_mode="reference",
                          mesh=make_kv_mesh(n), **{grow})
    for p in prompts[:3]:
        eng.submit(list(p), max_new=3)
    for _ in range(3):
        if eng.pending_work():
            eng.step()
    for p in prompts[3:]:
        eng.submit(list(p), max_new=3)
    done = eng.run(max_cycles=1000)
    out[n] = {{"tokens": {{r.rid: list(map(int, r.generated)) for r in done}},
              "steady": eng.steady_decode_tile_reads_by_dev,
              "decode": eng.decode_tile_reads_by_dev,
              "prefill": eng.prefill_tile_reads_by_dev,
              "balance": eng.kv_tile_balance,
              "traversals": eng.pool_traversals,
              "pool_reads": eng.pool.tile_reads_by_shard,
              "pool_writes": eng.pool.tile_writes_by_shard}}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_sharded():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    body = JAX_SHARDED.format(prompts=PROMPTS_GROW, grow=GROW)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("JSON"))
    return {int(k): v for k, v in json.loads(line[4:]).items()}


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_counters_equal_jax_sharded_engine(served, jax_sharded, n):
    """The JAX sharded engine (reference mode, 4 forced host devices) and
    the port's reference engine on an n-shard CPU mesh: the same tokens,
    per-device tile reads (steady, all decode, prefill), balance, pool
    traversals and per-shard pool tiles."""
    want = jax_sharded[n]
    eng, toks = _serve_grow(_port(served, cpu_mesh(n), "reference"))
    assert {rid: list(t) for rid, t in toks.items()} == \
        {int(k): v for k, v in want["tokens"].items()}
    assert eng.steady_decode_tile_reads_by_dev == want["steady"]
    assert eng.decode_tile_reads_by_dev == want["decode"]
    assert eng.prefill_tile_reads_by_dev == want["prefill"]
    assert eng.kv_tile_balance == want["balance"]
    assert eng.pool_traversals == want["traversals"]
    assert eng.pool.tile_reads_by_shard == want["pool_reads"]
    assert eng.pool.tile_writes_by_shard == want["pool_writes"]


def test_launcher_serves_over_a_given_mesh(capsys, monkeypatch):
    """``launch.serve.main --kv-shards 2`` over a 2-shard CPU mesh (given
    in place of the visible devices, of which the CPU has one): the banner
    and the ``kv shards:`` stats line, and the tokens of the unsharded
    run."""
    from repro_torch.launch import serve
    argv = ["--device", "cpu", "--requests", "3", "--max-new", "3"]
    flat = serve.main(argv)
    capsys.readouterr()
    monkeypatch.setattr(serve, "kv_mesh", lambda args: cpu_mesh(
        args.kv_shards))
    eng = serve.main(argv + ["--kv-shards", "2"])
    out = capsys.readouterr().out
    assert "data-parallel KV: pool sharded page-aligned over 2 devices" in out
    assert f"kv shards: 2 (pages/shard {eng.pool.plan.pages_per_shard}); " \
           f"steady decode tile reads by device " in out
    assert eng.n_kv_shards == 2
    assert {r.rid: r.generated for r in eng.finished} == \
        {r.rid: r.generated for r in flat.finished}
