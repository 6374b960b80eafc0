"""The port's shape-only stand-ins (``repro_torch.launch.specs``) against
the JAX package's ``launch/specs.py``: every batch builder for every
architecture and shape cell, the paged pool's stand-in against the pool
the port allocates over a kv mesh, and the split-KV intermediates against
the buffers the port's split path makes. Counterpart of
tests/kernels/test_split_kv.py:103,
tests/distributed/test_paged_sharding.py:164 and
tests/serve/test_chunked_prefill.py:68."""
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import specs as JSP
from repro.launch.mesh import make_kv_mesh as j_kv_mesh
from repro_torch.configs import registry as treg
from repro_torch.configs.base import applicable_shapes
from repro_torch.kernels import kv_multiport as kvmp
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_kv_mesh
from repro_torch.memory.paged_kv import PagedPool

CASES = [(a, r) for a in treg.ARCH_IDS for r in (True, False)]


def _same(t: torch.Tensor, j) -> bool:
    """A meta stand-in and a JAX ShapeDtypeStruct of one shape and dtype."""
    return (t.device.type == "meta" and tuple(t.shape) == tuple(j.shape)
            and str(t.dtype).removeprefix("torch.") == np.dtype(j.dtype).name)


def test_sds_is_a_meta_tensor():
    s = SP.sds((2, 3), torch.bfloat16)
    assert s.device.type == "meta"
    assert tuple(s.shape) == (2, 3) and s.dtype == torch.bfloat16


@pytest.mark.parametrize("arch,reduced", CASES)
def test_input_specs_match_jax(arch, reduced):
    tcfg, jcfg = treg.get(arch, reduced=reduced), jreg.get(arch,
                                                          reduced=reduced)
    for cell in applicable_shapes(tcfg):
        got, want = SP.input_specs(tcfg, cell), JSP.input_specs(jcfg, cell)
        assert sorted(got) == sorted(want), cell
        assert all(_same(got[k], want[k]) for k in want), cell


@pytest.mark.parametrize("arch,reduced", CASES)
def test_prefill_chunk_specs_match_jax(arch, reduced):
    tcfg, jcfg = treg.get(arch, reduced=reduced), jreg.get(arch,
                                                          reduced=reduced)
    if jcfg.input_mode != "tokens":
        for fn, cfg in ((SP.prefill_chunk_specs, tcfg),
                        (JSP.prefill_chunk_specs, jcfg)):
            with pytest.raises(NotImplementedError,
                               match="chunked prefill serves token models"):
                fn(cfg, 4, 8)
        return
    got, want = SP.prefill_chunk_specs(tcfg, 4, 8), \
        JSP.prefill_chunk_specs(jcfg, 4, 8)
    assert sorted(got) == sorted(want)
    assert all(_same(got[k], want[k]) for k in want)


def test_prefill_chunk_specs_match_model_contract():
    """Zeros of the stand-ins' shapes drive the port's ``prefill_chunk``
    (the serving engine's admission compute)."""
    from repro_torch import tree as T
    from repro_torch.models import prefill_chunk
    cfg = treg.get("tinyllama-1.1b", reduced=True)

    def zeros(tree):
        return T.tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype), tree)
    state = zeros(SP.decode_state_shapes(cfg, 4, 64))
    out, logits = prefill_chunk(zeros(SP.params_shapes(cfg)), cfg, state,
                                zeros(SP.prefill_chunk_specs(cfg, 4, 8)))
    assert tuple(logits.shape) == (4, cfg.vocab)
    assert out["cache_k"].shape == state["cache_k"].shape


def test_kv_pool_specs_match_the_pool_on_a_kv_mesh():
    """10 pages of 8 tokens over 4 shards round up to 12 pages: the
    stand-in's words and plan are the pool's, each shard holding
    ``words_per_shard`` rows of the unpadded word."""
    mesh = make_kv_mesh(4, devices=["cpu"] * 4)
    sds, plan = SP.kv_pool_specs(mesh, n_pages=10, page_tokens=8,
                                 word_width=24)
    pool = PagedPool.create(n_pages=10, page_tokens=8, word_width=24,
                            mesh=mesh, device="cpu")
    assert plan == pool.plan and plan.n_pages == 12
    assert sds.device.type == "meta" and sds.dtype == torch.float32
    assert tuple(sds.shape) == (pool.spec.num_words, 24) == (96, 24)
    assert [tuple(s.shape) for s in pool.storage] == \
        [(plan.words_per_shard, 24)] * 4
    assert all(s.dtype == sds.dtype for s in pool.storage)


def test_kv_pool_specs_agree_with_jax_and_raise_as_it_does():
    """On one shard the JAX stand-in has the same words (its word is lane
    padded, the port's is not) and a ``P("kv", None)`` sharding; both
    refuse a mesh without the axis, and the page checks of
    ``kv_pool_spec`` raise alike."""
    from repro.distributed.sharding import kv_pool_spec as j_pool_spec
    from repro_torch.distributed.sharding import kv_pool_spec
    sds, plan = SP.kv_pool_specs(make_kv_mesh(1, devices=["cpu"]),
                                 n_pages=10, page_tokens=8, word_width=24)
    jmesh = j_kv_mesh(1)
    jsds, jsharding = JSP.kv_pool_specs(jmesh, n_pages=10, page_tokens=8,
                                        word_width=24)
    assert sds.shape[0] == jsds.shape[0] and plan.n_shards == 1
    assert tuple(jsharding.spec) == ("kv", None)
    with pytest.raises(KeyError):
        SP.kv_pool_specs(make_kv_mesh(1, devices=["cpu"]), n_pages=10,
                         page_tokens=8, word_width=24, axis="model")
    with pytest.raises(KeyError):
        JSP.kv_pool_specs(jmesh, n_pages=10, page_tokens=8, word_width=24,
                          axis="model")
    tmesh = make_kv_mesh(1, devices=["cpu"])
    for kw, match in ((dict(num_words=96, page_tokens=5), "straddles a page"),
                      (dict(num_words=96, page_tokens=8, axis="model"),
                       "no 'model' axis")):
        for fn, m in ((kv_pool_spec, tmesh), (j_pool_spec, jmesh)):
            with pytest.raises(ValueError, match=match):
                fn(m, **kw)


@pytest.mark.parametrize("ns", [1, 2, 4, 8])
def test_kv_split_partial_specs_match_the_split_buffers(ns):
    """The stage-1 outputs of the port's split path, f32 whatever q's
    dtype, at reduced tinyllama's heads; JAX's carry the same banks on a
    lane-padded layout."""
    from repro.kernels.tiling import SUBLANE, word_pad
    cfg = treg.get("tinyllama-1.1b", reduced=True)
    b, s, d = 3, 32, cfg.head_dim_
    specs = SP.kv_split_partial_specs(cfg, b, ns)
    g = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(g.normal(size=shape).astype(np.float32))
    acc, stats, _ = kvmp.split_partials_plain(
        t(b, cfg.n_heads, d).to(torch.bfloat16), t(b, s, cfg.n_kv_heads, d),
        t(b, s, cfg.n_kv_heads, d), t(b, cfg.n_kv_heads, d),
        t(b, cfg.n_kv_heads, d), torch.tensor([0, 9, 31]), seq_tile=8,
        n_tiles=4, length_mask=True, num_kv_splits=ns)
    for name, buf in (("acc_partial", acc), ("lse_partial", stats)):
        assert specs[name].device.type == "meta"
        assert tuple(specs[name].shape) == tuple(buf.shape)
        assert specs[name].dtype == buf.dtype == torch.float32
    assert kvmp.split_partial_shapes(b, cfg.n_heads, d, ns) == \
        (tuple(acc.shape), tuple(stats.shape))
    jspecs = JSP.kv_split_partial_specs(jreg.get("tinyllama-1.1b",
                                                 reduced=True), b, ns)
    hp = word_pad(cfg.n_heads, SUBLANE)
    assert jspecs["acc_partial"].shape == (b, acc.shape[1] * hp,
                                           word_pad(d))
