"""The port's dense model against the JAX package's, with the JAX
parameters bridged across (``params_from_numpy``): decode_step and
prefill_chunk logits and caches agree in f32 at 1e-4 — looser than a single
kernel's 1e-5 because the two frameworks sum each layer's products in a
different order, and that difference compounds through the layers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import registry as jreg
from repro_torch import models as tm
from repro_torch import tree as T
from repro_torch.configs import registry as treg

TOL = 1e-4


@pytest.fixture(scope="module")
def bridged():
    cfg_j = jreg.get("tinyllama-1.1b", reduced=True)
    cfg_t = treg.get("tinyllama-1.1b", reduced=True)
    params_j = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree.map(np.asarray, params_j)
    return cfg_j, cfg_t, params_j, tm.params_from_numpy(tree, cfg_t, "cpu")


def _state(rng, cfg, b, s, lens):
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim_)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    js = {"len": jnp.asarray(lens), "cache_k": jnp.asarray(ck),
          "cache_v": jnp.asarray(cv)}
    ts = {"len": torch.from_numpy(lens), "cache_k": torch.from_numpy(ck.copy()),
          "cache_v": torch.from_numpy(cv.copy())}
    return js, ts


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def test_param_tree_matches_jax_shapes_and_dtypes(bridged):
    cfg_j, cfg_t, params_j, params_t = bridged
    own = tm.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(params_j)[0]
    for path, leaf in flat_j:
        keys = [k.key for k in path]
        t_b, t_o = params_t, own
        for k in keys:
            t_b, t_o = t_b[k], t_o[k]
        assert tuple(t_b.shape) == tuple(leaf.shape) == tuple(t_o.shape), keys
        np.testing.assert_array_equal(t_b.numpy(), np.asarray(leaf))
        assert t_o.dtype == t_b.dtype == torch.float32


def test_own_init_distributions():
    cfg = treg.get("tinyllama-1.1b", reduced=True)
    p = tm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert abs(float(p["embed"]["w"].std()) - 1.0) < 0.05
    wq = p["layers"]["attn"]["wq"]["w"]                     # [L, d, H*hd]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))


def test_bf16_leaves_bridge_bit_exact():
    cfg_j = dataclasses.replace(jreg.get("tinyllama-1.1b", reduced=True),
                                param_dtype="bfloat16")
    cfg_t = dataclasses.replace(treg.get("tinyllama-1.1b", reduced=True),
                                param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(2),
                                                   cfg_j))
    got = tm.params_from_numpy(tree, cfg_t, "cpu")
    w = tree["lm_head"]["w"]
    assert got["lm_head"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["lm_head"]["w"].view(torch.int16).numpy(),
                                  w.view(np.int16))


@pytest.mark.parametrize("mode", ["multiport", "reference"])
def test_decode_step_matches_jax(bridged, rng, mode):
    cfg_j, cfg_t, params_j, params_t = bridged
    b, s, tile = 4, 32, 8
    lens = [0, 7, 8, 30] if mode == "reference" else [0, 7, -1, 30]
    js, ts = _state(rng, cfg_j, b, s, lens)
    ids = rng.integers(0, cfg_j.vocab, (b, 1)).astype(np.int32)
    jst, jl = jm.decode_step(params_j, cfg_j, js, {"inputs": jnp.asarray(ids)},
                             kernel_mode=mode, seq_tile=tile,
                             dynamic_grid=mode == "multiport")
    tst, tl = tm.decode_step(params_t, cfg_t, ts,
                             {"inputs": torch.from_numpy(ids)},
                             kernel_mode=mode, seq_tile=tile,
                             dynamic_grid=mode == "multiport")
    live = np.asarray(lens) >= 0
    _close(tl[live], np.asarray(jl)[live])
    _close(tst["cache_k"], jst["cache_k"])
    _close(tst["cache_v"], jst["cache_v"])
    assert tst["cache_k"] is ts["cache_k"]            # updated in place
    np.testing.assert_array_equal(tst["len"].numpy(), np.asarray(jst["len"]))
    assert np.array_equal(tl[live].argmax(-1).numpy(),
                          np.asarray(jl)[live].argmax(-1))


@pytest.mark.parametrize("mode", ["multiport", "reference"])
def test_prefill_chunk_matches_jax(bridged, rng, mode):
    cfg_j, cfg_t, params_j, params_t = bridged
    b, s, c, tile = 3, 32, 8, 8
    offs = [0, 5, 16] if mode == "reference" else [0, 5, -1]
    clen = np.asarray([8, 3, 0 if mode == "multiport" else 8], np.int32)
    js, ts = _state(rng, cfg_j, b, s, offs)
    ids = rng.integers(0, cfg_j.vocab, (b, c)).astype(np.int32)
    jst, jl = jm.prefill_chunk(params_j, cfg_j, js,
                               {"inputs": jnp.asarray(ids),
                                "chunk_len": jnp.asarray(clen)},
                               kernel_mode=mode, seq_tile=tile)
    tst, tl = tm.prefill_chunk(params_t, cfg_t, ts,
                               {"inputs": torch.from_numpy(ids),
                                "chunk_len": torch.from_numpy(clen)},
                               kernel_mode=mode, seq_tile=tile)
    live = np.asarray(offs) >= 0
    _close(tl[live], np.asarray(jl)[live])
    _close(tst["cache_k"], jst["cache_k"])
    _close(tst["cache_v"], jst["cache_v"])
    np.testing.assert_array_equal(tst["len"].numpy(), np.asarray(jst["len"]))


def test_non_dense_families_raise():
    """The families without a KV cache (ROADMAP A9b, ported): the own
    ``init_params`` and ``init_decode_state`` of reduced rwkv6-3b and
    zamba2-7b give the JAX package's trees, key for key, in shapes and
    dtypes. (The published configs: ``test_torch_ssm.py``.)"""
    for arch in ("rwkv6-3b", "zamba2-7b"):
        cfg_j, cfg = jreg.get(arch, reduced=True), treg.get(arch, reduced=True)
        trees = {"params": (jm.init_params(jax.random.PRNGKey(0), cfg_j),
                            tm.init_params(cfg, torch.Generator(), "cpu")),
                 "state": (jm.init_decode_state(cfg_j, 2, 8),
                           tm.init_decode_state(cfg, 2, 8, "cpu"))}
        for what, (tj, tt) in trees.items():
            flat = jax.tree_util.tree_flatten_with_path(tj)[0]
            n = 0
            for path, leaf in flat:
                got = tt
                for k in path:
                    got = got[k.key]
                assert tuple(got.shape) == tuple(leaf.shape), (arch, path)
                assert str(got.dtype).split(".")[-1] == str(leaf.dtype), \
                    (arch, path)
                n += 1
            assert n == len(T.leaves(tt)), (arch, what)
