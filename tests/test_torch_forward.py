"""The port's whole-prompt path (``forward``, ``prefill``) against the JAX
package's, with the JAX parameters bridged across (``params_from_numpy``)
at the reduced tinyllama-1.1b in f32.

Tolerances: one attention call agrees at the kernels' 1e-5; logits and
caches through the layers at 1e-4, as ``test_torch_models.py`` states (the
two frameworks sum each layer's products in a different order, and that
compounds); prefill + decode against forward inside the port at the JAX
suite's decode-equivalence tolerance, atol 3e-3 / rtol 1e-3
(``tests/models/test_decode_equiv.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro_torch import models as tm
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn

TOL = 1e-4
B, S, PREFIX = 2, 32, 16     # reduced q_chunk is 16: forward runs 2 chunks


@pytest.fixture(scope="module")
def bridged():
    cfg_j = jreg.get("tinyllama-1.1b", reduced=True)
    cfg_t = treg.get("tinyllama-1.1b", reduced=True)
    params_j = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree.map(np.asarray, params_j)
    return cfg_j, cfg_t, params_j, tm.params_from_numpy(tree, cfg_t, "cpu")


@pytest.fixture(scope="module")
def ids():
    cfg = treg.get("tinyllama-1.1b", reduced=True)
    return np.random.default_rng(5).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 4e-2)])
@pytest.mark.parametrize("s,q_chunk,g", [(32, 8, 4), (24, 1024, 1),
                                         (16, 16, 2)])
def test_chunked_causal_attention_matches_jax(rng, dt, tol, s, q_chunk, g):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    b, hkv, d = 2, 2, 16
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, s, hkv * g, d), (b, s, hkv, d), (b, s, hkv, d))]
    o_j = jattn.chunked_causal_attention(*(jnp.asarray(a, jd) for a in arrs),
                                         q_chunk=q_chunk)
    o_t = tattn.chunked_causal_attention(
        *(torch.from_numpy(a).to(td) for a in arrs), q_chunk=q_chunk)
    assert o_t.dtype == td and tuple(o_t.shape) == (b, s, hkv * g, d)
    _close(o_t, o_j, tol)


def test_chunked_causal_attention_needs_whole_chunks():
    q = torch.zeros(1, 24, 2, 8)
    k = torch.zeros(1, 24, 1, 8)
    with pytest.raises(AssertionError):
        tattn.chunked_causal_attention(q, k, k, q_chunk=16)


def test_forward_matches_jax(bridged, ids):
    cfg_j, cfg_t, params_j, params_t = bridged
    lj, aux_j = jm.forward(params_j, cfg_j, {"inputs": jnp.asarray(ids)})
    lt, aux_t = tm.forward(params_t, cfg_t, {"inputs": torch.from_numpy(ids)})
    assert tuple(lt.shape) == (B, S, cfg_t.vocab)
    _close(lt, lj)
    assert float(aux_t) == float(aux_j) == 0.0
    assert np.array_equal(lt.argmax(-1).numpy(), np.asarray(lj).argmax(-1))


def test_forward_takes_explicit_positions(bridged, ids):
    cfg_j, cfg_t, params_j, params_t = bridged
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None] + 7, (B, S))
    lj, _ = jm.forward(params_j, cfg_j, {"inputs": jnp.asarray(ids),
                                         "positions": jnp.asarray(pos)})
    lt, _ = tm.forward(params_t, cfg_t, {"inputs": torch.from_numpy(ids),
                                         "positions": torch.from_numpy(
                                             pos.copy())})
    _close(lt, lj)


def _zero_state(cfg, s_max):
    shape = (cfg.n_layers, B, s_max, cfg.n_kv_heads, cfg.head_dim_)
    js = {"len": jnp.zeros((B,), jnp.int32),
          "cache_k": jnp.zeros(shape, jnp.float32),
          "cache_v": jnp.zeros(shape, jnp.float32)}
    ts = {"len": torch.zeros((B,), dtype=torch.int32),
          "cache_k": torch.zeros(shape), "cache_v": torch.zeros(shape)}
    return js, ts


def test_prefill_matches_jax(bridged, ids):
    cfg_j, cfg_t, params_j, params_t = bridged
    js, ts = _zero_state(cfg_j, 40)
    prompt = ids[:, :PREFIX]
    jst, lj = jm.prefill(params_j, cfg_j, js, {"inputs": jnp.asarray(prompt)})
    tst, lt = tm.prefill(params_t, cfg_t, ts,
                         {"inputs": torch.from_numpy(prompt)})
    _close(lt, lj)
    _close(tst["cache_k"], jst["cache_k"])
    _close(tst["cache_v"], jst["cache_v"])
    assert tst["cache_k"] is ts["cache_k"]            # written in place
    assert not tst["cache_k"][:, :, PREFIX:].any()    # only [0, S)
    np.testing.assert_array_equal(tst["len"].numpy(), np.asarray(jst["len"]))


@pytest.mark.parametrize("mode", ["multiport", "reference"])
def test_prefill_then_decode_matches_forward(bridged, ids, mode):
    """prefill(prompt) + teacher-forced decode steps reproduce forward's
    logits at the next positions, in both kernel modes (as the JAX suite's
    ``test_prefill_then_decode_matches_forward``)."""
    _, cfg_t, _, params_t = bridged
    ids_t = torch.from_numpy(ids)
    logits, _ = tm.forward(params_t, cfg_t, {"inputs": ids_t})
    state = tm.init_decode_state(cfg_t, B, S, device="cpu")
    state, lg = tm.prefill(params_t, cfg_t, state,
                           {"inputs": ids_t[:, :PREFIX]})
    torch.testing.assert_close(lg, logits[:, PREFIX - 1], atol=3e-3,
                               rtol=1e-3)
    for t in range(PREFIX, S):
        state, lg = tm.decode_step(params_t, cfg_t, state,
                                   {"inputs": ids_t[:, t:t + 1]},
                                   kernel_mode=mode, seq_tile=8)
        torch.testing.assert_close(lg, logits[:, t], atol=3e-3, rtol=1e-3)
        assert torch.equal(lg.argmax(-1), logits[:, t].argmax(-1))
    assert state["len"].tolist() == [S] * B


@pytest.mark.parametrize("arch,reduced", [("rwkv6-3b", True),
                                          ("zamba2-7b", True),
                                          ("zamba2-7b", False)])
def test_ssm_and_hybrid_families_run_through_the_entry_points(arch, reduced):
    """The ssm and hybrid families (ROADMAP A9b, ported): ``prefill_chunk``
    raises the JAX package's "chunked prefill serves KV-cache families"
    before any work, and ``forward``, ``prefill`` and ``decode_step`` run
    and give logits of the config's vocab, at the published widths too
    (on the meta device: shapes without memory)."""
    cfg = treg.get(arch, reduced=reduced)
    dev = "cpu" if reduced else "meta"
    batch = {"inputs": torch.zeros((1, 4), dtype=torch.int64, device=dev),
             "chunk_len": torch.ones((1,), dtype=torch.int32, device=dev)}
    with pytest.raises(NotImplementedError,
                       match="chunked prefill serves KV-cache families"):
        tm.prefill_chunk({}, cfg, {}, batch)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    logits, aux = tm.forward(params, cfg, batch)
    assert tuple(logits.shape) == (1, 4, cfg.vocab) and aux.shape == ()
    state = tm.init_decode_state(cfg, 1, 8, dev)
    state, lg = tm.prefill(params, cfg, state, batch)
    state, lg2 = tm.decode_step(params, cfg, state,
                                {"inputs": batch["inputs"][:, :1]})
    assert tuple(lg.shape) == tuple(lg2.shape) == (1, cfg.vocab)
    if reduced:
        assert state["len"].tolist() == [5]
        assert bool(torch.isfinite(lg2).all())


def test_hybrid_forward_with_mrope_positions_matches_jax():
    """The hybrid family's ``forward`` with explicit M-RoPE (t, h, w)
    positions matches the JAX package's (the shared block rotates by
    them; M-RoPE itself is held in ``test_torch_families.py``)."""
    cfg_j, cfg_t = (dataclasses.replace(reg.get("zamba2-7b", reduced=True),
                                        pos_embed="mrope",
                                        mrope_sections=(4, 2, 2))
                    for reg in (jreg, treg))
    params_j = jm.init_params(jax.random.PRNGKey(3), cfg_j)
    params_t = tm.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    cfg_t, "cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(0, cfg_j.vocab, (2, 16)).astype(np.int32)
    h, w = np.divmod(np.arange(16), 4)
    pos = np.broadcast_to(np.stack([np.arange(16), h, w], -1),
                          (2, 16, 3)).astype(np.int32)
    lj, _ = jm.forward(params_j, cfg_j, {"inputs": jnp.asarray(ids),
                                         "positions": jnp.asarray(pos)})
    lt, _ = tm.forward(params_t, cfg_t, {
        "inputs": torch.from_numpy(ids),
        "positions": torch.from_numpy(np.ascontiguousarray(pos))})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL,
                               rtol=TOL)
    plain, _ = tm.forward(params_t, cfg_t, {"inputs": torch.from_numpy(ids)})
    assert not torch.equal(plain, lt)
