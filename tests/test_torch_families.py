"""The port's MoE, VLM and audio models against the JAX package's, with the
JAX parameters bridged across (``params_from_numpy``), at the reduced
deepseek-moe-16b, llama4-scout-17b-a16e, qwen2-vl-7b (M-RoPE, embedding
input) and musicgen-large (sinusoidal positions, embedding input), in f32:
``forward`` (logits and the MoE aux loss), ``prefill``, ``decode_step`` and
``prefill_chunk`` agree at 1e-4 in both kernel modes, as the dense model
does (``test_torch_models.py``: the two frameworks sum each layer's products
in another order, and that compounds through the layers).

The position layers alone agree at 1e-6: ``mrope_apply`` with distinct
(t, h, w) streams, ``sinusoidal_positions`` at offsets 0-12 and per-row
offsets. Past that the two libraries' ``exp`` (1 ulp apart on some of the
frequencies) moves an angle by up to ``pos * 2**-23``; the large-offset case
holds the port to that bound.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import registry as jreg
from repro.models import layers as jl
from repro_torch import models as tm
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tl
from repro_torch.models import mlp as tmlp

TOL = 1e-4
ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "qwen2-vl-7b",
         "musicgen-large"]
MODES = ["multiport", "reference"]


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    cfg_j = jreg.get(request.param, reduced=True)
    cfg_t = treg.get(request.param, reduced=True)
    params_j = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree.map(np.asarray, params_j)
    return cfg_j, cfg_t, params_j, tm.params_from_numpy(tree, cfg_t, "cpu")


def _inputs(rng, cfg, b, s):
    """Token ids, or embeddings for the embedding-input stubs."""
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _state(rng, cfg, b, s, lens):
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim_)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    (jk, tk), (jv, tv), (jn, tn) = _pair(ck), _pair(cv), _pair(lens)
    return ({"len": jn, "cache_k": jk, "cache_v": jv},
            {"len": tn, "cache_k": tk, "cache_v": tv})


def _grid_positions(b, s, cfg):
    """Distinct (t, h, w) streams for an M-RoPE model: a 4 x 4 patch grid
    at t = 0 after a text run, each row shifted; [B, S] text positions
    otherwise."""
    if cfg.pos_embed != "mrope":
        return np.broadcast_to(np.arange(s, dtype=np.int32) + 3, (b, s))
    pos = np.repeat(np.arange(s, dtype=np.int32)[:, None], 3, axis=1)
    grid = min(16, s - 2)
    pos[2:2 + grid, 0] = 2
    pos[2:2 + grid, 1] = 2 + np.arange(grid) // 4
    pos[2:2 + grid, 2] = 2 + np.arange(grid) % 4
    return np.stack([pos + r for r in range(b)])


# ---- the position layers --------------------------------------------------

@pytest.mark.parametrize("sections,d,theta", [((4, 2, 2), 16, 1e4),
                                              ((16, 24, 24), 128, 1e6)])
def test_mrope_apply_matches_jax(rng, sections, d, theta):
    x = rng.normal(size=(2, 12, 3, d)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 12, 3)).astype(np.int32)
    (jx, tx), (jp, tp) = _pair(x), _pair(pos)
    j = jl.mrope_apply(jx, jp, sections, theta)
    t = tl.mrope_apply(tx, tp, sections, theta)
    _close(t, j, 1e-6)
    # one stream alone moves only its own section's pairs
    moved = pos.copy()
    moved[..., 1] += 5
    t2 = tl.mrope_apply(tx, torch.from_numpy(moved), sections, theta)
    changed = (t2 != t).any(dim=(0, 1, 2)).numpy()
    h0, h1 = sections[0], sections[0] + sections[1]
    half = d // 2
    assert not changed[:h0].any() and changed[h0:h1].all()
    assert not changed[h1:half].any() and changed[half + h0:half + h1].all()
    # and text positions broadcast to three streams give rope
    text = np.repeat(pos[..., :1], 3, axis=-1)
    torch.testing.assert_close(
        tl.mrope_apply(tx, torch.from_numpy(text), sections, theta),
        tl.rope_apply(tx, torch.from_numpy(pos[..., 0].copy()), theta))


def test_mrope_apply_refuses_sections_off_the_head_dim():
    with pytest.raises(ValueError, match="sum"):
        tl.mrope_apply(torch.zeros(1, 2, 1, 16), torch.zeros(1, 2, 3),
                       (4, 2, 1))


@pytest.mark.parametrize("s,d,offset", [(16, 64, 0), (8, 64, 5),
                                        (13, 2048, 0), (1, 2048, 12)])
def test_sinusoidal_positions_match_jax(s, d, offset):
    j = jl.sinusoidal_positions(s, d, offset)
    t = tl.sinusoidal_positions(s, d, offset, "cpu")
    assert tuple(t.shape) == (s, d) and t.dtype == torch.float32
    _close(t, j, 1e-6)
    # [sin | cos]: position 0 gives zeros, then ones
    if offset == 0:
        assert not t[0, :d // 2].any() and bool((t[0, d // 2:] == 1).all())


def test_sinusoidal_positions_per_row_offsets_match_jax():
    offs = np.array([0, 3, 12, 7], np.int32)
    j = jax.vmap(lambda o: jl.sinusoidal_positions(1, 64, o))(
        jnp.asarray(offs))
    t = tl.sinusoidal_positions(1, 64, torch.from_numpy(offs))
    assert tuple(t.shape) == (4, 1, 64)
    _close(t, j, 1e-6)
    _close(t[2], tl.sinusoidal_positions(1, 64, 12, "cpu"), 0)


def test_sinusoidal_positions_at_large_offsets_within_the_exp_bound():
    s, d, offset = 8, 2048, 2040
    j = np.asarray(jl.sinusoidal_positions(s, d, offset))
    t = tl.sinusoidal_positions(s, d, offset, "cpu").numpy()
    pos = np.arange(s) + offset
    bound = pos[:, None] * 2.0 ** -23 + 2.0 ** -22         # [S, 1]
    assert (np.abs(t - j) <= bound).all()


# ---- the model entry points ------------------------------------------------

B, S = 2, 16


def test_forward_matches_jax(bridged, rng):
    cfg_j, cfg_t, params_j, params_t = bridged
    jx, tx = _pair(_inputs(rng, cfg_j, B, S))
    lj, aux_j = jm.forward(params_j, cfg_j, {"inputs": jx})
    lt, aux_t = tm.forward(params_t, cfg_t, {"inputs": tx})
    assert tuple(lt.shape) == (B, S, cfg_t.vocab)
    _close(lt, lj)
    _close(aux_t, aux_j, 1e-5)
    assert (float(aux_t) > 0) == (cfg_t.moe is not None)
    jp, tp = _pair(_grid_positions(B, S, cfg_j))
    lj, _ = jm.forward(params_j, cfg_j, {"inputs": jx, "positions": jp})
    lt, _ = tm.forward(params_t, cfg_t, {"inputs": tx, "positions": tp})
    _close(lt, lj)


def test_prefill_matches_jax(bridged, rng):
    cfg_j, cfg_t, params_j, params_t = bridged
    jx, tx = _pair(_inputs(rng, cfg_j, B, S))
    js, ts = _state(rng, cfg_j, B, S + 8, [0] * B)
    batch_j, batch_t = {"inputs": jx}, {"inputs": tx}
    if cfg_j.pos_embed == "mrope":
        batch_j["positions"], batch_t["positions"] = \
            _pair(_grid_positions(B, S, cfg_j))
    jst, lj = jm.prefill(params_j, cfg_j, js, batch_j)
    tst, lt = tm.prefill(params_t, cfg_t, ts, batch_t)
    _close(lt, lj)
    _close(tst["cache_k"], jst["cache_k"])
    _close(tst["cache_v"], jst["cache_v"])
    assert tst["cache_k"] is ts["cache_k"]
    np.testing.assert_array_equal(tst["len"].numpy(), np.asarray(jst["len"]))


@pytest.mark.parametrize("mode", MODES)
def test_decode_step_matches_jax(bridged, rng, mode):
    cfg_j, cfg_t, params_j, params_t = bridged
    lens = [0, 7, 30] if mode == "reference" else [0, 7, -1]
    js, ts = _state(rng, cfg_j, 3, 32, lens)
    jx, tx = _pair(_inputs(rng, cfg_j, 3, 1))
    kw = dict(kernel_mode=mode, seq_tile=8, dynamic_grid=mode == "multiport")
    jst, jl_ = jm.decode_step(params_j, cfg_j, js, {"inputs": jx}, **kw)
    tst, tl_ = tm.decode_step(params_t, cfg_t, ts, {"inputs": tx}, **kw)
    live = np.asarray(lens) >= 0
    _close(tl_[live], np.asarray(jl_)[live])
    _close(tst["cache_k"], jst["cache_k"])
    _close(tst["cache_v"], jst["cache_v"])
    np.testing.assert_array_equal(tst["len"].numpy(), np.asarray(jst["len"]))
    assert np.array_equal(tl_[live].argmax(-1).numpy(),
                          np.asarray(jl_)[live].argmax(-1))


@pytest.mark.parametrize("mode", MODES)
def test_prefill_chunk_matches_jax(bridged, rng, mode):
    cfg_j, cfg_t, params_j, params_t = bridged
    offs = [0, 5, 16] if mode == "reference" else [0, 5, -1]
    clen = np.asarray([8, 3, 0 if mode == "multiport" else 8], np.int32)
    js, ts = _state(rng, cfg_j, 3, 32, offs)
    jx, tx = _pair(_inputs(rng, cfg_j, 3, 8))
    (jc, tc) = _pair(clen)
    jst, lj = jm.prefill_chunk(params_j, cfg_j, js,
                               {"inputs": jx, "chunk_len": jc},
                               kernel_mode=mode, seq_tile=8)
    tst, lt = tm.prefill_chunk(params_t, cfg_t, ts,
                               {"inputs": tx, "chunk_len": tc},
                               kernel_mode=mode, seq_tile=8)
    live = np.asarray(offs) >= 0
    _close(lt[live], np.asarray(lj)[live])
    _close(tst["cache_k"], jst["cache_k"])
    _close(tst["cache_v"], jst["cache_v"])
    np.testing.assert_array_equal(tst["len"].numpy(), np.asarray(jst["len"]))


def test_prefill_then_decode_matches_forward(bridged, rng):
    """Inside the port: prefill + teacher-forced fused decode reproduce
    forward at the next positions (the JAX suite's decode-equivalence
    tolerance, atol 3e-3 / rtol 1e-3) — text positions, so M-RoPE's three
    streams move together and the audio stem's sinusoid follows each row's
    length. The MoE configs run at capacity factor 4, which drops no slot
    (a drop depends on which tokens share a call, as in the JAX suite's
    ``test_decode_equiv.py``)."""
    _, cfg_t, _, params_t = bridged
    if cfg_t.moe is not None:
        cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(
            cfg_t.moe, capacity_factor=4.0))
    x = torch.from_numpy(_inputs(rng, cfg_t, B, S))
    logits, _ = tm.forward(params_t, cfg_t, {"inputs": x})
    state = tm.init_decode_state(cfg_t, B, S, device="cpu")
    state, lg = tm.prefill(params_t, cfg_t, state, {"inputs": x[:, :8]})
    torch.testing.assert_close(lg, logits[:, 7], atol=3e-3, rtol=1e-3)
    for t in range(8, S):
        state, lg = tm.decode_step(params_t, cfg_t, state,
                                   {"inputs": x[:, t:t + 1]},
                                   kernel_mode="multiport", seq_tile=8)
        torch.testing.assert_close(lg, logits[:, t], atol=3e-3, rtol=1e-3)


def test_only_forward_computes_the_moe_aux_loss(bridged, rng, monkeypatch):
    """The serving steps (prefill, prefill_chunk, decode_step) drop the
    router's aux loss, so they never compute it; forward computes it once a
    layer on an MoE model."""
    _, cfg_t, _, params_t = bridged
    calls = []
    aux = tmlp.moe_aux
    monkeypatch.setattr(tmlp, "moe_aux",
                        lambda *a: calls.append(1) or aux(*a))
    x = torch.from_numpy(_inputs(rng, cfg_t, B, S))
    state = tm.init_decode_state(cfg_t, B, S + 8, device="cpu")
    state, _ = tm.prefill(params_t, cfg_t, state, {"inputs": x[:, :8]})
    state, _ = tm.prefill_chunk(
        params_t, cfg_t, state,
        {"inputs": x[:, 8:12], "chunk_len": torch.tensor([4, 4])},
        kernel_mode="multiport", seq_tile=8)
    tm.decode_step(params_t, cfg_t, state, {"inputs": x[:, 12:13]},
                   kernel_mode="multiport", seq_tile=8)
    assert not calls
    tm.forward(params_t, cfg_t, {"inputs": x})
    assert len(calls) == (cfg_t.n_layers if cfg_t.moe else 0)


def test_embedding_models_have_no_token_table(bridged):
    cfg_j, cfg_t, params_j, params_t = bridged
    own = tm.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    tokens = cfg_t.input_mode == "tokens"
    assert ("embed" in own) == ("embed" in params_t) == tokens
    assert math.isclose(float(own["final_norm"]["scale"].mean()), 1.0)
