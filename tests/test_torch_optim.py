"""The port's optimizers, schedules and gradient compression against the
JAX package's, fed the same numpy-drawn parameters and gradients:

* ``warmup_cosine`` and ``constant`` on a grid of steps (rtol 1e-6);
* adamw (f32 params; bf16 params with and without ``master_weights``),
  adamw8bit and adafactor over 5 updates: params and f32 states within
  1e-6 (bf16 params: equal bits);
* the 8-bit codes by the tie rule: ``_quantize`` rounds (log10(a) + 7) /
  7 * levels, and XLA's and torch's log10 may differ in the last bit, so a
  code may differ where that value lies within 1e-5 of a half-integer,
  and there by one; everywhere else the codes are equal;
* ``compressed_mean_pods`` at 1, 2 and 4 pods: codes exact (both divide by
  the same f32 scale), mean and residual within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adafactor as jadaf
from repro.optim import adamw as jadamw
from repro.optim import quantized as jq
from repro.optim import schedules as jsched
from repro_torch import tree as T
from repro_torch.distributed import compression as tcomp
from repro_torch.optim import AdamWConfig, make_optimizer
from repro_torch.optim import quantized as tq
from repro_torch.optim import schedules as tsched

TOL = 1e-6
TIE = 1e-5          # the tie window of the 8-bit codes, in code units
SHAPES = {"w": (32, 16), "b": (16,), "stack": (3, 8, 70), "e": (5, 130)}


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tree_to_torch(tree):
    return jax.tree.map(_to_torch, tree)


def _draws(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", k))]
    return tree


def _pre_round(x: np.ndarray, signed: bool) -> np.ndarray:
    """The value ``_quantize`` rounds, in f64, blocked as there."""
    x = np.asarray(x, np.float64)
    if x.ndim == 0:
        x = x[None]
    pad = (-x.shape[-1]) % tq.BLOCK
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    blocks = x.reshape(*x.shape[:-1], -1, tq.BLOCK)
    scale = np.abs(blocks).max(-1, keepdims=True)
    a = np.abs(blocks) / np.maximum(scale, 1e-30)
    levels = 127.0 if signed else 255.0
    return (np.log10(np.maximum(a, 1e-7)) + 7.0) / 7.0 * levels


def _assert_codes(got: torch.Tensor, want, x: np.ndarray, signed: bool):
    """Codes equal, or one apart where the rounded value is a tie."""
    got = got.numpy().astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    diff = got != want
    if diff.any():
        pre = _pre_round(x, signed)
        near = np.abs(pre - np.floor(pre) - 0.5) < TIE
        assert np.all(near[diff]), "a code differs away from a tie"
        assert np.all(np.abs(got - want)[diff] == 1)


# ---- schedules -----------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(warmup_steps=10, total_steps=100),
                                dict(warmup_steps=0, total_steps=7),
                                dict(warmup_steps=5, total_steps=5,
                                     min_ratio=0.3)])
def test_warmup_cosine_matches_jax(kw):
    steps = np.arange(0, 130, dtype=np.int32)
    got = tsched.warmup_cosine(torch.from_numpy(steps), peak_lr=3e-4, **kw)
    want = jsched.warmup_cosine(jnp.asarray(steps), peak_lr=3e-4, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=1e-12)
    one = tsched.warmup_cosine(torch.tensor(12, dtype=torch.int32),
                               peak_lr=3e-4, **kw)
    assert one.shape == () and float(one) == pytest.approx(float(want[12]),
                                                           rel=TOL)


def test_constant_matches_jax():
    got = tsched.constant(torch.arange(4), peak_lr=0.5)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsched.constant(jnp.arange(4),
                                                             peak_lr=0.5)))
    assert got.dtype == torch.float32


# ---- the optimizers ------------------------------------------------------

OPT = {"adamw": (jadamw.adamw_init, jadamw.adamw_update),
       "adamw8bit": (jq.adamw8bit_init, jq.adamw8bit_update),
       "adafactor": (jadaf.adafactor_init, jadaf.adafactor_update)}


def _close_states(st, sj):
    """Every leaf of a JAX tree without 8-bit codes: f32 within TOL, bf16
    and the integer step equal."""
    for path, want in jax.tree_util.tree_flatten_with_path(sj)[0]:
        got = _leaf(st, path)
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16),
                                          err_msg=jax.tree_util.keystr(path))
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                       atol=TOL * max(np.abs(want).max(), 1),
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name,dtype,master", [
    ("adamw", "float32", False), ("adamw", "bfloat16", False),
    ("adamw", "bfloat16", True), ("adafactor", "float32", False),
    ("adafactor", "bfloat16", False)])
def test_optimizer_matches_jax_over_five_updates(name, dtype, master):
    """Free-running: each side feeds its own state back, the same numpy
    grads in."""
    jcfg = JAdamW(weight_decay=0.1, master_weights=master)
    tcfg = AdamWConfig(weight_decay=0.1, master_weights=master)
    pj = jax.tree.map(lambda a: jnp.asarray(a, dtype), _draws(0))
    pt = _tree_to_torch(pj)
    init_j, upd_j = OPT[name]
    init_t, upd_t, _ = make_optimizer(name, tcfg)
    sj, st = init_j(pj, jcfg), init_t(pt)
    _close_states(st, sj)
    for i in range(5):
        g = jax.tree.map(lambda a: jnp.asarray(a, dtype), _draws(10 + i, 0.1))
        lr = 1e-2 * (i + 1)
        pj, sj, mj = upd_j(g, sj, pj, lr, jcfg)
        pt, st, mt = upd_t(_tree_to_torch(g), st, pt, lr)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=TOL)
        _close_states(pt, pj)
        _close_states(st, sj)
    assert int(st["step"]) == 5


def test_adamw8bit_matches_jax_over_five_updates():
    """Each update starts from the JAX state (converted), so a code at a
    tie does not carry into the next update's moments; codes by the tie
    rule, scales and params within 1e-6."""
    jcfg, tcfg = JAdamW(), AdamWConfig()
    pj = jax.tree.map(jnp.asarray, _draws(0))
    sj = jq.adamw8bit_init(pj, jcfg)
    _, upd_t, _ = make_optimizer("adamw8bit", tcfg)
    for i in range(5):
        g = jax.tree.map(jnp.asarray, _draws(10 + i, 0.1))
        pt, st, mt = upd_t(_tree_to_torch(g), _tree_to_torch(sj),
                           _tree_to_torch(pj), 1e-2)
        # the f32 moments both sides quantize, from the JAX side's inputs
        gc, _ = jadamw.clip_by_global_norm(g, jcfg.grad_clip)
        moments = {k: {"m": jcfg.b1 * jq._dequantize(sj["m"][k], s)
                       + (1 - jcfg.b1) * gc[k],
                       "v": jcfg.b2 * jq._dequantize(sj["v"][k], s)
                       + (1 - jcfg.b2) * jnp.square(gc[k])}
                   for k, s in SHAPES.items()}
        pj, sj, mj = jq.adamw8bit_update(g, sj, pj, 1e-2, jcfg)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=TOL)
        _close_states(pt, pj)
        for part in ("m", "v"):
            for k in SHAPES:
                _assert_codes(st[part][k]["q"], sj[part][k]["q"],
                              np.asarray(moments[k][part]),
                              signed=part == "m")
                np.testing.assert_allclose(
                    st[part][k]["scale"].numpy(),
                    np.asarray(sj[part][k]["scale"]), rtol=TOL)
        assert int(st["step"]) == i + 1


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("shape", [(1024,), (3, 100), (2, 4, 64), ()])
def test_quantize_codes_and_dequantize_match_jax(signed, shape):
    """Magnitudes over 9 decades (some below the 7-decade floor, which code
    to 0), zeros, and rows off the block of 64."""
    rng = np.random.default_rng(hash((signed, shape)) % 2 ** 32)
    n = int(np.prod(shape))
    x = (rng.uniform(0.3, 1.0, n) * 10.0 ** rng.integers(-8, 1, n))
    if signed:
        x *= np.where(rng.random(n) < 0.5, -1, 1)
    x[rng.random(n) < 0.05] = 0.0
    x = x.astype(np.float32).reshape(shape)
    qj = jq._quantize(jnp.asarray(x), signed)
    qt = tq._quantize(torch.from_numpy(x), signed)
    assert qt["q"].dtype == (torch.int8 if signed else torch.uint8)
    _assert_codes(qt["q"], qj["q"], x, signed)
    np.testing.assert_array_equal(qt["scale"].numpy(), np.asarray(qj["scale"]))
    qt_from_j = {"q": _to_torch(qj["q"]), "scale": _to_torch(qj["scale"])}
    np.testing.assert_allclose(tq._dequantize(qt_from_j, shape).numpy(),
                               np.asarray(jq._dequantize(qj, shape)),
                               rtol=TOL, atol=0)


def test_adafactor_factors_stacked_leaves_over_the_last_two_axes():
    p = {k: torch.zeros(s) for k, s in SHAPES.items()}
    st = make_optimizer("adafactor")[0](p)
    assert tuple(st["v"]["stack"]["vr"].shape) == (3, 8)
    assert tuple(st["v"]["stack"]["vc"].shape) == (3, 70)
    assert tuple(st["v"]["b"]["v"].shape) == (16,)


# ---- gradient compression -------------------------------------------------

def _jax_codes(g, ef):
    """The int8 codes and scale of the JAX package's
    ``compressed_mean_pods``, step for step."""
    n_pods = g.shape[0]
    blocks, _ = jcomp._blockify(g.astype(jnp.float32) + ef)
    qmax = 127 >> max(0, int(np.ceil(np.log2(max(n_pods, 1)))))
    scale = jnp.maximum(jnp.max(jnp.max(jnp.abs(blocks), axis=-1,
                                        keepdims=True), axis=0,
                                keepdims=True) / qmax, 1e-30)
    q = jnp.clip(jnp.round(blocks / scale), -qmax, qmax).astype(jnp.int8)
    return np.asarray(q), np.asarray(scale)


@pytest.mark.parametrize("n_pods", [1, 2, 4])
@pytest.mark.parametrize("shape", [(300,), (16, 70), (3, 8, 64)])
def test_compressed_mean_pods_matches_jax(n_pods, shape):
    rng = np.random.default_rng(n_pods * 100 + len(shape))
    g = rng.normal(size=(n_pods, *shape)).astype(np.float32)
    ef = (rng.normal(size=(n_pods, *shape)) * 0.01).astype(np.float32)
    mj, rj = jcomp.compressed_mean_pods(jnp.asarray(g), jnp.asarray(ef))
    mt, rt = tcomp.compressed_mean_pods(torch.from_numpy(g),
                                        torch.from_numpy(ef))
    _, qt, st, _ = tcomp.quantize_pods(torch.from_numpy(g),
                                       torch.from_numpy(ef))
    qj, sj = _jax_codes(jnp.asarray(g), jnp.asarray(ef))
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy(), sj)
    assert int(qt.abs().max()) <= 127 >> int(np.ceil(np.log2(n_pods)))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=TOL,
                               atol=TOL)
    assert mt.shape == shape and rt.shape == g.shape


def test_compressed_mean_tree_and_ef_state():
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    ef = tcomp.init_ef_state(params, 2)
    assert all(tuple(e.shape) == (2, *SHAPES[k]) for k, e in ef.items())
    rng = np.random.default_rng(5)
    g = {k: torch.from_numpy(rng.normal(size=(2, *s)).astype(np.float32))
         for k, s in SHAPES.items()}
    mean, new_ef = tcomp.compressed_mean_tree(g, ef)
    mj, ej = jcomp.compressed_mean_tree(jax.tree.map(lambda t: t.numpy(), g),
                                        jax.tree.map(lambda t: t.numpy(), ef))
    for k in SHAPES:
        np.testing.assert_allclose(mean[k].numpy(), np.asarray(mj[k]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(new_ef[k].numpy(), np.asarray(ej[k]),
                                   rtol=TOL, atol=TOL)
    assert [p for p, _ in T.leaves_with_path(mean)] == sorted(
        (k,) for k in SHAPES)
