"""The port's chunked linear attention (``models/linear_scan.py``) against
the JAX package's on the same numpy-drawn inputs: the per-channel path
with and without the RWKV bonus, the scalar-decay (SSD) path, and the
decode step; chunk 2-64 and T 1-40 (off the chunk too), with and without
an initial state. f32 at rtol 1e-5 and atol 1e-5 of the output's largest
|value| (an output element is a sum of terms of either sign, up to tens
here: against an f64 run both packages are off by up to 1e-5 of that
scale, each in its own summation order); bf16 inputs at 2e-2 of the
output's scale (both sides round the scores and the output to bf16, in
sums taken in another order). Then the mirrors of
``tests/models/test_linear_scan.py`` on the port alone: chunked equals
stepwise, a state carried across a split, and a decay of -30 stays
finite.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linear_scan as jls
from repro_torch.models import linear_scan as tls

hp = pytest.importorskip(
    "hypothesis", reason="property tests need the 'dev' extra")
import hypothesis.strategies as st  # noqa: E402

TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _draw(rng, b, t, h, kd, vd, scalar=False, init=False, bonus=False):
    lw_shape = (b, t, h) if scalar else (b, t, h, kd)
    return {"q": rng.normal(size=(b, t, h, kd)).astype(np.float32),
            "k": rng.normal(size=(b, t, h, kd)).astype(np.float32),
            "v": rng.normal(size=(b, t, h, vd)).astype(np.float32),
            "lw": (-np.abs(rng.normal(size=lw_shape)) * 2).astype(np.float32),
            "u": (rng.normal(size=(h, kd)).astype(np.float32)
                  if bonus else None),
            "s0": (rng.normal(size=(b, h, kd, vd)).astype(np.float32)
                   if init else None)}


def _both(x, dtype="float32"):
    """(jax array, torch tensor) of a numpy array in ``dtype``, or Nones."""
    if x is None:
        return None, None
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return j, t


def _run(d, chunk, scalar, dtype="float32"):
    (qj, qt), (kj, kt), (vj, vt) = (_both(d[n], dtype) for n in "qkv")
    lwj, lwt = _both(d["lw"])
    uj, ut = _both(d["u"])
    sj, st_ = _both(d["s0"])
    yj, fj = jls.chunked_linear_attention(qj, kj, vj, lwj, chunk=chunk,
                                          bonus_u=uj, initial_state=sj,
                                          scalar_decay=scalar)
    yt, ft = tls.chunked_linear_attention(qt, kt, vt, lwt, chunk=chunk,
                                          bonus_u=ut, initial_state=st_,
                                          scalar_decay=scalar)
    return (np.asarray(yj.astype(jnp.float32)), np.asarray(fj),
            yt.float().numpy(), ft.numpy(), yt.dtype, ft.dtype)


def _close(got, want, tol=TOL):
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("path", ["channel", "bonus", "scalar"])
@pytest.mark.parametrize("t,chunk", [(1, 2), (7, 4), (16, 8), (23, 8),
                                     (40, 16), (33, 64), (40, 2)])
@pytest.mark.parametrize("init", [False, True])
def test_chunked_matches_jax(rng, path, t, chunk, init):
    d = _draw(rng, 2, t, 3, 4, 5, scalar=path == "scalar", init=init,
              bonus=path == "bonus")
    yj, fj, yt, ft, ydt, fdt = _run(d, chunk, path == "scalar")
    assert ydt == torch.float32 and fdt == torch.float32
    assert yt.shape == (2, t, 3, 5) and ft.shape == (2, 3, 4, 5)
    _close(yt, yj)
    _close(ft, fj)


@pytest.mark.parametrize("path", ["channel", "bonus", "scalar"])
def test_chunked_bf16_matches_jax(rng, path):
    """bf16 q, k, v (log_w f32): y stays bf16, the state f32."""
    d = _draw(rng, 2, 21, 2, 8, 8, scalar=path == "scalar", init=True,
              bonus=path == "bonus")
    yj, fj, yt, ft, ydt, fdt = _run(d, 8, path == "scalar", "bfloat16")
    assert ydt == torch.bfloat16 and fdt == torch.float32
    _close(yt, yj, BF16_TOL)
    _close(ft, fj, BF16_TOL)


@pytest.mark.parametrize("bonus", [False, True])
def test_step_matches_jax(rng, bonus):
    b, h, kd, vd = 3, 2, 4, 5
    q, k, lw = (rng.normal(size=(b, h, kd)).astype(np.float32)
                for _ in range(3))
    lw = -np.abs(lw)
    v = rng.normal(size=(b, h, vd)).astype(np.float32)
    s0 = rng.normal(size=(b, h, kd, vd)).astype(np.float32)
    u = rng.normal(size=(h, kd)).astype(np.float32) if bonus else None
    yj, sj = jls.linear_attention_step(*map(jnp.asarray, (q, k, v, lw, s0)),
                                       bonus_u=None if u is None
                                       else jnp.asarray(u))
    yt, stt = tls.linear_attention_step(
        *map(torch.from_numpy, (q, k, v, lw, s0)),
        bonus_u=None if u is None else torch.from_numpy(u))
    _close(yt.numpy(), np.asarray(yj))
    _close(stt.numpy(), np.asarray(sj))


# ---- the mirrors of tests/models/test_linear_scan.py, on the port --------

def _stepwise(q, k, v, lw, bonus):
    b, t, h, kd = q.shape
    state = torch.zeros((b, h, kd, v.shape[-1]))
    ys = []
    for i in range(t):
        y, state = tls.linear_attention_step(q[:, i], k[:, i], v[:, i],
                                             lw[:, i], state, bonus_u=bonus)
        ys.append(y)
    return torch.stack(ys, 1), state


@hp.given(t=st.integers(1, 40), chunk=st.sampled_from([2, 4, 8, 16, 64]),
          use_bonus=st.booleans(), seed=st.integers(0, 2**16))
@hp.settings(max_examples=30, deadline=None)
def test_chunked_equals_stepwise(t, chunk, use_bonus, seed):
    d = _draw(np.random.default_rng(seed), 2, t, 2, 4, 3, bonus=use_bonus)
    q, k, v, lw = (torch.from_numpy(d[n]) for n in ("q", "k", "v", "lw"))
    u = None if d["u"] is None else torch.from_numpy(d["u"])
    yc, sc = tls.chunked_linear_attention(q, k, v, lw, chunk=chunk,
                                          bonus_u=u)
    yr, sr = _stepwise(q, k, v, lw, u)
    torch.testing.assert_close(yc, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(sc, sr, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("scalar", [False, True])
def test_initial_state_threading(scalar):
    """Splitting a sequence in two with the state carried == one pass."""
    d = _draw(np.random.default_rng(0), 1, 24, 2, 4, 4, scalar=scalar)
    q, k, v, lw = (torch.from_numpy(d[n]) for n in ("q", "k", "v", "lw"))
    kw = dict(chunk=8, scalar_decay=scalar)
    y_full, s_full = tls.chunked_linear_attention(q, k, v, lw, **kw)
    y1, s1 = tls.chunked_linear_attention(q[:, :10], k[:, :10], v[:, :10],
                                          lw[:, :10], **kw)
    y2, s2 = tls.chunked_linear_attention(q[:, 10:], k[:, 10:], v[:, 10:],
                                          lw[:, 10:], initial_state=s1, **kw)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(s2, s_full, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("scalar", [False, True])
def test_strong_decay_no_overflow(scalar):
    """log_w = -30 everywhere: no inf or nan (the masked pairwise decay
    never forms exp(+cum))."""
    d = _draw(np.random.default_rng(1), 1, 32, 1, 4, 4, scalar=scalar)
    q, k, v = (torch.from_numpy(d[n]) for n in "qkv")
    lw = torch.full(d["lw"].shape, -30.0)
    y, s = tls.chunked_linear_attention(q, k, v, lw, chunk=16,
                                        scalar_decay=scalar)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
