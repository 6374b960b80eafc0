"""The port's kernel functions against the JAX package's Pallas kernels.

On the CPU each wrapper in ``repro_torch.kernels`` runs its kernel's plain
torch version; the same inputs, drawn with numpy, go through the JAX kernel
in interpret mode. Outputs agree at the JAX suite's tolerances (f32 1e-5,
bf16 4e-2: ``tests/kernels/test_attention_kernels.py``), cache updates are
identical, and the serviced-tile counts are equal. The CUDA kernels
themselves are held against their plain versions on the card by
``test_torch_cuda.py``.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_multiport as jkvmp
from repro.kernels import kv_prefill_chunk as jkvpc
from repro.kernels import ref as jref
from repro.kernels import tiling as jtiling
from repro_torch.kernels import kv_multiport as kvmp
from repro_torch.kernels import kv_prefill_chunk as kvpc
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tiling

F32_TOL, BF16_TOL = 1e-5, 4e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dt: str = "f32"):
    """The same values as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dt]
    return jnp.asarray(x, jd), torch.from_numpy(np.asarray(x)).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _decode_case(rng, b, s, hkv, g, d, lens, qdt="f32", cdt="f32"):
    h = hkv * g
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, h, d), (b, s, hkv, d), (b, s, hkv, d),
                       (b, hkv, d), (b, hkv, d))]
    q = _pair(arrs[0], qdt)
    rest = [_pair(a, cdt) for a in arrs[1:]]
    lens = _pair(np.asarray(lens, np.int32))
    lens = (lens[0].astype(jnp.int32), lens[1].to(torch.int32))
    return [q] + rest + [lens]


def _check_decode(case, tol, **kw):
    (jq, tq), (jck, tck), (jcv, tcv), (jnk, tnk), (jnv, tnv), (jl, tl) = case
    jo, jck2, jcv2, jt = jkvmp.fused_append_attend(
        jq, jck, jcv, jnk, jnv, jl, return_tiles=True, interpret=True, **kw)
    tck, tcv = tck.clone(), tcv.clone()
    to, tck2, tcv2, tt = kvmp.fused_append_attend(
        tq, tck, tcv, tnk, tnv, tl, return_tiles=True, **kw)
    assert tck2 is tck and tcv2 is tcv                  # updated in place
    np.testing.assert_allclose(_np(to), _np(jo), atol=tol, rtol=tol)
    np.testing.assert_array_equal(_np(tck), _np(jck2))
    np.testing.assert_array_equal(_np(tcv), _np(jcv2))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("b,s,hkv,g,d,tile", [
    (1, 128, 1, 1, 16, 64),
    (2, 256, 2, 4, 32, 64),
    (3, 128, 4, 2, 64, 128),
])
@pytest.mark.parametrize("qdt,cdt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("bf16", "f32")])
def test_decode_sweep(rng, b, s, hkv, g, d, tile, qdt, cdt):
    lens = rng.integers(0, s - 1, b)
    lens[0] = -1 if b > 1 else lens[0]                  # a dead row
    tol = F32_TOL if qdt == cdt == "f32" else BF16_TOL
    _check_decode(_decode_case(rng, b, s, hkv, g, d, lens, qdt, cdt), tol,
                  seq_tile=tile)


@pytest.mark.parametrize("mode", [
    dict(),
    dict(length_mask=False),
    dict(dynamic_grid=True),
    dict(live_len=48),
    dict(live_len=96, length_mask=False),
])
def test_decode_edges_dead_rows_and_bounds(rng, mode):
    """Appends at 0 and at the tile edges k*T-1, k*T, k*T+1, a dead row,
    the static live-prefix bound and the unbounded comparator."""
    tile = 16
    lens = [0, tile - 1, tile, tile + 1, 2 * tile - 1, -1, 40]
    _check_decode(_decode_case(rng, len(lens), 128, 2, 2, 16, lens),
                  F32_TOL, seq_tile=tile, **mode)


@pytest.mark.parametrize("s,tile", [(100, 64), (63, 32), (33, 8), (24, 128)])
def test_decode_odd_capacity(rng, s, tile):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")                 # the clamp warns
        _check_decode(_decode_case(rng, 2, s, 2, 2, 16, [0, s - 1]),
                      F32_TOL, seq_tile=tile)


def _chunk_case(rng, b, c, s, hkv, g, d, off=None, cl=None, qdt="f32",
                cdt="f32"):
    h = hkv * g
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, c, h, d), (b, s, hkv, d), (b, s, hkv, d),
                       (b, c, hkv, d), (b, c, hkv, d))]
    if off is None:
        off = rng.integers(0, s - c + 1, b)
    if cl is None:
        cl = rng.integers(0, c + 1, b)
    ints = [_pair(np.asarray(x, np.int32)) for x in (off, cl)]
    ints = [(j.astype(jnp.int32), t.to(torch.int32)) for j, t in ints]
    return ([_pair(arrs[0], qdt)] + [_pair(a, cdt) for a in arrs[1:]]
            + ints)


def _check_chunk(case, tol, **kw):
    ((jq, tq), (jck, tck), (jcv, tcv), (jnk, tnk), (jnv, tnv), (jo_, to_),
     (jc, tc)) = case
    jo, jck2, jcv2, jt = jkvpc.fused_chunk_append_attend(
        jq, jck, jcv, jnk, jnv, jo_, jc, return_tiles=True, interpret=True,
        **kw)
    tck, tcv = tck.clone(), tcv.clone()
    to, tck2, tcv2, tt = kvpc.fused_chunk_append_attend(
        tq, tck, tcv, tnk, tnv, to_, tc, return_tiles=True, **kw)
    assert tck2 is tck and tcv2 is tcv
    np.testing.assert_allclose(_np(to), _np(jo), atol=tol, rtol=tol)
    np.testing.assert_array_equal(_np(tck), _np(jck2))
    np.testing.assert_array_equal(_np(tcv), _np(jcv2))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("b,c,s,hkv,g,d,tile", [
    (1, 4, 32, 1, 1, 16, 8),
    (2, 8, 64, 2, 2, 16, 16),
    (3, 4, 33, 1, 2, 8, 8),       # S_max not a tile multiple
    (2, 5, 50, 2, 1, 16, 16),
])
def test_chunk_sweep(rng, b, c, s, hkv, g, d, tile):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _check_chunk(_chunk_case(rng, b, c, s, hkv, g, d), 2e-5,
                     seq_tile=tile)


@pytest.mark.parametrize("mode", [dict(), dict(dynamic_grid=True),
                                  dict(live_len=32)])
def test_chunk_edges_dead_rows_and_bounds(rng, mode):
    """Offsets at 0 and at tile edges, an empty chunk, a dead row."""
    tile = 8
    off = [0, tile - 1, tile, tile + 1, -1, 3]
    cl = [4, 4, 1, 3, 0, 0]
    _check_chunk(_chunk_case(rng, len(off), 4, 64, 2, 2, 16, off, cl),
                 2e-5, seq_tile=tile, **mode)


@pytest.mark.parametrize("qdt,cdt", [("bf16", "f32"), ("bf16", "bf16")])
def test_chunk_bf16(rng, qdt, cdt):
    _check_chunk(_chunk_case(rng, 2, 8, 64, 2, 4, 32, qdt=qdt, cdt=cdt),
                 BF16_TOL, seq_tile=16)


def test_ref_oracles_match_jax(rng):
    """The two-pass oracles (reference mode and the w+r degrade path)."""
    case = _decode_case(rng, 3, 64, 2, 2, 16, [0, 17, 63])
    (jq, tq), (jck, tck), (jcv, tcv), (jnk, tnk), (jnv, tnv), (jl, tl) = case
    jr = jref.decode_attention_ref(jq, jck, jcv, jnk, jnv, jl)
    tr = tref.decode_attention_ref(tq, tck, tcv, tnk, tnv, tl)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(_np(a), _np(b), atol=F32_TOL, rtol=F32_TOL)
    # a dead row (-1) appends at the LAST cache position in both oracles
    case = _decode_case(rng, 2, 32, 2, 2, 16, [5, -1])
    jr = jref.decode_attention_ref(*[j for j, _ in case])
    tr = tref.decode_attention_ref(*[t for _, t in case])
    np.testing.assert_allclose(_np(tr[0])[0], _np(jr[0])[0], atol=F32_TOL,
                               rtol=F32_TOL)
    for a, b, new in zip(tr[1:], jr[1:], (case[3][1], case[4][1])):
        np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(_np(a)[1, -1], _np(new)[1])
    case = _chunk_case(rng, 3, 4, 32, 2, 2, 16, off=[0, 5, 28], cl=[4, 2, 4])
    args_j = [j for j, _ in case]
    args_t = [t for _, t in case]
    jr = jref.prefill_chunk_attention_ref(*args_j)
    tr = tref.prefill_chunk_attention_ref(*args_t)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(_np(a), _np(b), atol=F32_TOL, rtol=F32_TOL)


def test_tiling_helpers_match_jax():
    for tile in (1, 7, 8, 64):
        for n in range(0, 200, 3):
            assert tiling.live_tile_bound(n, tile) == \
                jtiling.live_tile_bound(n, tile)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for s in (1, 24, 33, 64, 88, 97, 128):
            for t in (1, 8, 16, 60, 64, 128, 256):
                assert tiling.fit_seq_tile(s, t) == jtiling.fit_seq_tile(s, t)
                assert tiling.clamp_seq_tile(s, t) == \
                    jtiling.clamp_seq_tile(s, t)


def test_clamp_seq_tile_warns_once():
    tiling._fit_warned.clear()
    with pytest.warns(UserWarning, match="exceeds the traversed capacity"):
        assert tiling.clamp_seq_tile(24, 128) == 24
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tiling.clamp_seq_tile(24, 128) == 24
        assert tiling.fit_seq_tile(64, 16) == 16


def test_cuda_wrappers_refuse_unsupported_inputs():
    """A wrapper never falls back: an unsupported tensor on a non-CPU
    device raises before any launch (here: the meta device)."""
    q = torch.empty((1, 2, 16), device="meta")
    c = torch.empty((1, 8, 1, 16), device="meta")
    n = torch.empty((1, 1, 16), device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kvmp.fused_append_attend(q.half(), c, c, n, n, lens, seq_tile=8)

