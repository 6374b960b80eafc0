"""The port's flash attention (B5) against the JAX package's.

On the CPU ``repro_torch.kernels.ops.flash_attention`` runs the kernel's
plain torch version (``flash_attention_plain``); the same numpy-drawn inputs
go through the JAX Pallas kernel in interpret mode (as
``tests/kernels/test_attention_kernels.py`` runs it) and the JAX oracle
``ref.attention_ref``. Tolerances are that suite's: f32 2e-5, bf16 5e-2.
The CUDA kernel itself is held against the plain version on the card by
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_TOL, BF16_TOL = 2e-5, 5e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(rng, b, h, hkv, sq, sk, d, dt="f32"):
    """q, k, v as JAX arrays and torch CPU tensors holding the same values."""
    jd, td = DTYPES[dt]
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _check(rng, b, h, hkv, sq, sk, d, qt, kt, causal, dt="f32"):
    (jq, jk, jv), (tq, tk, tv) = _case(rng, b, h, hkv, sq, sk, d, dt)
    tol = F32_TOL if dt == "f32" else BF16_TOL
    o_pallas = jops.flash_attention(jq, jk, jv, causal=causal, q_tile=qt,
                                    k_tile=kt)
    o_ref = jref.attention_ref(jq, jk, jv, causal=causal)
    before = launch_counts()["flash_attention"]
    o_ops = tops.flash_attention(tq, tk, tv, causal=causal, q_tile=qt,
                                 k_tile=kt)
    assert launch_counts()["flash_attention"] == before  # CPU: no launch
    o_plain = fa.flash_attention_plain(tq, tk, tv, causal=causal)
    assert o_ops.dtype == o_plain.dtype == tq.dtype
    assert tuple(o_ops.shape) == (b, h, sq, d)
    for o in (o_ops, o_plain):
        _close(o, o_pallas, tol)
        _close(o, o_ref, tol)


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,qt,kt", [
    (1, 2, 1, 128, 128, 32, 64, 64),
    (2, 4, 2, 128, 128, 64, 128, 64),
    (1, 8, 8, 256, 256, 16, 64, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sweep_matches_jax(rng, b, h, hkv, sq, sk, d, qt, kt,
                                           causal):
    """The shapes of the JAX suite's ``test_flash_attention_sweep``."""
    _check(rng, b, h, hkv, sq, sk, d, qt, kt, causal)


def test_flash_attention_bf16_matches_jax(rng):
    """The case of the JAX suite's ``test_flash_attention_bf16``."""
    _check(rng, 1, 4, 2, 128, 128, 32, 64, 64, True, "bf16")


@pytest.mark.parametrize("sq,sk", [(64, 128), (128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sq_ne_sk_is_top_left_aligned(rng, sq, sk, causal):
    """Sq != Sk in both directions: the causal mask is qpos >= kpos with
    both counted from 0, as in the Pallas kernel."""
    _check(rng, 2, 4, 2, sq, sk, 32, 32, 64, causal)


def test_flash_attention_top_left_mask_by_hand():
    """Query row i sees exactly keys 0..i: with v = one-hot positions, the
    output row i is spread over its first i + 1 entries only."""
    sq, sk = 4, 8
    q = torch.zeros(1, 1, sq, sk)
    k = torch.zeros(1, 1, sk, sk)
    v = torch.eye(sk)[None, None]
    out = tops.flash_attention(q, k, v, causal=True)[0, 0]
    want = torch.tril(torch.ones(sq, sk)) / torch.arange(1, sq + 1)[:, None]
    torch.testing.assert_close(out, want, atol=1e-7, rtol=0)


def test_flash_attention_tiles_clamp_to_the_sequence(rng):
    """q_tile/k_tile above Sq/Sk clamp to them, as in JAX."""
    _check(rng, 1, 4, 2, 64, 96, 32, 256, 512, True)


@pytest.mark.parametrize("shape,tiles", [
    (((1, 4, 96, 16), (1, 2, 96, 16)), dict(q_tile=64, k_tile=32)),
    (((1, 4, 64, 16), (1, 2, 96, 16)), dict(q_tile=64, k_tile=64)),
    (((1, 6, 64, 16), (1, 4, 64, 16)), dict()),
])
def test_flash_attention_rejects_bad_shapes(shape, tiles):
    """A sequence not a multiple of its tile, or H not a multiple of Hkv,
    raises ValueError before anything runs."""
    qs, ks = shape
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, k.clone(), **tiles)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention_ref_matches_jax(rng, causal, dt):
    (jq, jk, jv), (tq, tk, tv) = _case(rng, 2, 8, 2, 64, 96, 16, dt)
    o_t = tref.attention_ref(tq, tk, tv, causal=causal)
    assert o_t.dtype == tq.dtype
    tol = F32_TOL if dt == "f32" else BF16_TOL
    _close(o_t, jref.attention_ref(jq, jk, jv, causal=causal), tol)
