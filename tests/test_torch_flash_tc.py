"""The tensor-core route of the port's flash attention (B5), checked on the
CPU: the route choice, the host-side mirror of the kernel's tiling, and the
plain version against the JAX Pallas kernel (interpret mode) at the
head layout the tensor-core kernel must also get right (G = 7, D = 128,
Sq != Sk). The kernel itself is held against the plain version on the card
by ``test_torch_cuda.py``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops as tops

F32_TOL, BF16_TOL = 2e-5, 5e-2      # the JAX suite's flash tolerances
SMEM_LIMIT = 232448                 # an H100 block's dynamic shared memory
TC_SOURCE = (Path(fa.__file__).resolve().parent.parent / "csrc"
             / "flash_attention_tc.cu")

f32, bf16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("qdt,kdt,d,want", [
    (bf16, bf16, 64, "tc"), (bf16, bf16, 128, "tc"), (bf16, bf16, 16, "tc"),
    (bf16, bf16, 48, "tc"), (bf16, bf16, 8, "tc"),
    (bf16, bf16, 12, "f32"),        # not a multiple of 8: no 16-byte rows
    (bf16, bf16, 136, "f32"),       # past the 128 the kernel tiles
    (f32, f32, 64, "f32"),          # f32 stays off TF32
    (bf16, f32, 64, "f32"), (f32, bf16, 64, "f32"),
])
def test_route_is_chosen_from_dtypes_and_head_dim(qdt, kdt, d, want):
    assert fa.route(qdt, kdt, d) == want


@pytest.mark.parametrize("d,padded,block_k", [
    (16, 64, 128), (48, 64, 128), (64, 64, 128), (128, 128, 64)])
def test_tc_geometry(d, padded, block_k):
    """D pads to 64 or 128 (TMA's zero fill), one 64-column box per 128-byte
    swizzle atom, and the ring fits a block's shared memory."""
    g = fa.tc_geometry(d)
    assert g["padded_d"] == padded and g["block_k"] == block_k
    assert g["atoms"] * 64 == padded and g["block_q"] == 64
    assert g["box_q"] == (64, 64) and g["box_kv"] == (64, block_k)
    assert g["stages"] >= 2
    tiles = 2 * (g["block_q"] * padded
                 + 2 * g["stages"] * block_k * padded)   # bf16 bytes
    assert g["smem_bytes"] == 1024 + tiles + 8 * (2 * g["stages"] + 1)
    assert g["smem_bytes"] <= SMEM_LIMIT
    # every tile region starts on the 1024-byte swizzle period
    assert (g["block_q"] * 128) % 1024 == 0 and (block_k * 128) % 1024 == 0


@pytest.mark.parametrize("d", [0, 129])
def test_tc_geometry_rejects_head_dims_it_cannot_tile(d):
    with pytest.raises(ValueError):
        fa.tc_geometry(d)


def test_tc_geometry_mirrors_the_source():
    """The Python mirror and the CUDA source name the same tiles."""
    src = TC_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("BM") == fa.TC_BLOCK_Q
    assert const("STAGES") == fa.TC_STAGES
    assert const("ATOM_COLS") == fa.TC_ATOM_COLS
    assert "BN = DP == 64 ? 128 : 64" in src
    assert "wgmma.mma_async" in src and "cp.async.bulk.tensor" in src


def _case(rng, b, h, hkv, sq, sk, d, dt):
    jd, td = {"f32": (jnp.float32, f32), "bf16": (jnp.bfloat16, bf16)}[dt]
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


@pytest.mark.parametrize("sq,sk", [(128, 64), (64, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_pallas_at_g7_d128(rng, sq, sk, causal, dt):
    """qwen2-vl-7b's head layout (G = 7, D = 128), Sq != Sk both ways: the
    plain version and the CPU route of ``ops.flash_attention`` against the
    Pallas kernel in interpret mode and the JAX oracle."""
    (jq, jk, jv), (tq, tk, tv) = _case(rng, 1, 7, 1, sq, sk, 128, dt)
    tol = F32_TOL if dt == "f32" else BF16_TOL
    o_pallas = jops.flash_attention(jq, jk, jv, causal=causal, q_tile=64,
                                    k_tile=64)
    o_ref = jref.attention_ref(jq, jk, jv, causal=causal)
    before = launch_counts()
    o_ops = tops.flash_attention(tq, tk, tv, causal=causal, q_tile=64,
                                 k_tile=64)
    assert launch_counts() == before            # CPU: neither kernel runs
    o_plain = fa.flash_attention_plain(tq, tk, tv, causal=causal)
    assert o_ops.dtype == o_plain.dtype == tq.dtype
    for o in (o_ops, o_plain):
        for want in (o_pallas, o_ref):
            np.testing.assert_allclose(o.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=tol, rtol=tol)
