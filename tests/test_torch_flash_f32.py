"""The arithmetic of B5's f32 route (``csrc/flash_attention.cu``: scores in
f32 FMA on the CUDA cores, P V in 3xTF32 on the tensor cores) emulated in
plain torch on the CPU, against the JAX package's Pallas flash kernel in
interpret mode (as ``tests/test_torch_flash.py`` runs it).

The card's kernel splits each f32 operand x of P V into hi = tf32(x) and
lo = tf32(x - hi) with ``cvt.rna.tf32.f32``'s rounding (to nearest on the
13 dropped mantissa bits, ties away from zero, done as integer ops) and
sums lo*hi + hi*lo + hi*hi in f32. The emulation rounds the same way on the
f32 bits, so it shows what the split costs against the f32 contract (2e-5)
before the card does. It sums with round to nearest; the tensor cores'
f32 sums round toward zero, which the kernel contains by keeping each MMA
chain short (its source says how) and which only the card can show. The
scores were 3xTF32 too in the route's first tensor-core design; the card
showed that at scores of tens (q and k 3-4x N(0, 1)) the softmax amplifies
the few units of 2^-24 by which any other summation order differs from the
plain version's, so the kernel now takes them in the plain version's own
order on the CUDA cores. Both products in 3xTF32, and single-pass TF32
(hi*hi alone), are computed on the same inputs and printed, not asserted
(at these sizes they may pass by chance). Run with ``-s`` to see the
errors. The kernel itself is held against the plain version on the card by
``test_torch_cuda.py``.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa

F32_TOL = 2e-5                  # the JAX suite's f32 flash tolerance


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 bits: keep 10 explicit mantissa bits,
    rounding the 13 dropped ones to nearest, ties away from zero (adding
    half a unit to the magnitude carries into the kept bits)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _mm(a, b, passes):
    """a @ b as a kernel takes it: in f32 (0 passes), in 3 TF32 products
    (lo*hi, hi*lo, hi*hi, summed in f32 in that order), or in 1 (hi*hi)."""
    if passes == 0:
        return a @ b
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def flash_tf32(q, k, v, *, causal, passes, qk_passes=0):
    """Attention with P V emulated in TF32 ``passes`` (1 or 3) and the
    scores in ``qk_passes`` (0: f32, as the kernel takes them; 1 or 3);
    q [B, H, Sq, D], k/v [B, Hkv, Sk, D], all f32. The softmax is f32, P is
    split like any operand and its sum is taken unsplit, as the kernel
    does."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, h // hkv * sq, d)
    s = _mm(qg, k.transpose(-1, -2), qk_passes).reshape(
        b, hkv, h // hkv, sq, sk)
    s = s * (1.0 / d ** 0.5)
    if causal:
        mask = torch.arange(sq)[:, None] < torch.arange(sk)[None, :]
        s = s.masked_fill(mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = _mm(p.reshape(b, hkv, -1, sk), v, passes).reshape(p.shape[:-1] + (d,))
    o = o / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return o.reshape(b, h, sq, d)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's unit at 1.0
    x = torch.tensor([one + ulp * 0.49, one + ulp * 0.5, one + ulp * 0.51,
                      -(one + ulp * 0.5), one + ulp * 1.5, 3.0, 0.0])
    want = torch.tensor([one, one + ulp, one + ulp, -(one + ulp),
                         one + 2 * ulp, 3.0, 0.0])
    assert torch.equal(tf32_rna(x), want)
    lo_bits = tf32_rna(torch.randn(1000)).view(torch.int32) & 0x1fff
    assert not lo_bits.any()


def test_the_split_keeps_about_21_bits():
    x = torch.randn(100_000, dtype=torch.float32)
    hi, lo = _split(x)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert rel < 2.0 ** -21


@pytest.mark.parametrize("g", [1, 7, 8])
@pytest.mark.parametrize("d", [12, 64, 128])
def test_3xtf32_flash_holds_the_f32_contract(rng, g, d):
    """Causal GQA attention at Sq = Sk = 128 (two 64-row query tiles),
    hkv 2: the kernel's arithmetic (f32 scores, P V in 3xTF32) within 2e-5
    of the Pallas kernel; both products in 3xTF32 and single-pass TF32 on
    the same inputs are printed beside it."""
    b, hkv, s = 1, 2, 128
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, hkv * g, s, d), (b, hkv, s, d), (b, hkv, s, d))]
    o_pallas = np.asarray(jops.flash_attention(
        *(jnp.asarray(a) for a in arrs), causal=True, q_tile=64, k_tile=64),
        np.float32)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    err = {(n, m): float(np.abs(flash_tf32(q, k, v, causal=True, passes=n,
                                           qk_passes=m).numpy()
                                - o_pallas).max())
           for n, m in ((3, 0), (3, 3), (1, 1))}
    print(f"G {g} D {d}: f32 scores + 3xTF32 P V max |diff| "
          f"{err[3, 0]:.3g}, both 3xTF32 {err[3, 3]:.3g}, single-pass TF32 "
          f"{err[1, 1]:.3g} (limit {F32_TOL})")
    np.testing.assert_allclose(
        flash_tf32(q, k, v, causal=True, passes=3).numpy(), o_pallas,
        atol=F32_TOL, rtol=F32_TOL)


def test_3xtf32_flash_holds_the_contract_without_the_mask(rng):
    """Full attention, Sq != Sk, G 7, D 64."""
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((1, 7, 64, 64), (1, 1, 128, 64), (1, 1, 128, 64))]
    o_pallas = np.asarray(jops.flash_attention(
        *(jnp.asarray(a) for a in arrs), causal=False, q_tile=64,
        k_tile=64), np.float32)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    np.testing.assert_allclose(
        flash_tf32(q, k, v, causal=False, passes=3).numpy(), o_pallas,
        atol=F32_TOL, rtol=F32_TOL)


def test_the_kernel_rounds_as_the_emulation_does():
    """The kernel's split is the emulated rounding, on the same bits."""
    src = (Path(fa.__file__).resolve().parent.parent / "csrc"
           / "flash_attention.cu").read_text()
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    # the scores: one f32 FMA chain from 0 over the head dims in order
    assert "sa = fmaf(xa.x, kx.x, sa);" in src


@pytest.mark.parametrize("d", range(1, 137))
def test_every_head_dim_off_the_bf16_kernel_takes_the_f32_route(d):
    """f32, bf16 q over f32 k/v and f32 q over bf16 k/v take the f32 kernel
    at every head dim; bf16 q, k and v take it only where the tensor-core
    kernel cannot (D not a multiple of 8, or past 128)."""
    f32, bf = torch.float32, torch.bfloat16
    for qdt, kdt in ((f32, f32), (bf, f32), (f32, bf)):
        assert fa.route(qdt, kdt, d) == "f32"
    tc = d % 8 == 0 and d <= fa.MAX_HEAD_DIM
    assert fa.route(bf, bf, d) == ("tc" if tc else "f32")
