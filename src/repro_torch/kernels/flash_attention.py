"""Causal (or full) GQA flash attention over whole sequences: the
training / prefill hot spot.

Two CUDA kernels replace the JAX package's Pallas kernel
``kernels/flash_attention.py:_kernel``: online-softmax tiled attention with
the running max, sum and accumulator in f32, key tiles wholly above the
causal diagonal skipped. :func:`route` picks one from the dtypes and the
head dim alone, before the launch: bf16 q, k and v with D a multiple of 8
(TMA's 16-byte rows) go to the bf16 tensor-core kernel
(``csrc/flash_attention_tc.cu``: TMA, an mbarrier ring, ``wgmma``, P
rounded to bf16 for the second product); everything else (f32, bf16 q over
f32 k/v, a D that is not a multiple of 8) to the f32 kernel
(``csrc/flash_attention.cu``), which takes the scores on the CUDA cores as
f32 FMA chains over the head dims in order (the plain version's own
rounding, which the softmax amplifies at large scores) and P V on the
tensor cores in 3xTF32 (``mma.sync`` m16n8k8: each operand split into two
TF32 values by ``cvt.rna``'s rounding, three products summed in f32 in
short chains), since one TF32 product keeps only about three digits of the
2e-5 contract. Each has its own launch counter, ``flash_attention_tc`` and
``flash_attention``. Contract kept
exactly: the causal mask is ``qpos >= kpos`` with both counted from 0
(top-left aligned when Sq != Sk), scale 1/sqrt(D), sums in f32, the
softmax denominator floored at 1e-30, the output in q's dtype.
``q_tile``/``k_tile`` are the JAX interface's arguments and are validated
as there; the kernels' own blocking only changes the order of the sums.

:func:`flash_attention` launches a kernel for CUDA tensors and runs
:func:`flash_attention_plain` — the same function in plain torch — for CPU
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 128

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = _build.Launcher(
    "flash_attention", "flash_attention",
    [_vp] * 4 + [_i] * 6 + [ctypes.c_float, _i, _i, _i, _vp])
KERNEL_TC = _build.Launcher(
    "flash_attention_tc", "flash_attention_tc",
    [_vp] * 4 + [_i] * 6 + [ctypes.c_float, _i, _vp])

# the tensor-core kernel's tiling (csrc/flash_attention_tc.cu, Geo<DP>)
TC_BLOCK_Q = 64        # query rows per CTA: one wgmma M
TC_STAGES = 2          # K/V ring depth
TC_ATOM_COLS = 64      # bf16 columns per 128-byte swizzled row (one box)


def route(q_dtype: torch.dtype, kv_dtype: torch.dtype, d: int) -> str:
    """Which kernel a CUDA call takes: ``"tc"`` (the bf16 tensor-core
    kernel) for bf16 q, k and v with D <= 128 a multiple of 8, else
    ``"f32"`` (the f32 kernel)."""
    bf = torch.bfloat16
    if q_dtype == bf and kv_dtype == bf and d <= MAX_HEAD_DIM and d % 8 == 0:
        return "tc"
    return "f32"


def tc_geometry(d: int) -> dict:
    """The tensor-core kernel's tiles for head dim ``d`` (<= 128): D padded
    to 64 or 128 by TMA's zero fill, keys per tile, 64-column swizzle atoms
    per row, TMA boxes (columns, rows) for Q and for K/V, ring stages and
    dynamic shared memory in bytes (1024 of alignment slack, Q, the K and V
    rings, 2 * stages + 1 mbarriers)."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"tc_geometry: D={d} outside 1..{MAX_HEAD_DIM}")
    dp = 64 if d <= 64 else 128
    bn = 128 if dp == 64 else 64
    q_bytes, kv_bytes = TC_BLOCK_Q * dp * 2, bn * dp * 2
    return {"padded_d": dp, "block_q": TC_BLOCK_Q, "block_k": bn,
            "atoms": dp // TC_ATOM_COLS, "box_q": (TC_ATOM_COLS, TC_BLOCK_Q),
            "box_kv": (TC_ATOM_COLS, bn), "stages": TC_STAGES,
            "smem_bytes": (1024 + q_bytes + 2 * TC_STAGES * kv_bytes
                           + 8 * (2 * TC_STAGES + 1))}


def tc_smem_bytes_built(d: int) -> int:
    """The built kernel's own shared-memory size for head dim ``d`` (needs
    the CUDA toolkit): what :func:`tc_geometry` must equal."""
    lib = _build.library("flash_attention_tc")
    return int(lib.flash_attention_tc_smem_bytes(ctypes.c_int(d)))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool) -> torch.Tensor:
    """The kernel's function in plain torch. q: [B, H, Sq, D]; k, v:
    [B, Hkv, Sk, D]. Returns [B, H, Sq, D] in q's dtype."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    f32 = torch.float32
    qg = q.reshape(b, hkv, g, sq, d).to(f32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(f32)) * (1.0 / d ** 0.5)
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(f32))
    out = acc / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(b, h, sq, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_tile: int = 128,
                    k_tile: int = 128) -> torch.Tensor:
    """Tiled attention.

    Args:
      q: [B, H, Sq, D] (H = Hkv * G); k, v: [B, Hkv, Sk, D].
      q_tile, k_tile: clamped to Sq and Sk; they must divide them.

    Returns: [B, H, Sq, D] in q's dtype.
    """
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not match")
    hkv, sk = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"flash_attention: GQA requires H % Hkv == 0 "
                         f"(H={h}, Hkv={hkv})")
    q_tile, k_tile = min(q_tile, sq), min(k_tile, sk)
    if q_tile <= 0 or k_tile <= 0 or sq % q_tile or sk % k_tile:
        raise ValueError(f"flash_attention: Sq={sq} and Sk={sk} must be "
                         f"multiples of q_tile={q_tile} and k_tile={k_tile}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k and v must be on one device "
                         f"(got {q.device}, {k.device}, {v.device})")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    return _launch(q, k, v, causal)


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    code = _build.DTYPE_CODE
    if q.dtype not in code or k.dtype not in code:
        raise ValueError(f"flash_attention: q {q.dtype} / k {k.dtype} not "
                         f"supported (f32 or bf16)")
    if v.dtype != k.dtype:
        raise ValueError("flash_attention: k and v differ in dtype")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: D={d} > {MAX_HEAD_DIM} is not "
                         f"supported")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _build.check_cuda("flash_attention", q, k, v)
    out = torch.empty_like(q)
    P = _build.ptr
    if route(q.dtype, k.dtype, d) == "tc":
        # TMA reads from 16-byte aligned bases; a view may start off one
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
        KERNEL_TC(P(q), P(k), P(v), P(out), b, hkv, h // hkv, sq, sk, d,
                  1.0 / d ** 0.5, int(causal), _build.stream_of(q))
        return out
    KERNEL(P(q), P(k), P(v), P(out), b, hkv, h // hkv, sq, sk, d,
           1.0 / d ** 0.5, int(causal), code[q.dtype], code[k.dtype],
           _build.stream_of(q))
    return out
