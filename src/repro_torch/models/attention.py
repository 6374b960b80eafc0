"""GQA attention for serving: chunked prefill and decode, each servicing the
KV cache as a 2-port (1W+1R) memory.

``kernel_mode`` selects:

  * "reference"  — the two-pass oracle (append traversal, then a dense
                   read traversal; ``kernels/ref.py``);
  * "multiport"  — the fused kernels (one length-bounded traversal for the
                   W and R ports; ``kernels/ops.py``), which update the
                   caches in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L


def attention_init(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, *, qkv_bias: bool = False,
                   dtype=torch.float32, device="cpu", lead: tuple = ()) -> dict:
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "wq": L.linear_init(gen, d_model, n_heads * head_dim, bias=qkv_bias, **kw),
        "wk": L.linear_init(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw),
        "wv": L.linear_init(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw),
        "wo": L.linear_init(gen, n_heads * head_dim, d_model, bias=False, **kw),
    }


def _project_qkv(p: dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
                 head_dim: int, compute_dtype):
    b, s, _ = x.shape
    q = L.linear(p["wq"], x, compute_dtype).reshape(b, s, n_heads, head_dim)
    k = L.linear(p["wk"], x, compute_dtype).reshape(b, s, n_kv_heads, head_dim)
    v = L.linear(p["wv"], x, compute_dtype).reshape(b, s, n_kv_heads, head_dim)
    return q, k, v


def _rope(q, k, positions, pos_embed: str, rope_theta: float):
    if pos_embed != "rope":
        raise NotImplementedError(
            f"pos_embed={pos_embed!r} is not ported yet (the dense family "
            f"uses rope; mrope/sinusoidal come with ROADMAP item A9)")
    return (L.rope_apply(q, positions, rope_theta),
            L.rope_apply(k, positions, rope_theta))


def attention_prefill_chunk(p: dict, x: torch.Tensor, offset: torch.Tensor,
                            chunk_len: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, *, n_heads: int,
                            n_kv_heads: int, head_dim: int,
                            pos_embed: str = "rope",
                            rope_theta: float = 10000.0,
                            kernel_mode: str = "reference",
                            seq_tile: int = 128, dynamic_grid: bool = False,
                            port_mix: str = "wr", compute_dtype=None):
    """One fixed-size prompt chunk per sequence, mid-prefill: the W port
    writes the chunk's K,V at [offset, offset+chunk_len) and the R port
    attends causally over everything cached so far, the chunk included.

    x: [B, C, d] (rows >= chunk_len are padding); offset/chunk_len: [B];
    cache_k/v: [B, S_max, Hkv, D]. Returns (out [B, C, d], k', v') —
    the fused path returns the same (updated) cache tensors.
    """
    b, c = x.shape[:2]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, compute_dtype)
    rel = torch.arange(c, device=x.device)
    positions = offset.long()[:, None] + rel[None, :]             # [B, C]
    q, k = _rope(q, k, positions, pos_embed, rope_theta)
    new_k = k.to(cache_k.dtype)
    new_v = v.to(cache_v.dtype)
    if kernel_mode == "multiport":
        from repro_torch.kernels import ops
        out, cache_k, cache_v = ops.fused_prefill_chunk_attention(
            q, cache_k, cache_v, new_k, new_v, offset, chunk_len,
            seq_tile=seq_tile, dynamic_grid=dynamic_grid, port_mix=port_mix)
    elif kernel_mode == "reference":
        from repro_torch.kernels import ref
        out, cache_k, cache_v = ref.prefill_chunk_attention_ref(
            q, cache_k, cache_v, new_k, new_v, offset, chunk_len)
    else:
        raise ValueError(f"unknown kernel_mode: {kernel_mode!r}")
    out = out.reshape(b, c, n_heads * head_dim)
    return L.linear(p["wo"], out, compute_dtype), cache_k, cache_v


def attention_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len: torch.Tensor, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     pos_embed: str = "rope", rope_theta: float = 10000.0,
                     kernel_mode: str = "reference", seq_tile: int = 128,
                     length_mask: bool = True, dynamic_grid: bool = False,
                     num_kv_splits: int = 1, port_mix: str = "wr",
                     compute_dtype=None):
    """One decode step. x: [B, 1, d]; cache_k/v: [B, S_max, Hkv, D];
    cache_len: [B] current lengths. Returns (out [B, 1, d], k', v')."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, compute_dtype)
    q, k = _rope(q, k, cache_len.long()[:, None], pos_embed, rope_theta)
    q1 = q[:, 0]                                       # [B, H, D]
    new_k = k[:, 0].to(cache_k.dtype)
    new_v = v[:, 0].to(cache_v.dtype)
    if kernel_mode == "multiport":
        from repro_torch.kernels import ops
        out, cache_k, cache_v = ops.fused_decode_attention(
            q1, cache_k, cache_v, new_k, new_v, cache_len,
            seq_tile=seq_tile, length_mask=length_mask,
            dynamic_grid=dynamic_grid, num_kv_splits=num_kv_splits,
            port_mix=port_mix)
    elif kernel_mode == "reference":
        from repro_torch.kernels import ref
        out, cache_k, cache_v = ref.decode_attention_ref(
            q1, cache_k, cache_v, new_k, new_v, cache_len)
    else:
        raise ValueError(f"unknown kernel_mode: {kernel_mode!r}")
    out = L.linear(p["wo"], out.reshape(b, 1, n_heads * head_dim),
                   compute_dtype)
    return out, cache_k, cache_v
