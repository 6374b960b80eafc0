"""GQA attention: whole-sequence causal (forward and prefill, q-chunked
plain torch, as the JAX package computes it in jnp), and for serving
chunked prefill and decode, each servicing the KV cache as a 2-port
(1W+1R) memory.

``kernel_mode`` of the serving steps selects:

  * "reference"  — the two-pass oracle (append traversal, then a dense
                   read traversal; ``kernels/ref.py``);
  * "multiport"  — the fused kernels (one length-bounded traversal for the
                   W and R ports; ``kernels/ops.py``), which update the
                   caches in place.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as S
from repro_torch.models import layers as L


def attention_init(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, *, qkv_bias: bool = False,
                   dtype=torch.float32, device="cuda",
                   lead: tuple = ()) -> dict:
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "wq": L.linear_init(gen, d_model, n_heads * head_dim, bias=qkv_bias, **kw),
        "wk": L.linear_init(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw),
        "wv": L.linear_init(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw),
        "wo": L.linear_init(gen, n_heads * head_dim, d_model, bias=False, **kw),
    }


def _project_qkv(p: dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
                 head_dim: int, compute_dtype):
    q = S.split_heads(L.linear(p["wq"], x, compute_dtype), n_heads, head_dim)
    k = S.split_heads(L.linear(p["wk"], x, compute_dtype), n_kv_heads,
                      head_dim)
    v = S.split_heads(L.linear(p["wv"], x, compute_dtype), n_kv_heads,
                      head_dim)
    return q, k, v


def _apply_pos(q, k, positions, pos_embed: str, rope_theta: float,
               mrope_sections):
    if pos_embed == "rope":
        q = L.rope_apply(q, positions, rope_theta)
        k = L.rope_apply(k, positions, rope_theta)
    elif pos_embed == "mrope":
        q = L.mrope_apply(q, positions, mrope_sections, rope_theta)
        k = L.mrope_apply(k, positions, mrope_sections, rope_theta)
    # "none"/"sinusoidal": absolute embeddings are added at the stem.
    return q, k


def _text_positions(positions: torch.Tensor, pos_embed: str) -> torch.Tensor:
    """[B, S] text positions as the position embedding takes them: M-RoPE
    advances all three (t, h, w) streams together on text."""
    if pos_embed == "mrope":
        return positions[..., None].expand(*positions.shape, 3)
    return positions


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, q_chunk: int = 1024
                             ) -> torch.Tensor:
    """Causal GQA attention, looped over query chunks.

    Memory is O(B * H * q_chunk * S) instead of O(B * H * S^2); FLOPs are
    unchanged. q: [B, S, H, D]; k, v: [B, S, Hkv, D]. Returns [B, S, H, D].
    The products take the operands in their own dtype and sum in f32
    (``layers.bmm_f32``: JAX's ``preferred_element_type``, with no f32
    copies of K/V on the card), and the probabilities are rounded to v's
    dtype before the PV product, as there. On DTensors (sharded training)
    each rank attends over its own rows and heads
    (``distributed.sharding.local_heads``).
    """
    if S.is_dtensor(q):
        return S.local_heads(lambda *qkv: chunked_causal_attention(
            *qkv, q_chunk=q_chunk), q, k, v)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q_chunk = min(q_chunk, s)
    assert s % q_chunk == 0, (s, q_chunk)
    scale = 1.0 / (d ** 0.5)
    # one product per (row, kv head): its G query heads x the chunk's rows
    kh = k.permute(0, 2, 1, 3).reshape(b * hkv, s, d)
    vh = v.permute(0, 2, 1, 3).reshape(b * hkv, s, d)
    kpos = torch.arange(s, device=q.device)
    outs = []
    for c0 in range(0, s, q_chunk):
        qc = q[:, c0:c0 + q_chunk].reshape(b, q_chunk, hkv, g, d)
        qh = qc.permute(0, 2, 1, 3, 4).reshape(b * hkv, q_chunk * g, d)
        qpos = c0 + torch.arange(q_chunk, device=q.device)
        sc = L.bmm_f32(qh, kh.transpose(1, 2)) * scale   # [B*Hkv, C*G, S]
        mask = (qpos[:, None] >= kpos[None, :]).repeat_interleave(g, dim=0)
        sc = sc.masked_fill(~mask, float("-inf"))
        pr = torch.softmax(sc, dim=-1).to(v.dtype)
        oc = L.bmm_f32(pr, vh).reshape(b, hkv, q_chunk, g, d)
        outs.append(oc.permute(0, 2, 1, 3, 4).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(b, s, h, d)


def attention_train(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    pos_embed: str = "rope", rope_theta: float = 10000.0,
                    mrope_sections=(16, 24, 24), q_chunk: int = 1024,
                    compute_dtype=None) -> torch.Tensor:
    """Full-sequence causal attention (training / prefill compute)."""
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, compute_dtype)
    q, k = _apply_pos(q, k, positions, pos_embed, rope_theta,
                      mrope_sections)
    out = chunked_causal_attention(q, k, v, q_chunk=q_chunk)
    b, s = x.shape[:2]
    return L.linear(p["wo"], out.reshape(b, s, n_heads * head_dim),
                    compute_dtype)


def attention_prefill(p: dict, x: torch.Tensor, positions: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                      n_heads: int, n_kv_heads: int, head_dim: int,
                      pos_embed: str = "rope", rope_theta: float = 10000.0,
                      mrope_sections=(16, 24, 24), q_chunk: int = 1024,
                      compute_dtype=None):
    """Prefill: attend causally over the prompt AND write its K,V into the
    caches at [0, S), in place.

    cache_k/v: [B, S_max, Hkv, D] with S_max >= S. Returns (out, k', v'),
    the caches being the (updated) tensors passed in.
    """
    b, s = x.shape[:2]
    if s > cache_k.shape[1]:
        raise ValueError(f"prompt of {s} tokens exceeds the cache's "
                         f"{cache_k.shape[1]} positions")
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, compute_dtype)
    q, k = _apply_pos(q, k, positions, pos_embed, rope_theta,
                      mrope_sections)
    out = chunked_causal_attention(q, k, v, q_chunk=q_chunk)
    S.write_prefix(cache_k, k)
    S.write_prefix(cache_v, v)
    out = L.linear(p["wo"], out.reshape(b, s, n_heads * head_dim),
                   compute_dtype)
    return out, cache_k, cache_v


def attention_prefill_chunk(p: dict, x: torch.Tensor, offset: torch.Tensor,
                            chunk_len: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, *, n_heads: int,
                            n_kv_heads: int, head_dim: int,
                            pos_embed: str = "rope",
                            rope_theta: float = 10000.0,
                            mrope_sections=(16, 24, 24),
                            kernel_mode: str = "reference",
                            seq_tile: int = 128, dynamic_grid: bool = False,
                            mesh=None, mesh_axis: str = "kv",
                            port_mix: str = "wr", compute_dtype=None):
    """One fixed-size prompt chunk per sequence, mid-prefill: the W port
    writes the chunk's K,V at [offset, offset+chunk_len) and the R port
    attends causally over everything cached so far, the chunk included.
    ``mesh`` runs the fused kernel once per shard of its batch rows.

    x: [B, C, d] (rows >= chunk_len are padding); offset/chunk_len: [B];
    cache_k/v: [B, S_max, Hkv, D]. Returns (out [B, C, d], k', v') —
    the fused path returns the same (updated) cache tensors.
    """
    b, c = x.shape[:2]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, compute_dtype)
    rel = torch.arange(c, device=x.device)
    positions = offset.long()[:, None] + rel[None, :]             # [B, C]
    q, k = _apply_pos(q, k, _text_positions(positions, pos_embed), pos_embed,
                      rope_theta, mrope_sections)
    new_k = k.to(cache_k.dtype)
    new_v = v.to(cache_v.dtype)
    if kernel_mode == "multiport":
        from repro_torch.kernels import ops
        out, cache_k, cache_v = ops.fused_prefill_chunk_attention(
            q, cache_k, cache_v, new_k, new_v, offset, chunk_len,
            seq_tile=seq_tile, dynamic_grid=dynamic_grid, mesh=mesh,
            mesh_axis=mesh_axis, port_mix=port_mix)
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
                     mrope_sections=(16, 24, 24),
                     kernel_mode: str = "reference", seq_tile: int = 128,
                     length_mask: bool = True, dynamic_grid: bool = False,
                     num_kv_splits: int = 1, mesh=None,
                     mesh_axis: str = "kv", port_mix: str = "wr",
                     compute_dtype=None):
    """One decode step. x: [B, 1, d]; cache_k/v: [B, S_max, Hkv, D];
    cache_len: [B] current lengths. Returns (out [B, 1, d], k', v').
    ``mesh`` runs the fused kernel once per shard of its batch rows."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, compute_dtype)
    q, k = _apply_pos(q, k, _text_positions(cache_len.long()[:, None],
                                            pos_embed),
                      pos_embed, rope_theta, mrope_sections)
    q1 = q[:, 0]                                       # [B, H, D]
    new_k = k[:, 0].to(cache_k.dtype)
    new_v = v[:, 0].to(cache_v.dtype)
    if kernel_mode == "multiport":
        from repro_torch.kernels import ops
        out, cache_k, cache_v = ops.fused_decode_attention(
            q1, cache_k, cache_v, new_k, new_v, cache_len,
            seq_tile=seq_tile, length_mask=length_mask,
            dynamic_grid=dynamic_grid, num_kv_splits=num_kv_splits,
            mesh=mesh, mesh_axis=mesh_axis, port_mix=port_mix)
    elif kernel_mode == "reference" and S.is_dtensor(cache_k):
        # a sharded serving step: each rank attends over its own shard
        out, cache_k, cache_v = S.decode_attention(
            q1, cache_k, cache_v, new_k, new_v, cache_len)
    elif kernel_mode == "reference":
        from repro_torch.kernels import ref
        out, cache_k, cache_v = ref.decode_attention_ref(
            q1, cache_k, cache_v, new_k, new_v, cache_len)
    else:
        raise ValueError(f"unknown kernel_mode: {kernel_mode!r}")
    out = L.linear(p["wo"], out.reshape(b, 1, n_heads * head_dim),
                   compute_dtype)
    return out, cache_k, cache_v
