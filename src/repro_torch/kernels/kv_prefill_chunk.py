"""Fused chunked-prefill append+attend over the multi-port KV cache.

One mid-prefill macro-cycle conventionally pays a scatter pass (write the
chunk's K,V at ``[offset, offset+chunk_len)``) plus a DENSE read of the whole
cache for the chunk's attention. This kernel services both ports in one
length-bounded traversal: the W port lands the chunk's rows, the R port runs
causal online-softmax attention for the chunk's query rows over the live
positions only, with same-cycle W->R visibility.

The CUDA kernel (``csrc/kv_prefill_chunk.cu``) replaces the JAX package's
Pallas kernel ``kernels/kv_prefill_chunk.py:_kernel``; the TPU's one-hot
routing matmul becomes an indexed store. Contract kept exactly: caches are
updated in place; a row services ``live_tile_bound(offset + max(chunk_len
- 1, 0) + 1, seq_tile)`` tiles; padded rows (``>= chunk_len``) attend as
position ``offset``; a dead row (``offset < 0``) writes nothing, outputs
zeros and services 0 tiles.

:func:`fused_chunk_append_attend` launches the kernel for CUDA tensors and
runs :func:`fused_chunk_append_attend_plain` — the same function in plain
torch — for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_multiport import launch_geometry
from repro_torch.kernels.tiling import live_tile_bound

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = _build.Launcher(
    "kv_prefill_chunk", "kv_chunk_append_attend",
    [_vp] * 9 + [_i] * 8 + [ctypes.c_float, _i, _i, _vp])


def fused_chunk_append_attend_plain(q, cache_k, cache_v, new_k, new_v,
                                    offset, chunk_len, *, seq_tile: int,
                                    n_tiles: int
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch. Updates the caches in place;
    returns (out [B, C, H, D], serviced tiles [B] int32)."""
    b, c, h, d = q.shape
    s, hkv = cache_k.shape[1], cache_k.shape[2]
    g = h // hkv
    dev = q.device
    end = min(n_tiles * seq_tile, s)
    off = offset.long()
    cl = chunk_len.long()
    live = off >= 0
    rel = torch.arange(c, device=dev)
    pos = off[:, None] + rel[None, :]                             # [B, C]
    in_chunk = rel[None, :] < cl[:, None]
    bi, ri = torch.nonzero(live[:, None] & in_chunk & (pos < end),
                           as_tuple=True)
    cache_k[bi, pos[bi, ri]] = new_k[bi, ri].to(cache_k.dtype)
    cache_v[bi, pos[bi, ri]] = new_v[bi, ri].to(cache_v.dtype)
    qmax = off + torch.clamp(cl - 1, min=0)
    per_row = torch.clamp(live_tile_bound(qmax + 1, seq_tile), max=n_tiles)
    tiles = torch.where(live, per_row, torch.zeros_like(per_row))

    f32 = torch.float32
    qpos = torch.where(in_chunk, pos, off[:, None])               # [B, C]
    kpos = torch.arange(end, device=dev)
    valid = live[:, None, None] & (kpos[None, None, :] <= qpos[..., None])
    valid = valid[:, :, None, None, :]                            # [B,C,1,1,S]
    qg = q.reshape(b, c, hkv, g, d).to(f32)
    sc = torch.einsum("bchgd,bshd->bchgs", qg, cache_k[:, :end].to(f32)) \
        * (1.0 / d ** 0.5)
    sc = sc.masked_fill(~valid, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    pr = torch.where(valid, torch.exp(sc - m), torch.zeros_like(sc))
    acc = torch.einsum("bchgs,bshd->bchgd", pr, cache_v[:, :end].to(f32))
    out = acc / torch.clamp(pr.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(b, c, h, d).to(q.dtype), tiles.to(torch.int32)


def fused_chunk_append_attend(q: torch.Tensor, cache_k: torch.Tensor,
                              cache_v: torch.Tensor, new_k: torch.Tensor,
                              new_v: torch.Tensor, offset: torch.Tensor,
                              chunk_len: torch.Tensor, *, seq_tile: int = 128,
                              live_len: int | None = None,
                              dynamic_grid: bool = False,
                              return_tiles: bool = False) -> tuple:
    """One chunked-prefill step for a batch of mid-prefill sequences.

    Args:
      q:         [B, C, H, D] chunk queries (H = Hkv * G); rows past
                 ``chunk_len`` are padding (finite garbage outputs).
      cache_k/v: [B, S, Hkv, D] staging caches, updated IN PLACE.
      new_k/v:   [B, C, Hkv, D] the chunk's K,V (rope applied, cache dtype).
      offset:    [B] int — each sequence's cache write offset; NEGATIVE
                 marks a dead (padded) row.
      chunk_len: [B] int — valid rows of each sequence's chunk.
      live_len:  static bound on the live prefix ``max(offset +
                 chunk_len)``; ignored under ``dynamic_grid``.
      return_tiles: also return the serviced-tile count per row.

    Returns (attn_out [B, C, H, D], cache_k, cache_v) plus the tile counts
    when ``return_tiles``.
    """
    b, s, hkv, d = cache_k.shape
    h = q.shape[2]
    if h % hkv:
        raise ValueError("GQA requires H % Hkv == 0")
    tile, n_tiles = launch_geometry(s, seq_tile, live_len, dynamic_grid)
    if q.device.type == "cpu":
        out, tiles = fused_chunk_append_attend_plain(
            q, cache_k, cache_v, new_k, new_v, offset, chunk_len,
            seq_tile=tile, n_tiles=n_tiles)
    else:
        out, tiles = _launch(q, cache_k, cache_v, new_k, new_v, offset,
                             chunk_len, tile, n_tiles)
    if return_tiles:
        return out, cache_k, cache_v, tiles
    return out, cache_k, cache_v


def _launch(q, cache_k, cache_v, new_k, new_v, offset, chunk_len, tile,
            n_tiles):
    b, s, hkv, d = cache_k.shape
    c, h = q.shape[1], q.shape[2]
    code = _build.DTYPE_CODE
    if q.dtype not in code or cache_k.dtype not in code:
        raise ValueError(f"fused_chunk_append_attend: q {q.dtype} / cache "
                         f"{cache_k.dtype} not supported (f32 or bf16)")
    if cache_v.dtype != cache_k.dtype:
        raise ValueError("fused_chunk_append_attend: K and V caches differ "
                         "in dtype")
    if d > 128:
        raise ValueError(f"fused_chunk_append_attend: D={d} > 128 is not "
                         f"supported")
    q = q.contiguous()
    new_k = new_k.to(cache_k.dtype).contiguous()
    new_v = new_v.to(cache_v.dtype).contiguous()
    offs = offset.to(torch.int32).contiguous()
    clens = chunk_len.to(torch.int32).contiguous()
    _build.check_cuda("fused_chunk_append_attend", q, cache_k, cache_v,
                      new_k, new_v, offs, clens)
    out = torch.empty_like(q)
    tiles = torch.empty((b,), dtype=torch.int32, device=q.device)
    P = _build.ptr
    KERNEL(P(q), P(cache_k), P(cache_v), P(new_k), P(new_v), P(offs),
           P(clens), P(out), P(tiles), b, s, c, hkv, h // hkv, d, tile,
           n_tiles, 1.0 / d ** 0.5, code[q.dtype], code[cache_k.dtype],
           _build.stream_of(q))
    return out, tiles
