"""Fused decode append+attend over a multi-port KV cache.

Decoding one token conventionally costs TWO traversals of the cache: the
write port appends the new token's K,V at ``cache_len``, then the read port
attends over positions ``[0, cache_len]``. This kernel configures the cache
as a 2-port (1W+1R) memory and services both ports in ONE traversal, with
same-cycle W->R visibility: attention sees the just-appended token.

The CUDA kernel (``csrc/kv_multiport.cu``) replaces the JAX package's
Pallas kernel ``kernels/kv_multiport.py:_kernel``. Its contract, kept
exactly:

* caches are updated in place;
* each row services only its own live tiles, ``live_tile_bound(len + 1,
  seq_tile)`` of them (every staged tile under ``length_mask=False``), and
  the per-row serviced-tile counts are returned;
* a dead row (``cache_len < 0``, the engine's batch padding) writes
  nothing, outputs zeros and services 0 tiles;
* f32 accumulation and the ``1e-30`` floor on the softmax denominator.

:func:`fused_append_attend` launches the kernel for CUDA tensors and runs
:func:`fused_append_attend_plain` — the same function in plain torch — for
CPU tensors. The split-KV variant (``num_kv_splits > 1``) is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tiling import clamp_seq_tile, live_tile_bound

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = _build.Launcher(
    "kv_multiport", "kv_decode_append_attend",
    [_vp] * 8 + [_i] * 8 + [ctypes.c_float, _i, _i, _vp])


def staged_tiles(s: int, seq_tile: int, live_len: int | None) -> int:
    """Tiles the traversal may reach: the capacity padded to whole tiles,
    or the static ``live_len`` prefix rounded up to whole tiles."""
    cap = -(-s // seq_tile)
    if live_len is None:
        return cap
    return max(1, min(-(-live_len // seq_tile), cap))


def launch_geometry(s: int, seq_tile: int, live_len: int | None,
                    dynamic_grid: bool) -> tuple[int, int]:
    """(tile, staged tile count) of one launch over an ``s``-position
    cache, as both fused wrappers compute it."""
    tile = clamp_seq_tile(s, seq_tile)
    return tile, staged_tiles(s, tile, None if dynamic_grid else live_len)


def fused_append_attend_plain(q, cache_k, cache_v, new_k, new_v, cache_len,
                              *, seq_tile: int, n_tiles: int,
                              length_mask: bool
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch. Updates the caches in place;
    returns (out [B, H, D], serviced tiles [B] int32)."""
    b, s, hkv, d = cache_k.shape
    h = q.shape[1]
    g = h // hkv
    end = min(n_tiles * seq_tile, s)
    p = cache_len.long()
    live = p >= 0
    rows = torch.nonzero(live & (p < end)).flatten()
    cache_k[rows, p[rows]] = new_k[rows].to(cache_k.dtype)
    cache_v[rows, p[rows]] = new_v[rows].to(cache_v.dtype)
    full = torch.full_like(p, n_tiles)
    per_row = torch.clamp(live_tile_bound(p + 1, seq_tile), max=n_tiles) \
        if length_mask else full
    tiles = torch.where(live, per_row, torch.zeros_like(p)).to(torch.int32)

    f32 = torch.float32
    qg = q.reshape(b, hkv, g, d).to(f32)
    sc = torch.einsum("bhgd,bshd->bhgs", qg, cache_k[:, :end].to(f32)) \
        * (1.0 / d ** 0.5)
    valid = (torch.arange(end, device=q.device)[None] <= p[:, None])
    valid = valid[:, None, None, :]
    sc = sc.masked_fill(~valid, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    pr = torch.where(valid, torch.exp(sc - m), torch.zeros_like(sc))
    acc = torch.einsum("bhgs,bshd->bhgd", pr, cache_v[:, :end].to(f32))
    out = acc / torch.clamp(pr.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype), tiles


def fused_append_attend(q: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, new_k: torch.Tensor,
                        new_v: torch.Tensor, cache_len: torch.Tensor, *,
                        seq_tile: int = 128, live_len: int | None = None,
                        length_mask: bool = True, dynamic_grid: bool = False,
                        return_tiles: bool = False) -> tuple:
    """One decode step for a batch of sequences.

    Args:
      q:        [B, H, D] query for the new token (H = Hkv * G).
      cache_k:  [B, S, Hkv, D]; cache_v same. Updated IN PLACE.
      new_k/v:  [B, Hkv, D] the new token's K,V (cache dtype).
      cache_len:[B] int — the new token is written at this position and
                attended to. A NEGATIVE length marks a dead (padded) row.
      live_len: static bound on ``max(cache_len) + 1``: only positions in
                the first ``ceil(live_len / seq_tile)`` tiles are traversed.
                Ignored under ``dynamic_grid``.
      length_mask: each row services only its own live tiles (False counts
                every staged tile as serviced — the unbounded comparator).
      dynamic_grid: bound each row by its runtime length alone (the kernel
                never needs a batch-wide bound; kept for the JAX package's
                signature). Requires ``length_mask``.
      return_tiles: also return the serviced-tile count per row ([B] int32).

    Returns (attn_out [B, H, D], cache_k, cache_v) plus the tile counts when
    ``return_tiles``.
    """
    b, s, hkv, d = cache_k.shape
    h = q.shape[1]
    if h % hkv:
        raise ValueError("GQA requires H % Hkv == 0")
    if dynamic_grid and not length_mask:
        raise ValueError("dynamic_grid requires length_mask=True: rows "
                         "shorter than the batch max rely on the tile skip")
    tile, n_tiles = launch_geometry(s, seq_tile, live_len, dynamic_grid)
    if q.device.type == "cpu":
        out, tiles = fused_append_attend_plain(
            q, cache_k, cache_v, new_k, new_v, cache_len, seq_tile=tile,
            n_tiles=n_tiles, length_mask=length_mask)
    else:
        out, tiles = _launch(q, cache_k, cache_v, new_k, new_v, cache_len,
                             tile, n_tiles, length_mask)
    if return_tiles:
        return out, cache_k, cache_v, tiles
    return out, cache_k, cache_v


def _launch(q, cache_k, cache_v, new_k, new_v, cache_len, tile, n_tiles,
            length_mask):
    b, s, hkv, d = cache_k.shape
    h = q.shape[1]
    code = _build.DTYPE_CODE
    if q.dtype not in code or cache_k.dtype not in code:
        raise ValueError(f"fused_append_attend: q {q.dtype} / cache "
                         f"{cache_k.dtype} not supported (f32 or bf16)")
    if cache_v.dtype != cache_k.dtype:
        raise ValueError("fused_append_attend: K and V caches differ in dtype")
    if h // hkv > 32 or d > 128:
        raise ValueError(f"fused_append_attend: G={h // hkv} > 32 or "
                         f"D={d} > 128 is not supported")
    q = q.contiguous()
    new_k = new_k.to(cache_k.dtype).contiguous()
    new_v = new_v.to(cache_v.dtype).contiguous()
    lens = cache_len.to(torch.int32).contiguous()
    _build.check_cuda("fused_append_attend", q, cache_k, cache_v, new_k,
                      new_v, lens)
    out = torch.empty_like(q)
    tiles = torch.empty((b,), dtype=torch.int32, device=q.device)
    P = _build.ptr
    KERNEL(P(q), P(cache_k), P(cache_v), P(new_k), P(new_v), P(lens), P(out),
           P(tiles), b, s, hkv, h // hkv, d, tile, n_tiles, int(length_mask),
           1.0 / d ** 0.5, code[q.dtype], code[cache_k.dtype],
           _build.stream_of(q))
    return out, tiles
