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
CPU tensors.

**Split-KV decode** (``num_kv_splits > 1``) replaces the JAX package's
``_split_kernel`` + ``_combine_kernel`` with two CUDA kernels
(``csrc/kv_multiport_split.cu``): stage 1 (:func:`split_partials`) spreads
each row's own live tiles over ``ns`` contiguous banks and writes each
bank's unnormalized f32 ``(acc, m, l)``; stage 2 (:func:`split_combine`)
LSE-combines the banks. Caches and tile counts are those of the serial
path; the output agrees with it within f32 rounding (the banks sum in
another order). ``num_kv_splits=1`` is the serial kernel itself.
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
SPLIT_KERNEL = _build.Launcher(
    "kv_multiport_split", "kv_decode_split_partial",
    [_vp] * 9 + [_i] * 9 + [ctypes.c_float, _i, _i, _vp])
COMBINE_KERNEL = _build.Launcher(
    "kv_multiport_split", "kv_decode_split_combine",
    [_vp] * 3 + [_i] * 6 + [_vp])


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
    _append_plain(cache_k, cache_v, new_k, new_v, p, end)
    tiles = _serviced_tiles(p, seq_tile, n_tiles, length_mask)

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


def _append_plain(cache_k, cache_v, new_k, new_v, p, end):
    """The W port: rows whose append position lies in the staged prefix."""
    rows = torch.nonzero((p >= 0) & (p < end)).flatten()
    cache_k[rows, p[rows]] = new_k[rows].to(cache_k.dtype)
    cache_v[rows, p[rows]] = new_v[rows].to(cache_v.dtype)


def _serviced_tiles(p, seq_tile: int, n_tiles: int, length_mask: bool):
    full = torch.full_like(p, n_tiles)
    per_row = torch.clamp(live_tile_bound(p + 1, seq_tile), max=n_tiles) \
        if length_mask else full
    return torch.where(p >= 0, per_row, torch.zeros_like(p)).to(torch.int32)


def split_partials_plain(q, cache_k, cache_v, new_k, new_v, cache_len, *,
                         seq_tile: int, n_tiles: int, length_mask: bool,
                         num_kv_splits: int) -> tuple:
    """Stage 1 of split-KV decode in plain torch. Updates the caches in
    place; returns (acc [B, ns, H, D], stats [B, ns, H, 2] with (m, l),
    serviced tiles [B] int32), all partials f32 and unnormalized.

    Banks as the JAX kernel defines them, per row: ``row_tiles =
    live_tile_bound(p + 1, T)``, ``per_split = max(ceil(row_tiles / ns),
    1)``, tile ``t`` feeds bank ``clip(t // per_split, 0, ns - 1)``. An
    empty bank is ``acc = 0, m = -inf, l = 0``."""
    b, s, hkv, d = cache_k.shape
    h = q.shape[1]
    g = h // hkv
    ns = num_kv_splits
    end = min(n_tiles * seq_tile, s)
    p = cache_len.long()
    _append_plain(cache_k, cache_v, new_k, new_v, p, end)
    tiles = _serviced_tiles(p, seq_tile, n_tiles, length_mask)

    f32 = torch.float32
    pos = torch.arange(end, device=q.device)
    row_tiles = live_tile_bound(p + 1, seq_tile)
    per_split = torch.clamp(live_tile_bound(row_tiles, ns), min=1)
    bank = torch.clamp((pos[None] // seq_tile) // per_split[:, None], 0,
                       ns - 1)                                # [B, end]
    valid = pos[None] <= p[:, None]                           # [B, end]
    qg = q.reshape(b, hkv, g, d).to(f32)
    sc = torch.einsum("bhgd,bshd->bhgs", qg, cache_k[:, :end].to(f32)) \
        * (1.0 / d ** 0.5)
    v = cache_v[:, :end].to(f32)
    acc = torch.zeros((b, ns, hkv, g, d), dtype=f32, device=q.device)
    stats = torch.zeros((b, ns, hkv, g, 2), dtype=f32, device=q.device)
    for si in range(ns):
        inb = (valid & (bank == si))[:, None, None, :]        # [B, 1, 1, end]
        ss = sc.masked_fill(~inb, float("-inf"))
        m = ss.amax(dim=-1)
        safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        pr = torch.where(inb, torch.exp(ss - safe[..., None]),
                         torch.zeros_like(ss))
        acc[:, si] = torch.einsum("bhgs,bshd->bhgd", pr, v)
        stats[:, si, ..., 0] = m
        stats[:, si, ..., 1] = pr.sum(dim=-1)
    return (acc.reshape(b, ns, h, d), stats.reshape(b, ns, h, 2), tiles)


def split_combine_plain(acc, stats, out_dtype) -> torch.Tensor:
    """Stage 2 in plain torch: the running-max LSE combine of the banks
    with the JAX kernel's guards — an empty bank weighs 0, and a row whose
    banks are all empty gives zeros (0 over the 1e-30 floor)."""
    b, ns, h, d = acc.shape
    m_run = torch.full((b, h), float("-inf"), device=acc.device)
    l_run = torch.zeros((b, h), device=acc.device)
    a_run = torch.zeros((b, h, d), device=acc.device)
    zero = torch.zeros((b, h), device=acc.device)
    for si in range(ns):
        m_s, l_s = stats[:, si, :, 0], stats[:, si, :, 1]
        m_new = torch.maximum(m_run, m_s)
        safe = torch.where(torch.isfinite(m_new), m_new, zero)
        alpha = torch.where(torch.isfinite(m_run), torch.exp(m_run - safe),
                            zero)
        beta = torch.where(torch.isfinite(m_s), torch.exp(m_s - safe), zero)
        a_run = a_run * alpha[..., None] + acc[:, si] * beta[..., None]
        l_run = l_run * alpha + l_s * beta
        m_run = m_new
    return (a_run / torch.clamp(l_run, min=1e-30)[..., None]).to(out_dtype)


def fused_append_attend_split_plain(q, cache_k, cache_v, new_k, new_v,
                                    cache_len, *, seq_tile: int, n_tiles: int,
                                    length_mask: bool, num_kv_splits: int
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split-KV decode in plain torch: stage 1 then stage 2. Updates the
    caches in place; returns (out [B, H, D], serviced tiles [B] int32)."""
    acc, stats, tiles = split_partials_plain(
        q, cache_k, cache_v, new_k, new_v, cache_len, seq_tile=seq_tile,
        n_tiles=n_tiles, length_mask=length_mask,
        num_kv_splits=num_kv_splits)
    return split_combine_plain(acc, stats, q.dtype), tiles


def fused_append_attend(q: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, new_k: torch.Tensor,
                        new_v: torch.Tensor, cache_len: torch.Tensor, *,
                        seq_tile: int = 128, live_len: int | None = None,
                        length_mask: bool = True, dynamic_grid: bool = False,
                        num_kv_splits: int = 1,
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
      num_kv_splits: > 1 runs the two-stage split-KV path (the module
                docstring); 1 is the serial kernel itself.
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
    ns = max(1, int(num_kv_splits))
    cpu = q.device.type == "cpu"
    if ns == 1 and cpu:
        out, tiles = fused_append_attend_plain(
            q, cache_k, cache_v, new_k, new_v, cache_len, seq_tile=tile,
            n_tiles=n_tiles, length_mask=length_mask)
    elif ns == 1:
        out, tiles = _launch(q, cache_k, cache_v, new_k, new_v, cache_len,
                             tile, n_tiles, length_mask)
    elif cpu:
        out, tiles = fused_append_attend_split_plain(
            q, cache_k, cache_v, new_k, new_v, cache_len, seq_tile=tile,
            n_tiles=n_tiles, length_mask=length_mask, num_kv_splits=ns)
    else:
        acc, stats, tiles = split_partials(
            q, cache_k, cache_v, new_k, new_v, cache_len, seq_tile=tile,
            n_tiles=n_tiles, length_mask=length_mask, num_kv_splits=ns)
        out = split_combine(acc, stats, q.dtype, hkv)
    if return_tiles:
        return out, cache_k, cache_v, tiles
    return out, cache_k, cache_v


def _kernel_inputs(name, q, cache_k, cache_v, new_k, new_v, cache_len):
    """Check what the decode kernels take; returns (q, new_k, new_v, lens)
    as the C interface wants them."""
    hkv, d = cache_k.shape[2], cache_k.shape[3]
    h = q.shape[1]
    code = _build.DTYPE_CODE
    if q.dtype not in code or cache_k.dtype not in code:
        raise ValueError(f"{name}: q {q.dtype} / cache {cache_k.dtype} not "
                         f"supported (f32 or bf16)")
    if cache_v.dtype != cache_k.dtype:
        raise ValueError(f"{name}: K and V caches differ in dtype")
    if h // hkv > 32 or d > 128:
        raise ValueError(f"{name}: G={h // hkv} > 32 or D={d} > 128 is not "
                         f"supported")
    q = q.contiguous()
    new_k = new_k.to(cache_k.dtype).contiguous()
    new_v = new_v.to(cache_v.dtype).contiguous()
    lens = cache_len.to(torch.int32).contiguous()
    _build.check_cuda(name, q, cache_k, cache_v, new_k, new_v, lens)
    return q, new_k, new_v, lens


def _launch(q, cache_k, cache_v, new_k, new_v, cache_len, tile, n_tiles,
            length_mask):
    b, s, hkv, d = cache_k.shape
    h = q.shape[1]
    code = _build.DTYPE_CODE
    q, new_k, new_v, lens = _kernel_inputs(
        "fused_append_attend", q, cache_k, cache_v, new_k, new_v, cache_len)
    out = torch.empty_like(q)
    tiles = torch.empty((b,), dtype=torch.int32, device=q.device)
    P = _build.ptr
    KERNEL(P(q), P(cache_k), P(cache_v), P(new_k), P(new_v), P(lens), P(out),
           P(tiles), b, s, hkv, h // hkv, d, tile, n_tiles, int(length_mask),
           1.0 / d ** 0.5, code[q.dtype], code[cache_k.dtype],
           _build.stream_of(q))
    return out, tiles


def split_partials(q, cache_k, cache_v, new_k, new_v, cache_len, *,
                   seq_tile: int, n_tiles: int, length_mask: bool,
                   num_kv_splits: int) -> tuple:
    """Launch stage 1 of split-KV decode (CUDA tensors); the same function
    and return as :func:`split_partials_plain`."""
    b, s, hkv, d = cache_k.shape
    h = q.shape[1]
    code = _build.DTYPE_CODE
    q, new_k, new_v, lens = _kernel_inputs(
        "split_partials", q, cache_k, cache_v, new_k, new_v, cache_len)
    f32 = torch.float32
    acc = torch.empty((b, num_kv_splits, h, d), dtype=f32, device=q.device)
    stats = torch.empty((b, num_kv_splits, h, 2), dtype=f32, device=q.device)
    tiles = torch.empty((b,), dtype=torch.int32, device=q.device)
    P = _build.ptr
    SPLIT_KERNEL(P(q), P(cache_k), P(cache_v), P(new_k), P(new_v), P(lens),
                 P(acc), P(stats), P(tiles), b, s, hkv, h // hkv, d,
                 seq_tile, n_tiles, int(length_mask), num_kv_splits,
                 1.0 / d ** 0.5, code[q.dtype], code[cache_k.dtype],
                 _build.stream_of(q))
    return acc, stats, tiles


def split_combine(acc: torch.Tensor, stats: torch.Tensor, out_dtype,
                  hkv: int) -> torch.Tensor:
    """Launch stage 2 of split-KV decode (CUDA tensors), one block per
    (row, kv head); the same function as :func:`split_combine_plain`."""
    b, ns, h, d = acc.shape
    if out_dtype not in _build.DTYPE_CODE:
        raise ValueError(f"split_combine: {out_dtype} not supported")
    if acc.dtype != torch.float32 or stats.dtype != torch.float32 or \
            stats.shape != (b, ns, h, 2):
        raise ValueError("split_combine: partials must be f32 acc "
                         "[B, ns, H, D] and stats [B, ns, H, 2]")
    _build.check_cuda("split_combine", acc, stats)
    if h % hkv:
        raise ValueError("split_combine: GQA requires H % Hkv == 0")
    out = torch.empty((b, h, d), dtype=out_dtype, device=acc.device)
    COMBINE_KERNEL(_build.ptr(acc), _build.ptr(stats), _build.ptr(out), b,
                   hkv, h // hkv, d, ns, _build.DTYPE_CODE[out_dtype],
                   _build.stream_of(acc))
    return out
