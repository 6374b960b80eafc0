"""Tile-size helpers shared by the length-bounded KV-cache kernels (decode,
chunked prefill).

Both kernels traverse the cache in ``seq_tile``-sized tiles and report how
many tiles each row serviced; these helpers decide the tile size and the
live-tile bound, and therefore the tile counts the engine reports. The
JAX package's Mosaic layout helpers (lane padding, word packing, block
lint) have no meaning on a GPU and are not carried over.
"""
from __future__ import annotations

import warnings

# Preferred divisor alignment for ``fit_seq_tile`` (kept from the JAX
# package so both pick the same fallback tile, hence the same tile counts).
SUBLANE = 8

_fit_warned: set = set()


def live_tile_bound(last_exclusive, seq_tile: int):
    """Tiles covering positions ``[0, last_exclusive)`` — the ONE live-tile
    bound formula shared by the decode and chunked-prefill traversals.

    ``last_exclusive`` is always the EXCLUSIVE end of the live range: the
    decode kernel passes ``cache_len + 1`` (the append position is live
    after the in-traversal write) and the chunk kernel passes the end of
    the chunk's last query position. Accepts ints and integer tensors
    alike."""
    return (last_exclusive + seq_tile - 1) // seq_tile


def clamp_seq_tile(s: int, seq_tile: int) -> int:
    """The kernels' launch-time tile clamp ``max(1, min(seq_tile, s))``,
    with a warning the first time a given ``(s, seq_tile)`` pair clamps
    DOWN: a configured tile larger than the traversed capacity diverges
    from what the launcher validated against the engine's
    ``final_stage_ladder``."""
    t = max(1, min(seq_tile, s))
    if t != seq_tile:
        key = ("clamp", s, seq_tile)
        if key not in _fit_warned:
            _fit_warned.add(key)
            warnings.warn(
                f"seq_tile {seq_tile} exceeds the traversed capacity {s}; "
                f"clamping to {t} — the launch geometry no longer matches "
                f"the validated --seq-tile (validate against "
                f"final_stage_ladder, or pass seq_tile <= capacity)",
                stacklevel=2)
    return t


def fit_seq_tile(s: int, seq_tile: int) -> int:
    """Largest divisor of ``s`` that is <= ``seq_tile``, preferring
    multiples of 8 over raw size. The serving engine's staging lengths are
    whole tile counts, so it never relies on the fallback; the first time a
    given (s, seq_tile) pair clamps, a warning names the fallback tile."""
    t = max(1, min(seq_tile, s))
    if s % t == 0:
        return t
    divisors = [d for d in range(t, 0, -1) if s % d == 0]
    aligned = [d for d in divisors if d % SUBLANE == 0]
    pick = aligned[0] if aligned else divisors[0]
    key = (s, seq_tile)
    if key not in _fit_warned:
        _fit_warned.add(key)
        warnings.warn(
            f"seq_tile {seq_tile} does not divide capacity {s}; clamping to "
            f"the largest {'aligned ' if aligned else ''}divisor {pick}"
            + ("" if aligned else
               f" (not a multiple of {SUBLANE} — pad the capacity to a tile "
               f"multiple instead)"),
            stacklevel=2)
    return pick
