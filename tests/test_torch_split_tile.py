"""Stage 1 of split-KV decode (B4a) as the kernel tiles it, checked on the
CPU through its host-side mirror (``kv_multiport.split_bank_range``,
``split_stage_plan``, ``split_geometry``): every live key of a row is
scored exactly once, for every head, by the one bank that owns its tile,
through a ring that fits a block's shared memory. The kernel itself is
held against its plain version on the card by ``test_torch_cuda.py``."""
import re
from collections import Counter
from pathlib import Path

import pytest

from repro_torch.kernels import kv_multiport as kvmp

# the ring that stage 1 and the serial kernel share
SOURCE = (Path(kvmp.__file__).resolve().parent.parent / "csrc"
          / "decode_attend.cuh")
MAX_SCORES = 8              # heads one thread scores (G <= 32)


def _plain_owner(pos: int, p: int, tile: int, ns: int) -> int:
    """The bank that the plain split version (and the JAX kernel) gives the
    tile of ``pos``."""
    row_tiles = -(-(p + 1) // tile)
    per_split = max(-(-row_tiles // ns), 1)
    return min((pos // tile) // per_split, ns - 1)


def _scored(lens, *, s, tile, n_tiles, ns, g):
    """{(row, pos, head): times scored, by which banks} over the mirror."""
    seen = Counter()
    owner = {}
    for row, p in enumerate(lens):
        for bank in range(ns):
            lo, hi = kvmp.split_bank_range(p, bank, seq_tile=tile,
                                           n_tiles=n_tiles, s=s,
                                           num_kv_splits=ns)
            for stage in kvmp.split_stage_plan(lo, hi, g):
                per_thread = Counter(t for t, _, _ in stage)
                assert max(per_thread.values(), default=0) <= MAX_SCORES
                for _, pos, h in stage:
                    assert lo <= pos < hi
                    seen[row, pos, h] += 1
                    owner[row, pos] = bank
    return seen, owner


# the ragged lens of the on-card split test (S 128, tile 16) and the long
# path's decode shape (S 2048, tile 64) with p on stage boundaries
LENS = {"short": (128, 16, [0, 3, 15, 16, 17, -1, 90, 127]),
        "long": (2048, 64, [1919, 1920, 1983, 255, 256, 511, -1, 2047])}


@pytest.mark.parametrize("case", sorted(LENS))
@pytest.mark.parametrize("ns", range(1, 9))
def test_every_live_key_is_scored_once_by_its_bank(case, ns):
    s, tile, lens = LENS[case]
    for g in (1, 7, 8, 32):
        seen, owner = _scored(lens, s=s, tile=tile, n_tiles=s // tile, ns=ns,
                              g=g)
        want = {(row, pos, h) for row, p in enumerate(lens)
                for pos in range(p + 1) for h in range(g)}
        assert set(seen) == want
        assert set(seen.values()) <= {1}
        for (row, pos), bank in owner.items():
            assert bank == _plain_owner(pos, lens[row], tile, ns)


@pytest.mark.parametrize("ns", range(1, 9))
def test_the_append_position_lies_in_one_bank_only(ns):
    """Position p, which the loader takes from new_k/new_v and the W port
    writes, lies in exactly one bank's range (none for a dead row or a p
    past the staged prefix)."""
    s, tile, lens = LENS["short"]
    for n_tiles in (s // tile, 2):
        for p in lens:
            ranges = [kvmp.split_bank_range(p, bank, seq_tile=tile,
                                            n_tiles=n_tiles, s=s,
                                            num_kv_splits=ns)
                      for bank in range(ns)]
            holders = [r for r in ranges if r[0] <= p < r[1]]
            live = 0 <= p < n_tiles * tile
            assert len(holders) == (1 if live else 0)


@pytest.mark.parametrize("cache_bytes", [2, 4])
def test_split_geometry_fits_every_supported_head_layout(cache_bytes):
    """At least two ring stages fit a block's shared memory for every G <=
    32 and D <= 128; rows load as 16-byte copies exactly when a row is a
    whole number of them; the row pitch keeps 16-byte alignment."""
    for g in range(1, 33):
        for d in range(1, 129):
            geo = kvmp.split_geometry(g, d, cache_bytes)
            assert 2 <= geo["stages"] <= kvmp.SPLIT_MAX_STAGES
            assert geo["smem_bytes"] <= kvmp.SMEM_LIMIT
            assert geo["pitch"] % 16 == 0 and geo["pitch"] > d * cache_bytes
            assert geo["vector_loader"] == (d * cache_bytes % 16 == 0)
    # the long path's call: G 8, D 64, f32 caches: a 256-key bank in flight
    geo = kvmp.split_geometry(8, 64, 4)
    assert geo["stages"] * kvmp.SPLIT_STAGE_KEYS == 256


@pytest.mark.parametrize("g,d", [(0, 64), (33, 64), (8, 0), (8, 129)])
def test_split_geometry_rejects_what_the_kernel_cannot_take(g, d):
    with pytest.raises(ValueError):
        kvmp.split_geometry(g, d, 4)


def test_split_geometry_mirrors_the_source():
    """The mirror and the CUDA source name the same tiling."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("KS") == kvmp.SPLIT_STAGE_KEYS
    assert const("THREADS") == kvmp.SPLIT_THREADS
    assert const("MAX_STAGES") == kvmp.SPLIT_MAX_STAGES
    assert const("SMEM_LIMIT") == kvmp.SMEM_LIMIT
    assert "constexpr int SP = KS + 4;" in src
    assert "g.pitch = (D * esize + 15) / 16 * 16 + 16;" in src
    assert "cp.async.cg.shared.global" in src
    assert "const int jr = tid % KS, hr = tid / KS;" in src
