"""The serial fused decode (B1) as one clustered launch, checked on the CPU
through its host-side mirror: the cluster size C that the wrapper picks
from the staged tile count (``kv_multiport.cluster_size``), and the key
partition of block r of the cluster (``split_bank_range`` with
``num_kv_splits=C``, the split-KV partition): every live key of a row is
owned by exactly one block, in whole seq_tiles, the append position by the
one block that writes it, a dead row by none. The kernel itself is held
against its plain version on the card by ``test_torch_cuda.py``."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import kv_multiport as kvmp

CSRC = Path(kvmp.__file__).resolve().parent.parent / "csrc"


def _shares(p, c, *, s, tile, n_tiles):
    return [kvmp.split_bank_range(p, r, seq_tile=tile, n_tiles=n_tiles, s=s,
                                  num_kv_splits=c) for r in range(c)]


@pytest.mark.parametrize("n_tiles,tile,want", [
    (1, 64, 1), (2, 64, 1),          # the short path: 128 staged keys
    (32, 64, 8), (64, 64, 8),        # the long path's 2K context, and past
    (4, 64, 1), (8, 64, 2), (16, 64, 4), (8, 16, 1), (128, 16, 8)])
def test_cluster_size_comes_from_the_staged_tiles(n_tiles, tile, want):
    """One block per full ring of staged keys (256), 1 to 8 blocks."""
    assert kvmp.cluster_size(n_tiles, tile) == want


@pytest.mark.parametrize("n_tiles,tile", [(0, 64), (2, 0), (-1, 64)])
def test_cluster_size_rejects_an_empty_geometry(n_tiles, tile):
    with pytest.raises(ValueError):
        kvmp.cluster_size(n_tiles, tile)


# clusters of c serial-kernel blocks an H100 80GB HBM3 holds at once at the
# long call's heads (G 8, D 64, bf16 q over f32 caches): cluster_fit in
# chip_smoke.py's runs (PERF.md, PR 16)
H100_FIT = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


@pytest.mark.parametrize("fit,want", [
    (H100_FIT, 6),                   # the card: 15 clusters of 7 or 8
    ({8: 15, 7: 16}, 7),
    ({8: 16}, 8), ({8: 4, 7: 8, 6: 12, 5: 16}, 5),
    ({c: 1 for c in range(1, 9)}, 8)])   # no size fits: the cap
def test_cluster_size_keeps_the_call_in_one_wave(fit, want):
    """The long call's 16 (row, kv head) clusters over 32 staged tiles:
    the largest C whose 16 clusters the card holds at once."""
    assert kvmp.cluster_size(32, 64, rows=16,
                             fit=lambda c: fit.get(c, 10 ** 6)) == want


def test_cluster_size_never_passes_the_portable_cluster():
    for n_tiles in range(1, 300):
        for tile in (8, 16, 64, 128):
            c = kvmp.cluster_size(n_tiles, tile)
            assert 1 <= c <= kvmp.MAX_CLUSTER
            # one block per ring of staged keys, as far as the cap allows
            assert c == kvmp.MAX_CLUSTER or \
                c == max(1, n_tiles * tile // kvmp.CLUSTER_KEYS)


# S, seq_tile and append positions: p = 0, tile edges, share edges under
# 8 banks at the long context (1536, 1792), the last position, a dead row
LENS = {"short": (128, 16, [0, 3, 15, 16, 17, 90, 127, -1]),
        "long": (2048, 64, [0, 63, 64, 65, 511, 512, 1536, 1552, 1792,
                            1932, 2047, -1])}


@pytest.mark.parametrize("case", sorted(LENS))
@pytest.mark.parametrize("c", range(1, 9))
def test_every_live_key_is_owned_once(case, c):
    """The shares of a row's C blocks tile [0, min(p + 1, staged)) in bank
    order, each starting on a seq_tile; past it no block reads a key."""
    s, tile, lens = LENS[case]
    for n_tiles in (s // tile, 2):
        end_cap = min(n_tiles * tile, s)
        for p in lens:
            shares = _shares(p, c, s=s, tile=tile, n_tiles=n_tiles)
            owned = [k for lo, hi in shares for k in range(lo, hi)]
            want = list(range(min(p + 1, end_cap))) if p >= 0 else []
            assert owned == want
            for lo, hi in shares:
                assert lo <= hi
                assert hi == lo or lo % tile == 0


@pytest.mark.parametrize("c", range(1, 9))
def test_the_append_position_is_written_by_one_block(c):
    """p lies in exactly one share when it is staged (that block writes the
    row and overlays it); in none for a dead row or a p past the staged
    prefix. The appended key is always the last key of its share."""
    s, tile, lens = LENS["long"]
    for n_tiles in (s // tile, 4):
        for p in lens:
            shares = _shares(p, c, s=s, tile=tile, n_tiles=n_tiles)
            holders = [(lo, hi) for lo, hi in shares if lo <= p < hi]
            staged = 0 <= p < min(n_tiles * tile, s)
            assert len(holders) == (1 if staged else 0)
            if staged:
                assert holders[0][1] == p + 1


def test_p_at_a_share_first_key_and_empty_shares():
    """The cases the on-card test reaches: p alone in its share (first key
    = last key), p = 0 with every other block empty, and a dead row whose
    blocks are all empty yet all reach the cluster barriers."""
    s, tile = 2048, 64
    shares = _shares(1536, 8, s=s, tile=tile, n_tiles=32)
    assert (1536, 1537) in shares               # p is its share's first key
    shares = _shares(0, 8, s=s, tile=tile, n_tiles=32)
    assert shares[0] == (0, 1) and all(lo == hi for lo, hi in shares[1:])
    assert all(lo == hi == 0 for lo, hi in _shares(-1, 8, s=s, tile=tile,
                                                   n_tiles=32))


def test_the_long_call_splits_into_ring_sized_shares():
    """At the long call (S 2048, tile 64, 16 clusters) the card takes C = 6:
    every share but the last live one is a whole number of 64-key ring
    stages, and none is longer than ceil(32 / 6) = 6 tiles (384 keys, one
    and a half rings of the shared geometry's 4 stages), so a block's ring
    turns over at most once."""
    s, tile = 2048, 64
    c = kvmp.cluster_size(s // tile, tile, rows=16, fit=H100_FIT.get)
    assert c == 6
    ring = kvmp.split_geometry(8, 64, 4)["stages"] * kvmp.SPLIT_STAGE_KEYS
    assert ring == 256
    for p in (1552, 1788, 1795, 1932, 2047):
        shares = _shares(p, c, s=s, tile=tile, n_tiles=32)
        live = [(lo, hi) for lo, hi in shares if hi > lo]
        for lo, hi in live[:-1]:
            assert (hi - lo) % kvmp.SPLIT_STAGE_KEYS == 0
        longest = max(hi - lo for lo, hi in shares)
        assert longest <= 6 * tile and longest <= 2 * ring


def test_the_mirror_names_the_source():
    """The wrapper's cluster cap and the kernel's are one number, the
    partition is decode_attend.cuh's bank_range, and the merge is one
    launch: a cluster launch and two cluster barriers, no second kernel."""
    src = (CSRC / "kv_multiport.cu").read_text()
    cap = int(re.search(r"constexpr int MAX_CLUSTER = (\d+);", src).group(1))
    assert cap == kvmp.MAX_CLUSTER
    assert "bank_range(p, r, C, seq_tile, n_tiles, S, lo, hi);" in src
    assert "cudaLaunchAttributeClusterDimension" in src
    assert src.count("this_cluster().sync();") == 2
    assert src.count("__global__") == 1       # one kernel, C = 1 included
    assert "map_shared_rank" in src


def test_the_cpu_path_counts_no_launch_and_matches_the_split_plain():
    """On CPU tensors the serial wrapper runs the plain version (no launch);
    it agrees with the plain split version at ns = C, which is the function
    the cluster computes."""
    gen = torch.Generator().manual_seed(0)
    b, s, hkv, g, d, tile = 3, 256, 2, 4, 16, 16
    rnd = lambda *sh: torch.randn(sh, generator=gen)  # noqa: E731
    q, nk, nv = rnd(b, hkv * g, d), rnd(b, hkv, d), rnd(b, hkv, d)
    ck, cv = rnd(b, s, hkv, d), rnd(b, s, hkv, d)
    ln = torch.tensor([200, -1, 31], dtype=torch.int32)
    before = kvmp.KERNEL.launches
    o, ck1, cv1, t = kvmp.fused_append_attend(
        q, ck.clone(), cv.clone(), nk, nv, ln, seq_tile=tile,
        dynamic_grid=True, return_tiles=True)
    assert kvmp.KERNEL.launches == before
    c = kvmp.cluster_size(s // tile, tile)
    o_c, t_c = kvmp.fused_append_attend_split_plain(
        q, ck.clone(), cv.clone(), nk, nv, ln, seq_tile=tile,
        n_tiles=s // tile, length_mask=True, num_kv_splits=c)
    torch.testing.assert_close(o, o_c, atol=1e-5, rtol=1e-5)
    assert torch.equal(t, t_c)
