"""The port's paged pool against the JAX pool, driven in lockstep by one
seeded script of operations: prefills, appends with same-cycle reads,
prefix registration, matching and attach (refcount bumps), appends into a
shared tail (copy-on-write), two-traversal batches, frees, and requests the
pool must refuse. After every operation the books (page tables, lengths,
free lists, refcounts, prefix index), the counters (traversals, tile
reads/writes, per-mix histogram, CoW copies) and the storage words agree;
reads agree, and a refused operation raises the same error in both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.memory.paged_kv import PagedPool as JPool
from repro_torch.memory.paged_kv import PagedPool as TPool

WIDTH, PT = 8, 4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _vecs(tokens) -> np.ndarray:
    toks = np.asarray(tokens, np.float32)
    return toks[:, None] + np.arange(WIDTH, dtype=np.float32) / WIDTH


def _same_books(jp, tp):
    assert tp.tables == jp.tables and tp.lengths == jp.lengths
    assert tp.free_by_shard == jp.free_by_shard
    assert dict(tp.refcounts) == dict(jp.refcounts)
    assert tp.prefix_index == jp.prefix_index
    for name in ("traversals", "tile_reads", "tile_writes", "cow_copies",
                 "cow_words", "prefix_attached_tokens",
                 "prefix_attached_pages"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.mix_counts == jp.mix_counts
    np.testing.assert_array_equal(
        tp.storage.numpy(), np.asarray(jp.storage)[:, :jp.io_width])


def _both(jp, tp, op):
    """Run ``op`` on both pools; the same result or the same exception."""
    try:
        want = op(jp)
    except (MemoryError, IndexError, ValueError) as e:
        with pytest.raises(Exception) as got:      # each package's own class
            op(tp)
        assert type(got.value).__name__ == type(e).__name__
        return None
    got = op(tp)
    if isinstance(want, dict) and want.get("read") is not None:
        reads_j, reads_t = want["read"], got["read"]
        if not isinstance(reads_j, list):
            reads_j, reads_t = [reads_j], [reads_t]
        for a, b in zip(reads_t, reads_j):
            np.testing.assert_array_equal(_np(a), _np(b))
    return want


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pool_scripted_ops_match_jax(use_kernel):
    rng = np.random.default_rng(5)
    kw = dict(n_pages=12, page_tokens=PT, word_width=WIDTH, num_banks=4,
              use_kernel=use_kernel, seq_tile=PT)
    jp = JPool.create(dtype=jnp.float32, **kw)
    tp = TPool.create(dtype=torch.float32, device="cpu", **kw)
    toks: dict = {}                        # seq -> its tokens so far
    next_seq = 1
    for step in range(40):
        live = sorted(toks)
        kind = rng.choice(["prefill", "append", "share", "batch", "free",
                           "refuse"], p=[.2, .3, .15, .15, .12, .08])
        if kind == "prefill" or not live:
            seq, next_seq = next_seq, next_seq + 1
            t = [int(x) for x in rng.integers(0, 6, int(rng.integers(1, 9)))]
            if _both(jp, tp, lambda p: p.cycle(
                    prefill={"seq": seq, "vectors": _vecs(t)})) is not None:
                toks[seq] = t
                _both(jp, tp, lambda p: p.register_prefix(seq, t))
        elif kind == "append":
            seq = int(rng.choice(live))
            t = [int(x) for x in rng.integers(0, 6, int(rng.integers(1, 3)))]
            n = len(toks[seq]) + len(t)
            if _both(jp, tp, lambda p: p.cycle(
                    append={"seq": seq, "vectors": _vecs(t)},
                    read={"seq": seq, "positions": np.arange(n)})) is not None:
                toks[seq] += t
        elif kind == "share":                   # attach a registered prefix
            src = int(rng.choice(live))
            head = toks[src][: int(rng.integers(1, len(toks[src]) + 1))]
            m_j, m_t = jp.match_prefix(head), tp.match_prefix(head)
            assert (m_j is None) == (m_t is None)
            if m_j is None:
                continue
            assert (m_t.tokens, m_t.full_pages, tuple(m_t.pages)) == \
                (m_j.tokens, m_j.full_pages, tuple(m_j.pages))
            seq, next_seq = next_seq, next_seq + 1
            jp.attach_prefix(seq, m_j)
            tp.attach_prefix(seq, m_t)
            toks[seq] = list(head[: m_j.tokens])
        elif kind == "batch":                   # two traversals, one cycle
            a, b = int(rng.choice(live)), int(rng.choice(live))
            t = [int(rng.integers(0, 6))]
            groups = [({"append": {"seq": a, "vectors": _vecs(t)}},
                       (0, 1, 2, 3)),
                      ({"read": {"seq": b, "positions":
                                 np.arange(len(toks[b]) + (a == b))}},
                       (1, 0, 2, 3))]
            got = _both(jp, tp, lambda p: p.cycle_batch(groups))
            if got is not None:
                toks[a] += t
        elif kind == "free":
            seq = int(rng.choice(live))
            _both(jp, tp, lambda p: p.free(seq))
            del toks[seq]
        else:                                   # the pool must refuse these
            seq = int(rng.choice(live))
            _both(jp, tp, lambda p: p.cycle(
                read={"seq": seq, "positions": np.arange(len(toks[seq]) + 3)}))
            _both(jp, tp, lambda p: p.cycle(
                prefill={"seq": 99, "vectors": np.ones((64, WIDTH),
                                                       np.float32)}))
        _same_books(jp, tp)
    assert jp.traversals > 20 and jp.cow_copies >= 1
