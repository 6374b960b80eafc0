"""Each CUDA kernel of the port against its plain torch version, on the card.

These tests need a CUDA device and the CUDA toolkit (the kernels are built
by ``nvcc`` at first use); without a card they skip. They import no JAX, so
they run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerances are those of the JAX suite (``tests/kernels/
test_attention_kernels.py``): f32 1e-5 with TF32 off, bf16 4e-2 (flash
attention: 2e-5 and 5e-2, that suite's flash cases). Cache updates,
serviced-tile counts and the pool step are bit-exact.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core import MemorySpec, PortConfig, PortRequest, step
from repro_torch.core.ports import READ, WRITE
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_multiport as kvmp
from repro_torch.kernels import kv_prefill_chunk as kvpc
from repro_torch.kernels import launch_counts
from repro_torch.kernels import multiport_sram as mps
from repro_torch.kernels import ops

F32_TOL, BF16_TOL = 1e-5, 4e-2
DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, dev, dt, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
        .to(dev, DT[dt])


def _ints(dev, xs):
    return torch.tensor(xs, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,cdt", [("f32", "f32"), ("bf16", "f32"),
                                     ("bf16", "bf16")])
@pytest.mark.parametrize("mode", [dict(), dict(length_mask=False),
                                  dict(live_len=64)])
def test_decode_kernel_on_card(rng, cuda_device, qdt, cdt, mode):
    """Ragged lengths, appends at 0 and at tile edges, a dead row."""
    s, hkv, g, d, tile = 128, 4, 8, 64, 16
    lens = [0, tile - 1, tile, tile + 1, -1, 100, s - 1]
    b = len(lens)
    q = _normal(rng, cuda_device, qdt, b, hkv * g, d)
    ck, cv = (_normal(rng, cuda_device, cdt, b, s, hkv, d) for _ in "kv")
    nk, nv = (_normal(rng, cuda_device, cdt, b, hkv, d) for _ in "kv")
    ln = _ints(cuda_device, lens)
    ck_p, cv_p = ck.clone(), cv.clone()
    o, _, _, t = kvmp.fused_append_attend(q, ck, cv, nk, nv, ln,
                                          seq_tile=tile, return_tiles=True,
                                          **mode)
    _, n = kvmp.launch_geometry(s, tile, mode.get("live_len"), False)
    o_p, t_p = kvmp.fused_append_attend_plain(
        q, ck_p, cv_p, nk, nv, ln, seq_tile=tile, n_tiles=n,
        length_mask=mode.get("length_mask", True))
    tol = F32_TOL if qdt == cdt == "f32" else BF16_TOL
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)
    assert torch.equal(t, t_p)
    assert not o[lens.index(-1)].float().abs().any()      # dead row: zeros


CHUNK_CASES = {
    # 16 chunk rows x 32 heads over two query-row blocks: offsets at 0 and
    # at tile edges, a one-row and an empty chunk, a dead row
    "short": dict(s=128, c=16, tile=16, d=64,
                  off=[0, 15, 16, 40, -1, 100, 3],
                  cl=[16, 16, 1, 9, 0, 16, 0]),
    # a head dim that is not a multiple of 4: the element-wise K/V loader
    "odd_dim": dict(s=128, c=16, tile=16, d=18, off=[0, 15, 16, -1, 100],
                    cl=[16, 1, 9, 0, 16]),
    # the long path's shape: C = 128 over a 2K context, offsets at
    # k*64 - 1, k*64 and k*64 + 1, lens 0, 1 and C, a dead row
    "long": dict(s=2048, c=128, tile=64, d=64,
                 off=[639, 1280, 1601, -1, 320, 1919],
                 cl=[128, 1, 0, 0, 128, 128]),
    # the MoE and model-level heads: deepseek-moe-16b's chunk (G 1, D 128
    # over 16 kv heads: the DP = 128 build), qwen2-vl-7b's (G 7, D 128)
    # and musicgen-large's (G 1, D 64 over 32 kv heads)
    "g1_d128": dict(s=128, c=16, tile=64, d=128, hkv=16, g=1,
                    off=[0, 63, 64, -1, 100, 3], cl=[16, 16, 1, 0, 16, 9]),
    "g7_d128": dict(s=256, c=128, tile=128, d=128, hkv=4, g=7,
                    off=[0, 127, -1, 64], cl=[128, 1, 0, 100]),
    "g1_d64_h32": dict(s=256, c=128, tile=128, d=64, hkv=32, g=1,
                       off=[0, 127, -1, 64], cl=[128, 1, 0, 100]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
@pytest.mark.parametrize("qdt,cdt", [("f32", "f32"), ("bf16", "f32"),
                                     ("bf16", "bf16")])
def test_chunk_kernel_on_card(rng, cuda_device, qdt, cdt, case):
    """B2 against its plain version; caches and tile counts bit-exact."""
    kw = CHUNK_CASES[case]
    s, c, tile, d = kw["s"], kw["c"], kw["tile"], kw["d"]
    off, cl = kw["off"], kw["cl"]
    hkv, g = kw.get("hkv", 4), kw.get("g", 8)
    b = len(off)
    q = _normal(rng, cuda_device, qdt, b, c, hkv * g, d)
    ck, cv = (_normal(rng, cuda_device, cdt, b, s, hkv, d) for _ in "kv")
    nk, nv = (_normal(rng, cuda_device, cdt, b, c, hkv, d) for _ in "kv")
    of, ln = _ints(cuda_device, off), _ints(cuda_device, cl)
    ck_p, cv_p = ck.clone(), cv.clone()
    before = launch_counts()["kv_chunk_append_attend"]
    o, _, _, t = kvpc.fused_chunk_append_attend(
        q, ck, cv, nk, nv, of, ln, seq_tile=tile, return_tiles=True)
    assert launch_counts()["kv_chunk_append_attend"] == before + 1
    o_p, t_p = kvpc.fused_chunk_append_attend_plain(
        q, ck_p, cv_p, nk, nv, of, ln, seq_tile=tile, n_tiles=s // tile)
    tol = F32_TOL if qdt == cdt == "f32" else BF16_TOL
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)
    assert torch.equal(t, t_p)
    assert not o[off.index(-1)].float().abs().any()       # dead row: zeros


def _pool_ports(rng, dev, dt, words, width, roles, q, lanes_on):
    """Packed ports whose later ports hit half of port 0's words; write
    lanes deduplicated (last wins); payloads for the write slots only."""
    addr = rng.integers(0, words, (len(roles), q)).astype(np.int32)
    addr[1:, : q // 2] = addr[0, : q // 2]
    mask = np.zeros((len(roles), q), bool)
    for slot, role in enumerate(roles):
        mask[slot, rng.choice(q, lanes_on[slot], replace=False)] = True
        if role == WRITE:
            last = {w: i for i, w in enumerate(addr[slot])}
            mask[slot] &= [last[w] == i for i, w in enumerate(addr[slot])]
    data = [_normal(rng, dev, dt, q, width) for r in roles if r == WRITE]
    return (torch.from_numpy(addr).to(dev), data,
            torch.from_numpy(mask).to(dev))


def _pool_against_plain(storage, addr, data, mask, roles):
    st_p = storage.clone()
    before = launch_counts()["multiport_sram_step"]
    r_k = mps.multiport_sram_step(storage, addr, data, mask, roles=roles)
    assert launch_counts()["multiport_sram_step"] == before + 1
    r_p = mps.multiport_sram_step_plain(st_p, addr, data, mask, roles=roles)
    n_reads = sum(1 for r in roles if r != WRITE)
    assert r_k.shape == (n_reads, addr.shape[1], storage.shape[1])
    assert torch.equal(storage, st_p) and torch.equal(r_k, r_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
# 300: 16-byte moves in f32, 8-byte in bf16; 11264 (the full tinyllama
# word): 16-byte moves; 11263: 4-byte (f32) and 2-byte (bf16) moves;
# 114688 (the full deepseek-moe-16b word: 28 x 2 x 16 x 128)
@pytest.mark.parametrize("width", [300, 11264, 11263, 114688])
@pytest.mark.parametrize("roles", [(WRITE, READ, WRITE, READ),
                                   (WRITE, WRITE, READ), (READ,),
                                   (READ, WRITE, READ), (READ, READ, WRITE)])
def test_pool_step_kernel_on_card(rng, cuda_device, dt, width, roles):
    """Bit-exact, with ports that hit words an earlier port read or wrote
    this cycle (W->R, R->W, W->W)."""
    words, q = 512, 64
    storage = _normal(rng, cuda_device, dt, words, width)
    addr, data, mask = _pool_ports(rng, cuda_device, dt, words, width, roles,
                                   q, [52] * len(roles))
    _pool_against_plain(storage, addr, data, mask, roles)


@pytest.mark.cuda
@pytest.mark.parametrize("roles,lanes_on", [((WRITE, READ), (4, 7080)),
                                            ((WRITE,), (7080,)),
                                            ((READ,), (9,))])
def test_pool_step_kernel_on_card_at_the_long_call(rng, cuda_device, roles,
                                                   lanes_on):
    """The long path's shapes: Q 8192 over the full tinyllama pool, a decode
    gather (4 appends, 7080 reads), a scrub of 7080 words, and a read with
    most lanes off."""
    words, width, q = 8192, 11264, 8192
    storage = _normal(rng, cuda_device, "f32", words, width)
    addr, data, mask = _pool_ports(rng, cuda_device, "f32", words, width,
                                   roles, q, lanes_on)
    _pool_against_plain(storage, addr, data, mask, roles)


@pytest.mark.cuda
def test_multiport_step_with_a_write_port_never_syncs(rng, cuda_device):
    """``ops.multiport_step`` with write ports (deduplication included) and
    a read port queues its work without waiting on the card."""
    spec = MemorySpec(num_words=256, word_width=300)
    storage = spec.init_storage(device=cuda_device)
    reqs = []
    for _ in range(4):
        addr = torch.from_numpy(rng.integers(0, 300, 64).astype(np.int32))
        reqs.append(PortRequest(addr=addr.to(cuda_device),
                                data=_normal(rng, cuda_device, "f32", 64, 300),
                                mask=torch.from_numpy(rng.random(64) > 0.3)
                                .to(cuda_device)))
    cfg = PortConfig(enabled=(True, True, True, False),
                     roles=(WRITE, READ, WRITE, READ))
    want, want_reads = step(spec, cfg, storage, reqs)
    ops.multiport_step(spec, cfg, storage.clone(), reqs)     # builds, loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, reads = ops.multiport_step(spec, cfg, storage, reqs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
    for r, w in zip(reads, want_reads):
        assert torch.equal(r, w)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,cdt", [("f32", "f32"), ("bf16", "f32")])
@pytest.mark.parametrize("ns", [2, 3, 8])
@pytest.mark.parametrize("mode", [dict(), dict(length_mask=False),
                                  dict(live_len=96)])
def test_split_kv_kernels_on_card(rng, cuda_device, qdt, cdt, ns, mode):
    """Split-KV stage 1 + stage 2 against the plain split version: ragged
    lengths, a dead row, a row shorter than one split, appends at tile
    edges; caches and tile counts identical to the serial kernel."""
    s, hkv, g, d, tile = 128, 4, 8, 64, 16
    lens = [0, 3, tile - 1, tile, tile + 1, -1, 90, s - 1]
    if "live_len" in mode:
        lens = [min(x, 95) for x in lens]
    b = len(lens)
    q = _normal(rng, cuda_device, qdt, b, hkv * g, d)
    ck, cv = (_normal(rng, cuda_device, cdt, b, s, hkv, d) for _ in "kv")
    nk, nv = (_normal(rng, cuda_device, cdt, b, hkv, d) for _ in "kv")
    ln = _ints(cuda_device, lens)
    ck_p, cv_p, ck_1, cv_1 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    before = launch_counts()
    o, _, _, t = kvmp.fused_append_attend(q, ck, cv, nk, nv, ln,
                                          seq_tile=tile, num_kv_splits=ns,
                                          return_tiles=True, **mode)
    after = launch_counts()
    assert after["kv_decode_split_partial"] == \
        before["kv_decode_split_partial"] + 1
    assert after["kv_decode_split_combine"] == \
        before["kv_decode_split_combine"] + 1
    assert after["kv_decode_append_attend"] == \
        before["kv_decode_append_attend"]
    _, n = kvmp.launch_geometry(s, tile, mode.get("live_len"), False)
    o_p, t_p = kvmp.fused_append_attend_split_plain(
        q, ck_p, cv_p, nk, nv, ln, seq_tile=tile, n_tiles=n,
        length_mask=mode.get("length_mask", True), num_kv_splits=ns)
    o_1, _, _, t_1 = kvmp.fused_append_attend(q, ck_1, cv_1, nk, nv, ln,
                                              seq_tile=tile,
                                              return_tiles=True, **mode)
    tol = F32_TOL if qdt == cdt == "f32" else BF16_TOL
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(o.float(), o_1.float(), atol=tol, rtol=tol)
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)
    assert torch.equal(ck, ck_1) and torch.equal(cv, cv_1)
    assert torch.equal(t, t_p) and torch.equal(t, t_1)
    assert not o[lens.index(-1)].float().abs().any()      # dead row: zeros


@pytest.mark.cuda
def test_split_kv_stages_against_their_plain_versions(rng, cuda_device):
    """Each stage alone: stage 1's partials (m equal, -inf where a bank is
    empty) and stage 2 on the kernel's own partials."""
    s, hkv, g, d, tile, ns = 256, 4, 8, 64, 32, 4
    lens = [0, 20, 100, 255, -1]
    b = len(lens)
    q = _normal(rng, cuda_device, "f32", b, hkv * g, d)
    ck, cv = (_normal(rng, cuda_device, "f32", b, s, hkv, d) for _ in "kv")
    nk, nv = (_normal(rng, cuda_device, "f32", b, hkv, d) for _ in "kv")
    ln = _ints(cuda_device, lens)
    kw = dict(seq_tile=tile, n_tiles=s // tile, length_mask=True,
              num_kv_splits=ns)
    acc, st, t = kvmp.split_partials(q, ck.clone(), cv.clone(), nk, nv, ln,
                                     **kw)
    acc_p, st_p, t_p = kvmp.split_partials_plain(q, ck.clone(), cv.clone(),
                                                 nk, nv, ln, **kw)
    assert torch.equal(t, t_p)
    assert torch.equal(torch.isinf(st[..., 0]), torch.isinf(st_p[..., 0]))
    torch.testing.assert_close(st, st_p, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(acc, acc_p, atol=1e-4, rtol=1e-5)
    out = kvmp.split_combine(acc, st, torch.float32)
    out_p = kvmp.split_combine_plain(acc, st, torch.float32)
    torch.testing.assert_close(out, out_p, atol=F32_TOL, rtol=F32_TOL)


def _partials(rng, dev, b, ns, h, d):
    """Stage-1 partials on the card: bank maxima shifted by -80, 0 or +80
    (exp underflows between banks), row 0 dead (every bank empty), row 1
    with empty banks between live ones, other banks empty at random; an
    empty bank is (acc 0, m -inf, l 0)."""
    m = rng.normal(size=(b, ns, h)) * 3 \
        + rng.choice([-80.0, 0.0, 80.0], size=(b, ns, 1))
    l = rng.uniform(0.5, 40.0, size=(b, ns, h))
    acc = rng.normal(size=(b, ns, h, d)) * l[..., None]
    empty = rng.random((b, ns)) < 0.3
    empty[0] = True
    empty[1] = np.arange(ns) % 2 == 1
    empty[1, -1] = False
    m[empty], l[empty], acc[empty] = -np.inf, 0.0, 0.0
    stats = np.stack([m, l], axis=-1)
    return (torch.from_numpy(acc.astype(np.float32)).to(dev),
            torch.from_numpy(stats.astype(np.float32)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [12, 18, 64, 128])
@pytest.mark.parametrize("g", [1, 7, 8, 32])
@pytest.mark.parametrize("ns", [1, 2, 3, 8, 17, 64])
def test_split_combine_on_card(rng, cuda_device, ns, g, d, dt):
    """Stage 2 alone against its plain version on the same partials: one
    chunk of banks, several and a ragged last one (17, 64); 4-dim threads
    and 1-dim threads (D 12 / 18); dead rows give zeros."""
    acc, st = _partials(rng, cuda_device, b=3, ns=ns, h=2 * g, d=d)
    out = kvmp.split_combine(acc, st, DT[dt])
    want = kvmp.split_combine_plain(acc, st, DT[dt])
    tol = F32_TOL if dt == "f32" else BF16_TOL
    assert out.dtype == DT[dt]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert not out[0].float().abs().any()


@pytest.mark.cuda
def test_split_combine_on_card_off_the_vector_boundary(rng, cuda_device):
    """acc 4 bytes off a 16-byte boundary: 1-dim threads at D = 64."""
    acc, st = _partials(rng, cuda_device, b=3, ns=8, h=16, d=64)
    buf = torch.empty(acc.numel() + 1, device=cuda_device)
    off = buf[1:].view(acc.shape)
    off.copy_(acc)
    torch.testing.assert_close(kvmp.split_combine(off, st, torch.float32),
                               kvmp.split_combine_plain(acc, st,
                                                        torch.float32),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
def test_split_pairs_back_to_back_read_their_own_partials(rng, cuda_device):
    """200 split decodes queued on one stream with no sync between them,
    at the long call's shape, while a spin kernel holds the card: the card
    then runs the 400 launches back to back, so each stage 2's launch is
    processed while its stage 1 runs (programmatic dependent launch), and
    it must read that stage 1's partials, not the last step's in the same
    reused buffers. The test checks that the host queued every step before
    the spin ended. Every output equals the plain split path's at 1e-5,
    caches identical."""
    s, hkv, g, d, tile, ns, steps = 2048, 4, 8, 64, 64, 8, 200
    lens0 = np.array([1500, 1200, 1700, 1600])
    b = len(lens0)
    ck, cv = (_normal(rng, cuda_device, "f32", b, s, hkv, d) for _ in "kv")
    ck_p, cv_p = ck.clone(), cv.clone()
    qs = _normal(rng, cuda_device, "f32", steps, b, hkv * g, d)
    nks, nvs = (_normal(rng, cuda_device, "f32", steps, b, hkv, d)
                for _ in "kv")
    lens = [_ints(cuda_device, (lens0 + i).tolist()) for i in range(steps)]
    kw = dict(seq_tile=tile, dynamic_grid=True, num_kv_splits=ns)
    kvmp.fused_append_attend(qs[0], ck.clone(), cv.clone(), nks[0], nvs[0],
                             lens[0], **kw)     # build and load the kernels
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)            # about half a second
    spun = torch.cuda.Event()
    spun.record()
    got = [kvmp.fused_append_attend(qs[i], ck, cv, nks[i], nvs[i], lens[i],
                                    **kw)[0] for i in range(steps)]
    queued_ahead = not spun.query()
    torch.cuda.synchronize()
    assert queued_ahead, "the card reached the steps before they were queued"
    for i in range(steps):
        want, _ = kvmp.fused_append_attend_split_plain(
            qs[i], ck_p, cv_p, nks[i], nvs[i], lens[i], seq_tile=tile,
            n_tiles=s // tile, length_mask=True, num_kv_splits=ns)
        torch.testing.assert_close(got[i], want, atol=F32_TOL, rtol=F32_TOL,
                                   msg=lambda m, i=i: f"step {i}: {m}")
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)


SPLIT_RING_CASES = [  # G, D, q dtype, cache dtype
    (8, 64, "f32", "f32"), (8, 64, "bf16", "f32"),   # tinyllama's heads
    (1, 64, "f32", "f32"), (7, 128, "f32", "f32"), (32, 128, "f32", "f32"),
    (32, 18, "f32", "f32"),                          # element-wise loader
    (8, 18, "bf16", "bf16"), (8, 64, "bf16", "bf16"), (7, 128, "bf16", "bf16"),
    (32, 64, "f32", "bf16"), (8, 12, "f32", "bf16"),  # 24-byte bf16 rows
    (1, 128, "f32", "f32"), (1, 128, "bf16", "f32"),  # deepseek-moe-16b's
]


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,qdt,cdt", SPLIT_RING_CASES)
@pytest.mark.parametrize("ns", [2, 8])
def test_split_kv_ring_on_card(rng, cuda_device, g, d, qdt, cdt, ns):
    """Stage 1's ring over a 2K context: at ns 2 a bank (1024 keys) is
    longer than the ring, appends land on stage and bank boundaries, a dead
    row; against the plain split version and the serial kernel, caches and
    tile counts identical."""
    s, hkv, tile = 2048, 2, 64
    lens = [-1, 63, 64, 1023, 1024, 1500, 2047]
    b = len(lens)
    q = _normal(rng, cuda_device, qdt, b, hkv * g, d)
    ck, cv = (_normal(rng, cuda_device, cdt, b, s, hkv, d) for _ in "kv")
    nk, nv = (_normal(rng, cuda_device, cdt, b, hkv, d) for _ in "kv")
    ln = _ints(cuda_device, lens)
    ck_p, cv_p, ck_1, cv_1 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    o, _, _, t = kvmp.fused_append_attend(q, ck, cv, nk, nv, ln,
                                          seq_tile=tile, num_kv_splits=ns,
                                          dynamic_grid=True,
                                          return_tiles=True)
    o_p, t_p = kvmp.fused_append_attend_split_plain(
        q, ck_p, cv_p, nk, nv, ln, seq_tile=tile, n_tiles=s // tile,
        length_mask=True, num_kv_splits=ns)
    o_1, _, _, t_1 = kvmp.fused_append_attend(q, ck_1, cv_1, nk, nv, ln,
                                              seq_tile=tile,
                                              dynamic_grid=True,
                                              return_tiles=True)
    tol = F32_TOL if qdt == cdt == "f32" else BF16_TOL
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(o.float(), o_1.float(), atol=tol, rtol=tol)
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)
    assert torch.equal(ck, ck_1) and torch.equal(cv, cv_1)
    assert torch.equal(t, t_p) and torch.equal(t, t_1)
    assert not o[lens.index(-1)].float().abs().any()      # dead row: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,cache_bytes", [(8, 64, 4), (8, 64, 2),
                                             (32, 128, 4), (1, 18, 4),
                                             (7, 128, 2)])
def test_split_geometry_matches_the_build(cuda_device, g, d, cache_bytes):
    """The host-side mirror of stage 1's ring names the geometry the built
    kernel launches with."""
    want = kvmp.split_geometry(g, d, cache_bytes)
    got = kvmp.split_geometry_built(g, d, cache_bytes)
    assert got == {k: want[k] for k in got}


FLASH_TOL = {"f32": 2e-5, "bf16": 5e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,qt,kt", [
    (2, 32, 4, 256, 256, 64, 128, 128),    # tinyllama heads, G = 8
    (1, 4, 4, 128, 256, 16, 64, 64),       # G = 1, Sq < Sk (top-left)
    (1, 8, 1, 256, 128, 128, 64, 128),     # G = 8, Sq > Sk, D = 128
    (2, 8, 8, 128, 128, 128, 128, 64),     # Sq = q_tile
    (1, 6, 2, 96, 160, 48, 32, 32),        # G = 3, D = 48, ragged tiles
    # the tensor-core kernel's ragged edges: Sq, Sk not multiples of 64 or
    # 128, D padded by TMA's zero fill, G = 7, a batch of 3
    (1, 4, 2, 200, 333, 16, 200, 333),     # D = 16, Sq < Sk
    (1, 4, 2, 333, 200, 48, 333, 200),     # D = 48, Sq > Sk
    (3, 6, 2, 200, 333, 64, 200, 333),     # batch 3, G = 3
    (1, 7, 1, 333, 200, 128, 333, 200),    # G = 7, D = 128, Sq > Sk
    (3, 14, 2, 200, 200, 128, 200, 200),   # G = 7, D = 128, batch 3
])
def test_flash_attention_kernel_on_card(rng, cuda_device, dt, causal, b, h,
                                        hkv, sq, sk, d, qt, kt):
    """B5 against its plain version, one launch per call: bf16 on the
    tensor-core kernel, f32 on the CUDA-core one."""
    q = _normal(rng, cuda_device, dt, b, h, sq, d)
    k, v = (_normal(rng, cuda_device, dt, b, hkv, sk, d) for _ in "kv")
    ran = "flash_attention_tc" if dt == "bf16" else "flash_attention"
    other = "flash_attention" if dt == "bf16" else "flash_attention_tc"
    before = launch_counts()
    o = ops.flash_attention(q, k, v, causal=causal, q_tile=qt, k_tile=kt)
    after = launch_counts()
    assert after[ran] == before[ran] + 1 and after[other] == before[other]
    o_p = fa.flash_attention_plain(q, k, v, causal=causal)
    assert o.dtype == q.dtype and o.shape == q.shape
    tol = FLASH_TOL[dt]
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kdt,d", [("bf16", "f32", 64),
                                      ("bf16", "bf16", 12)])
def test_flash_attention_mixed_dtypes_stay_on_the_cuda_cores(
        rng, cuda_device, qdt, kdt, d):
    """bf16 q over f32 k/v, and bf16 at a D TMA cannot tile, take the
    CUDA-core kernel."""
    q = _normal(rng, cuda_device, qdt, 1, 4, 96, d)
    k, v = (_normal(rng, cuda_device, kdt, 1, 2, 128, d) for _ in "kv")
    before = launch_counts()
    o = ops.flash_attention(q, k, v, causal=True)
    after = launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_tc"] == before["flash_attention_tc"]
    torch.testing.assert_close(
        o.float(), fa.flash_attention_plain(q, k, v, causal=True).float(),
        atol=FLASH_TOL["bf16"], rtol=FLASH_TOL["bf16"])


@pytest.mark.cuda
def test_flash_attention_tc_reads_an_unaligned_view(rng, cuda_device):
    """A q view that starts off a 16-byte boundary still launches the
    tensor-core kernel (the wrapper realigns it)."""
    base = _normal(rng, cuda_device, "bf16", 1 * 4 * 128 * 64 + 3)
    q = base[3:].view(1, 4, 128, 64)
    assert q.data_ptr() % 16 != 0
    k, v = (_normal(rng, cuda_device, "bf16", 1, 2, 128, 64) for _ in "kv")
    o = ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(
        o.float(), fa.flash_attention_plain(q, k, v, causal=True).float(),
        atol=FLASH_TOL["bf16"], rtol=FLASH_TOL["bf16"])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 48, 64, 128])
def test_flash_attention_tc_geometry_matches_the_build(cuda_device, d):
    """The host-side mirror of the tensor-core kernel's tiles names the
    shared memory the built kernel asks for."""
    assert fa.tc_smem_bytes_built(d) == fa.tc_geometry(d)["smem_bytes"]


@pytest.mark.cuda
def test_flash_attention_refuses_before_launching(cuda_device):
    """A non-divisible shape, a CPU/CUDA mix or D > 128 raises and
    launches nothing."""
    before = launch_counts()
    q = torch.zeros((1, 4, 96, 16), device=cuda_device)
    k = torch.zeros((1, 2, 96, 16), device=cuda_device)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, q_tile=64)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError):
        ops.flash_attention(q.cpu(), k, k)
    big = torch.zeros((1, 2, 64, 256), device=cuda_device)
    with pytest.raises(ValueError, match="128"):
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="128"):
        ops.flash_attention(big.bfloat16(), big.bfloat16(), big.bfloat16())
    assert launch_counts() == before


# ---- B1 as one clustered launch (a cluster of C blocks per row, kv head) --

def _share_edge_lens(n_tiles, tile, c):
    """Append positions at the first key of their share under C banks of
    ``n_tiles`` staged tiles, found through the host mirror (the appended
    key is always the last key of its share): the two smallest and the two
    largest."""
    s = n_tiles * tile

    def first_of_share(p):
        return any(kvmp.split_bank_range(p, r, seq_tile=tile,
                                         n_tiles=n_tiles, s=s,
                                         num_kv_splits=c)[0] == p
                   for r in range(c))
    edges = [p for p in range(tile, s) if first_of_share(p)]
    return list(dict.fromkeys(edges[:2] + edges[-2:]))


def _cluster_taken(q, ck, n_tiles, tile):
    """The cluster size the wrapper takes for this call on this card."""
    b, _, hkv, d = ck.shape
    return kvmp.cluster_size(n_tiles, tile, rows=b * hkv, fit=lambda c: (
        kvmp.cluster_fit(q.shape[1] // hkv, d, q.dtype, ck.dtype, c)))


SERIAL_CASES = [  # G, D, q dtype, cache dtype
    (8, 64, "f32", "f32"), (8, 64, "bf16", "f32"),   # tinyllama's heads
    (8, 64, "bf16", "bf16"), (1, 64, "f32", "f32"), (32, 128, "f32", "f32"),
    (7, 128, "bf16", "bf16"), (32, 18, "f32", "f32"),  # element-wise loader
    (4, 12, "f32", "bf16"),                           # 24-byte bf16 rows
    (1, 128, "bf16", "f32"),                  # deepseek-moe-16b's decode
]


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,qdt,cdt", SERIAL_CASES)
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_serial_decode_clusters_on_card(rng, cuda_device, g, d, qdt, cdt,
                                        cluster):
    """B1 over the long call's 2048-position caches (seq_tile 64) with
    4 C staged tiles, so that the wrapper takes clusters of C = 1, 2, 4
    and 8 (at most 14 clusters: all fit at once): a dead row, appends at
    0, at a share's first key and at the last staged position, length_mask
    on and off; one launch a call, caches and tile counts bit-identical to
    the plain version."""
    s, hkv, tile = 2048, 2, 64
    n_tiles = 4 * cluster
    lens = [-1, 0, *_share_edge_lens(n_tiles, tile, cluster),
            n_tiles * tile - 1]
    b = len(lens)
    q = _normal(rng, cuda_device, qdt, b, hkv * g, d)
    nk, nv = (_normal(rng, cuda_device, cdt, b, hkv, d) for _ in "kv")
    ln = _ints(cuda_device, lens)
    for length_mask in (True, False):
        ck, cv = (_normal(rng, cuda_device, cdt, b, s, hkv, d) for _ in "kv")
        assert _cluster_taken(q, ck, n_tiles, tile) == cluster
        ck_p, cv_p = ck.clone(), cv.clone()
        before = launch_counts()
        o, t = kvmp.serial_decode(q, ck, cv, nk, nv, ln, seq_tile=tile,
                                  n_tiles=n_tiles, length_mask=length_mask)
        ran = {k: v - before[k] for k, v in launch_counts().items()
               if v != before[k]}
        assert ran == {"kv_decode_append_attend": 1}
        o_p, t_p = kvmp.fused_append_attend_plain(
            q, ck_p, cv_p, nk, nv, ln, seq_tile=tile, n_tiles=n_tiles,
            length_mask=length_mask)
        tol = F32_TOL if qdt == cdt == "f32" else BF16_TOL
        torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
        assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)
        assert torch.equal(t, t_p)
        assert not o[0].float().abs().any()               # dead row: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [[1932, 1788, 1795, 1552],
                                  [1932, 1788, 1795]])
def test_serial_decode_equals_the_split_pair(rng, cuda_device, lens):
    """At the long call's shape B1 agrees with the split pair at ns 8
    within 1e-5, caches and tile counts identical: with the long call's 16
    (row, kv head) clusters (the card's default cluster, 6 blocks on an
    H100) and with 12, where 8-block clusters fit and B1 takes the split
    pair's own partition."""
    s, hkv, g, d, tile = 2048, 4, 8, 64, 64
    b = len(lens)
    q = _normal(rng, cuda_device, "f32", b, hkv * g, d)
    ck, cv = (_normal(rng, cuda_device, "f32", b, s, hkv, d) for _ in "kv")
    nk, nv = (_normal(rng, cuda_device, "f32", b, hkv, d) for _ in "kv")
    ln = _ints(cuda_device, lens)
    if b * hkv < 16:
        assert _cluster_taken(q, ck, s // tile, tile) == 8
    ck_8, cv_8 = ck.clone(), cv.clone()
    o, t = kvmp.serial_decode(q, ck, cv, nk, nv, ln, seq_tile=tile,
                              n_tiles=s // tile, length_mask=True)
    o_8, _, _, t_8 = kvmp.fused_append_attend(q, ck_8, cv_8, nk, nv, ln,
                                              seq_tile=tile, dynamic_grid=True,
                                              num_kv_splits=8,
                                              return_tiles=True)
    torch.testing.assert_close(o, o_8, atol=F32_TOL, rtol=F32_TOL)
    assert torch.equal(ck, ck_8) and torch.equal(cv, cv_8)
    assert torch.equal(t, t_8)


@pytest.mark.cuda
def test_serial_decode_clusters_fit_the_card(cuda_device):
    """Clusters of every size can be resident, and the cluster the wrapper
    picks for the long call (16 rows x kv heads over 32 staged tiles) runs
    all 16 clusters in one wave."""
    bf, f32 = torch.bfloat16, torch.float32
    for c in range(1, kvmp.MAX_CLUSTER + 1):
        assert kvmp.cluster_fit(8, 64, bf, f32, c) >= 1
    c = kvmp.cluster_size(32, 64, rows=16,
                          fit=lambda c: kvmp.cluster_fit(8, 64, bf, f32, c))
    assert c > 1 and kvmp.cluster_fit(8, 64, bf, f32, c) >= 16


# ---- B5's f32 route: 3xTF32 on the tensor cores ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [12, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(200, 333), (333, 200)])
@pytest.mark.parametrize("qdt", ["f32", "bf16"])
def test_flash_attention_f32_route_on_card(rng, cuda_device, d, causal, sq,
                                           sk, qdt):
    """The f32 kernel at G = 7 over ragged Sq != Sk both ways, f32 or bf16
    q over f32 k/v: one launch, within 2e-5 of the plain version in f32."""
    q = _normal(rng, cuda_device, qdt, 2, 14, sq, d)
    k, v = (_normal(rng, cuda_device, "f32", 2, 2, sk, d) for _ in "kv")
    before = launch_counts()
    o = ops.flash_attention(q, k, v, causal=causal, q_tile=sq, k_tile=sk)
    after = launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_tc"] == before["flash_attention_tc"]
    assert o.dtype == q.dtype and o.shape == q.shape
    tol = FLASH_TOL[qdt]
    torch.testing.assert_close(
        o.float(), fa.flash_attention_plain(q, k, v, causal=causal).float(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [12, 64, 128])
@pytest.mark.parametrize("scale", [(3.0, 3.0), (3.5, 3.0), (4.0, 3.0),
                                   (4.0, 4.0)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_route_holds_at_large_scores(rng, cuda_device, d,
                                                         scale, causal):
    """q and k at 3-4x N(0, 1), v at 3-4x: scores of tens, where the
    softmax turns a few units of 2^-24 in a score into 1e-5 of the output.
    The f32 kernel at G = 7, Sq != Sk, stays within 2e-5 of the plain
    version in f32."""
    qk, vs = scale
    q = _normal(rng, cuda_device, "f32", 2, 14, 333, d) * qk
    k = _normal(rng, cuda_device, "f32", 2, 2, 200, d) * qk
    v = _normal(rng, cuda_device, "f32", 2, 2, 200, d) * vs
    o = ops.flash_attention(q, k, v, causal=causal, q_tile=333, k_tile=200)
    torch.testing.assert_close(
        o, fa.flash_attention_plain(q, k, v, causal=causal),
        atol=FLASH_TOL["f32"], rtol=FLASH_TOL["f32"])


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [(3.5, 3.0), (4.0, 4.0)])
def test_flash_attention_f32_route_holds_at_large_scores_full_width(
        rng, cuda_device, scale):
    """The whole-prompt layer's shape (q [2, 32, 2048, 64], k/v [2, 4, 2048,
    64], causal) at q, k 3.5-4x N(0, 1): within 2e-5 of the plain
    version."""
    qk, vs = scale
    q = _normal(rng, cuda_device, "f32", 2, 32, 2048, 64) * qk
    k = _normal(rng, cuda_device, "f32", 2, 4, 2048, 64) * qk
    v = _normal(rng, cuda_device, "f32", 2, 4, 2048, 64) * vs
    o = ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(
        o, fa.flash_attention_plain(q, k, v, causal=True),
        atol=FLASH_TOL["f32"], rtol=FLASH_TOL["f32"])


# ---- the build, and the rows this change must not move --------------------

@pytest.mark.cuda
def test_ptxas_reports_no_spills(cuda_device):
    """Every source built with ``-Xptxas -v``: 0 bytes of spill stores."""
    _build.build()
    logs = sorted(_build.BUILD_DIR.glob("*.ptxas.txt"))
    assert {p.name.split(".")[0] for p in logs} >= set(_build.SOURCES)
    for log in logs:
        spills = re.findall(r"(\d+) bytes spill stores", log.read_text())
        assert not any(int(n) for n in spills), log.name


def _device_ms(fn, reps=20, batches=5):
    """Device time of one call: CUDA events around ``reps`` queued calls
    behind a spin kernel, the median over ``batches`` (chip_smoke.py's
    timing)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[batches // 2]


@pytest.mark.cuda
def test_unchanged_rows_hold_their_time(rng, cuda_device):
    """B4a and B2 on their long-path calls stay within 10 % of their
    earlier times on an H100 80GB HBM3 (0.01506 and 0.36841 ms, PERF.md):
    B4a's ring moved into decode_attend.cuh, B2 kept attend_tile.cuh."""
    name = torch.cuda.get_device_name(0)
    if "H100" not in name:
        pytest.skip(f"the earlier times are an H100's, not a {name}'s")
    s, hkv, g, d, tile = 2048, 4, 8, 64, 64
    b = 4
    q = _normal(rng, cuda_device, "bf16", b, hkv * g, d)
    ck, cv = (_normal(rng, cuda_device, "f32", b, s, hkv, d) for _ in "kv")
    nk, nv = (_normal(rng, cuda_device, "f32", b, hkv, d) for _ in "kv")
    ln = _ints(cuda_device, [1932, 1788, 1795, 1552])
    kw = dict(seq_tile=tile, n_tiles=s // tile, length_mask=True,
              num_kv_splits=8)
    b4a = _device_ms(lambda: kvmp.split_partials(q, ck, cv, nk, nv, ln, **kw))
    c = 128
    qc = _normal(rng, cuda_device, "bf16", b, c, hkv * g, d)
    nkc, nvc = (_normal(rng, cuda_device, "f32", b, c, hkv, d) for _ in "kv")
    of, cl = _ints(cuda_device, [1920, 1664, 1536, -1]), \
        _ints(cuda_device, [6, 125, 10, 0])
    b2 = _device_ms(lambda: kvpc.fused_chunk_append_attend(
        qc, ck, cv, nkc, nvc, of, cl, seq_tile=tile, dynamic_grid=True))
    assert b4a <= 1.10 * 0.01506, f"B4a {b4a:.5f} ms"
    assert b2 <= 1.10 * 0.36841, f"B2 {b2:.5f} ms"


@pytest.mark.cuda
def test_moe_apply_on_card_matches_its_cpu_result(rng, cuda_device):
    """The MoE layer (sort dispatch, capacity drops, batched expert
    einsums, combine) at deepseek-moe-16b's reduced config, f32 with TF32
    off: the card's output and aux equal the CPU's at 1e-5, with a zero
    row whose tied experts go to the lowest indices on both. Neither it
    nor M-RoPE waits on the card (a decode cycle's MoE layers replay as
    one CUDA graph in chip_smoke.py)."""
    from repro_torch.configs import registry
    from repro_torch.models import layers, mlp
    cfg = registry.get("deepseek-moe-16b", reduced=True)
    p = mlp.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.moe,
                     device="cpu")
    x = torch.from_numpy(rng.normal(size=(3, 16, cfg.d_model))
                         .astype(np.float32))
    x[1] = 0.0
    out, aux = mlp.moe_apply(p, x, cfg.moe)

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda_device)
    p_c, x_c = to_card(p), x.to(cuda_device)
    pos = torch.randint(0, 64, (3, 16, 3), device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out_c, aux_c = mlp.moe_apply(p_c, x_c, cfg.moe)
        rot = layers.mrope_apply(x_c.reshape(3, 16, 4, 16), pos, (4, 2, 2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out_c.device.type == "cuda"
    torch.testing.assert_close(
        rot.cpu(), layers.mrope_apply(x.reshape(3, 16, 4, 16), pos.cpu(),
                                      (4, 2, 2)), atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(out_c.cpu(), out, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(aux_c.cpu(), aux, atol=F32_TOL, rtol=F32_TOL)


# ---- training (ROADMAP A10): no kernel; the card against the CPU ---------

@pytest.mark.cuda
@pytest.mark.parametrize("tkw", [
    {}, {"microbatches": 2}, {"grad_compression": "int8_ef", "n_pods": 2},
    {"optimizer": "adamw8bit"}, {"optimizer": "adafactor"}],
    ids=["adamw", "microbatches2", "int8_ef", "adamw8bit", "adafactor"])
def test_train_step_on_card_matches_cpu(cuda_device, tkw):
    """Three steps of reduced tinyllama-1.1b (f32, TF32 off) from the same
    state on the card and on the CPU: ce, grad_norm and lr within 1e-4
    relative at every step, and no kernel launched (training runs none of
    B1-B5, as in JAX)."""
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.train import train_step as ts
    cfg = registry.get("tinyllama-1.1b", reduced=True)
    tcfg = ts.TrainConfig(peak_lr=3e-3, warmup_steps=1, total_steps=10,
                          **tkw)
    step = ts.make_train_step(cfg, tcfg)
    st_cpu = ts.init_train_state(
        init_params(cfg, torch.Generator().manual_seed(0), "cpu"), tcfg)
    st_card = T.tree_map(lambda x: x.to(cuda_device), st_cpu)
    reset_launch_counts()
    for i in range(3):
        nb = make_batch(cfg, DataConfig(seed=1), i, 8, 16)
        st_cpu, mc = step(st_cpu, {k: torch.from_numpy(v)
                                   for k, v in nb.items()})
        st_card, mg = step(st_card, {k: torch.from_numpy(v).to(cuda_device)
                                     for k, v in nb.items()})
        assert mg["ce"].device == st_card["opt"]["step"].device
        for k in ("ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(mg[k]), float(mc[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert not any(launch_counts().values())


@pytest.mark.cuda
def test_bf16_checkpoint_round_trip_from_card(cuda_device, tmp_path):
    """A state on the card (bf16 params, f32 moments, 8-bit codes, an
    int32 step) restores bit-exact onto the card."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import ckpt
    g = torch.Generator(device=cuda_device).manual_seed(0)
    t = {"params": {"w": torch.randn((300, 70), generator=g,
                                     device=cuda_device).to(torch.bfloat16)},
         "opt": {"step": torch.tensor(3, dtype=torch.int32,
                                      device=cuda_device),
                 "m": {"q": torch.randint(-127, 128, (5, 64),
                                          dtype=torch.int8,
                                          device=cuda_device),
                       "scale": torch.rand((5, 1), device=cuda_device)},
                 "v": torch.rand((300, 70), device=cuda_device)}}
    ckpt.save(str(tmp_path), 3, t)
    restored, m = ckpt.restore(str(tmp_path), t)
    assert m["step"] == 3
    for (pa, a), (pb, b) in zip(T.leaves_with_path(t),
                                T.leaves_with_path(restored), strict=True):
        assert pa == pb and b.device == a.device and a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), pa


def _near_tie(x: np.ndarray, signed: bool) -> np.ndarray:
    """Where ``optim.quantized._quantize`` rounds a value within 1e-5 of a
    half-integer (computed in f64, blocked as there): a last-bit difference
    in log10 may move such a code by one."""
    from repro_torch.optim import quantized as Q
    x = np.asarray(x, np.float64)
    pad = (-x.shape[-1]) % Q.BLOCK
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    blocks = x.reshape(*x.shape[:-1], -1, Q.BLOCK)
    a = np.abs(blocks) / np.maximum(np.abs(blocks).max(-1, keepdims=True),
                                    1e-30)
    pre = (np.log10(np.maximum(a, 1e-7)) + 7.0) / 7.0 * (127.0 if signed
                                                         else 255.0)
    return np.abs(pre - np.floor(pre) - 0.5) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [True, False])
def test_quantizer_on_card_matches_cpu(cuda_device, signed):
    """The 8-bit optimizer's log-dynamic codes at a 2^20-element leaf
    (magnitudes over 9 decades, zeros): scales equal, codes equal except
    at ties and there one apart, dequantized values within 4e-6
    relative."""
    from repro_torch.optim import quantized as Q
    rng = np.random.default_rng(11)
    n = 2 ** 20
    x = rng.uniform(0.3, 1.0, n) * 10.0 ** rng.integers(-8, 1, n)
    if signed:
        x *= np.where(rng.random(n) < 0.5, -1, 1)
    x[rng.random(n) < 0.05] = 0.0
    x = x.astype(np.float32).reshape(1024, 1024)
    q_cpu = Q._quantize(torch.from_numpy(x), signed)
    q_card = Q._quantize(torch.from_numpy(x).to(cuda_device), signed)
    assert torch.equal(q_card["scale"].cpu(), q_cpu["scale"])
    got = q_card["q"].cpu().numpy().astype(np.int32)
    want = q_cpu["q"].numpy().astype(np.int32)
    diff = got != want
    assert np.all(_near_tie(x, signed)[diff])
    assert np.all(np.abs(got - want)[diff] == 1)
    d_card = Q._dequantize({"q": q_cpu["q"].to(cuda_device),
                            "scale": q_cpu["scale"].to(cuda_device)}, x.shape)
    # the card's and the CPU's f32 pow in _dequantize differ by up to
    # 1.27e-6 relative (NVIDIA H100 80GB HBM3)
    np.testing.assert_allclose(d_card.cpu().numpy(),
                               Q._dequantize(q_cpu, x.shape).numpy(),
                               rtol=4e-6, atol=0)


# ---- zamba2-7b's shared attention: B1 and the split pair at G 1, D 112 ----

# zamba2-7b's heads: 32 query and 32 kv heads of 112 dims (224-byte bf16
# rows: 16-byte copies; 112 of a P.V row's threads busy)
ZAMBA_HKV, ZAMBA_D = 32, 112


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,cdt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("bf16", "f32")])
@pytest.mark.parametrize("mode", [dict(), dict(length_mask=False),
                                  dict(dynamic_grid=True)])
def test_decode_kernel_at_zamba2_heads_on_card(rng, cuda_device, qdt, cdt,
                                               mode):
    """B1 at G 1, D 112, Hkv 32: ragged lengths, appends at 0 and at tile
    edges, a dead row; one launch a call; caches and tile counts identical
    to the plain version."""
    s, tile = 256, 64
    lens = [0, tile - 1, tile, tile + 1, -1, 200, s - 1]
    b = len(lens)
    q = _normal(rng, cuda_device, qdt, b, ZAMBA_HKV, ZAMBA_D)
    ck, cv = (_normal(rng, cuda_device, cdt, b, s, ZAMBA_HKV, ZAMBA_D)
              for _ in "kv")
    nk, nv = (_normal(rng, cuda_device, cdt, b, ZAMBA_HKV, ZAMBA_D)
              for _ in "kv")
    ln = _ints(cuda_device, lens)
    ck_p, cv_p = ck.clone(), cv.clone()
    before = launch_counts()
    o, _, _, t = kvmp.fused_append_attend(q, ck, cv, nk, nv, ln,
                                          seq_tile=tile, return_tiles=True,
                                          **mode)
    ran = {k: v - before[k] for k, v in launch_counts().items()
           if v != before[k]}
    assert ran == {"kv_decode_append_attend": 1}
    _, n = kvmp.launch_geometry(s, tile, None, mode.get("dynamic_grid",
                                                        False))
    o_p, t_p = kvmp.fused_append_attend_plain(
        q, ck_p, cv_p, nk, nv, ln, seq_tile=tile, n_tiles=n,
        length_mask=mode.get("length_mask", True))
    tol = F32_TOL if qdt == cdt == "f32" else BF16_TOL
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)
    assert torch.equal(t, t_p)
    assert not o[lens.index(-1)].float().abs().any()      # dead row: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,cdt", [("f32", "f32"), ("bf16", "bf16")])
@pytest.mark.parametrize("ns", [2, 8])
def test_split_pair_at_zamba2_heads_on_card(rng, cuda_device, qdt, cdt, ns):
    """The split pair at G 1, D 112, Hkv 32 over a 2K context (appends on
    stage and bank boundaries, a dead row): the split launches only,
    against the plain split version and the serial kernel, caches and tile
    counts identical to both."""
    s, tile = 2048, 64
    lens = [-1, 63, 64, 1023, 1024, 1500, 2047]
    b = len(lens)
    q = _normal(rng, cuda_device, qdt, b, ZAMBA_HKV, ZAMBA_D)
    ck, cv = (_normal(rng, cuda_device, cdt, b, s, ZAMBA_HKV, ZAMBA_D)
              for _ in "kv")
    nk, nv = (_normal(rng, cuda_device, cdt, b, ZAMBA_HKV, ZAMBA_D)
              for _ in "kv")
    ln = _ints(cuda_device, lens)
    ck_p, cv_p, ck_1, cv_1 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    before = launch_counts()
    o, _, _, t = kvmp.fused_append_attend(q, ck, cv, nk, nv, ln,
                                          seq_tile=tile, num_kv_splits=ns,
                                          dynamic_grid=True,
                                          return_tiles=True)
    ran = {k: v - before[k] for k, v in launch_counts().items()
           if v != before[k]}
    assert ran == {"kv_decode_split_partial": 1, "kv_decode_split_combine": 1}
    o_p, t_p = kvmp.fused_append_attend_split_plain(
        q, ck_p, cv_p, nk, nv, ln, seq_tile=tile, n_tiles=s // tile,
        length_mask=True, num_kv_splits=ns)
    o_1, _, _, t_1 = kvmp.fused_append_attend(q, ck_1, cv_1, nk, nv, ln,
                                              seq_tile=tile,
                                              dynamic_grid=True,
                                              return_tiles=True)
    tol = F32_TOL if qdt == cdt == "f32" else BF16_TOL
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(o.float(), o_1.float(), atol=tol, rtol=tol)
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)
    assert torch.equal(ck, ck_1) and torch.equal(cv, cv_1)
    assert torch.equal(t, t_p) and torch.equal(t, t_1)
    assert not o[lens.index(-1)].float().abs().any()      # dead row: zeros


@pytest.mark.cuda
def test_zamba2_decode_step_on_card_matches_cpu(cuda_device):
    """zamba2-7b at its published widths, depth cut to 7 layer slots (one
    group of 6 Mamba2 blocks and its shared block, one tail block), f32
    with TF32 off: ``prefill`` of 16 tokens and one multiport
    ``decode_step`` on the card (B1 launched once, for the one group's
    shared block) against the same on the CPU (the plain version), logits
    and every decode-state leaf within 1e-4."""
    import dataclasses

    from repro_torch import models as M
    from repro_torch import tree as T
    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get("zamba2-7b"), n_layers=7,
                              param_dtype="float32", compute_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ids = torch.randint(0, cfg.vocab, (2, 17),
                        generator=torch.Generator().manual_seed(1))

    def run(dev, p):
        state = M.init_decode_state(cfg, 2, 64, dev)
        state, _ = M.prefill(p, cfg, state, {"inputs": ids[:, :16].to(dev)})
        before = launch_counts()
        state, lg = M.decode_step(p, cfg, state,
                                  {"inputs": ids[:, 16:].to(dev)},
                                  kernel_mode="multiport", seq_tile=64)
        ran = {k: v - before[k] for k, v in launch_counts().items()
               if v != before[k]}
        return lg, state, ran
    lg_cpu, st_cpu, ran_cpu = run("cpu", params)
    lg, st, ran = run(cuda_device, T.tree_map(
        lambda x: x.to(cuda_device), params))
    assert ran_cpu == {} and ran == {"kv_decode_append_attend": 1}
    torch.testing.assert_close(lg.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
    for (path, a), (_, b) in zip(T.leaves_with_path(st),
                                 T.leaves_with_path(st_cpu), strict=True):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4,
                                   msg=str(path))


# ---- the paper's baselines, the tensor encoder, data-parallel KV -----------

def _port_configs(rng):
    """Every 1-4-port enable set x R/W role mix, each under a seeded
    priority permutation."""
    import itertools
    perms = list(itertools.permutations(range(4)))
    out = []
    for m in range(1, 16):
        enabled = tuple(bool(m >> i & 1) for i in range(4))
        on = [i for i in range(4) if enabled[i]]
        for bits in range(1 << len(on)):
            roles = [READ] * 4
            for k, p in enumerate(on):
                roles[p] = WRITE if bits >> k & 1 else READ
            out.append(PortConfig(enabled=enabled, roles=tuple(roles),
                                  priority=perms[int(rng.integers(24))]))
    return out


@pytest.mark.cuda
def test_baselines_equal_multiport_step_on_card(rng, cuda_device):
    """SinglePortNPass, ReplicatedReads(3) and XorCoded on the card ==
    ``multiport.step`` and the pool-step kernel, storage and reads
    bit-exact, over every port mix with addresses that repeat; the XOR
    parity stays the sum of its banks (1e-5)."""
    from repro_torch.core.baselines import (ReplicatedReads, SinglePortNPass,
                                            XorCoded)
    spec = MemorySpec(num_words=64, word_width=300, num_banks=8)
    bases = (SinglePortNPass(spec), ReplicatedReads(spec, 3), XorCoded(spec))
    for cfg in _port_configs(rng):
        reqs = [PortRequest(
            addr=_ints(cuda_device, rng.integers(0, 64, 96)),
            data=_normal(rng, cuda_device, "f32", 96, 300),
            mask=torch.from_numpy(rng.random(96) > 0.3).to(cuda_device))
            for _ in range(4)]
        storage = _normal(rng, cuda_device, "f32", 64, 300)
        want, want_r = step(spec, cfg, storage, reqs)
        got_k, reads_k = ops.multiport_step(spec, cfg, storage.clone(), reqs)
        assert torch.equal(got_k, want)
        single = bases[0].step(cfg, storage, reqs)
        rep = bases[1].step(cfg, storage.unsqueeze(0).repeat(3, 1, 1), reqs)
        data = storage.reshape(8, 8, 300).clone()
        (xd, xp), xr = bases[2].step(cfg, (data, data.sum(0)), reqs)
        assert torch.equal(single[0], want)
        assert all(torch.equal(r, want) for r in rep[0])
        assert torch.equal(xd.reshape(64, 300), want)
        torch.testing.assert_close(xp, xd.sum(0), atol=1e-5, rtol=1e-5)
        for p in range(4):
            for got in (reads_k[p], single[1][p], rep[1][p], xr[p]):
                assert torch.equal(got, want_r[p])


@pytest.mark.cuda
def test_priority_encoder_and_walk_in_a_cuda_graph(cuda_device):
    """encode_dynamic, next_port_dynamic (the walk from the reset state)
    and walk_order_dynamic on CUDA tensors, captured in ONE CUDA graph
    (which fails on any host sync), equal their static counterparts for
    every enable mask under every priority permutation."""
    import itertools

    from repro_torch.core import fsm, priority as prio
    perms = list(itertools.permutations(range(4)))
    masks = [tuple(bool(m >> i & 1) for i in range(4)) for m in range(1, 16)]
    en = torch.tensor(masks, device=cuda_device)
    pr = torch.tensor(perms, dtype=torch.int32, device=cuda_device)

    def run():
        out = []
        for i in range(len(masks)):
            for j in range(len(perms)):
                cur = fsm.reset_state(en[i], pr[j])
                walk = [cur]
                for _ in range(4):
                    cur = fsm.transition(cur, en[i], pr[j])
                    walk.append(cur)
                ports, active = fsm.walk_order_dynamic(en[i], pr[j])
                out.append(torch.cat([torch.stack(walk), ports,
                                      active.to(torch.int32)]))
        return torch.stack(out)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                                           # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    graph.replay()
    got = got.cpu()
    for i, enabled in enumerate(masks):
        for j, priority in enumerate(perms):
            row = got[i * len(perms) + j].tolist()
            order = prio.order_static(enabled, priority)
            n = len(order)
            walk = [order[k % n] for k in range(5)]
            assert row[:5] == walk
            assert row[0] == prio.encode_static(enabled, priority)
            assert tuple(row[5:5 + n]) == order
            assert row[9:] == [1] * n + [0] * (4 - n)


def _pool_session(pool, rng):
    """Prefills, appends with reads in both hazard orders, a scrub; every
    read and the joined storage after each traversal."""
    w = pool.io_width
    vec = lambda n: rng.normal(size=(n, w)).astype(np.float32)  # noqa: E731
    got = []

    def keep(res):
        if res["read"] is not None:
            got.extend(res["read"] if isinstance(res["read"], list)
                       else [res["read"]])
        got.append((torch.cat([st.to(pool.device) for st in pool.storage])
                    if pool.sharded else pool.storage).clone())
    keep(pool.cycle(prefill=[{"seq": s, "vectors": vec(n)}
                             for s, n in ((1, 40), (2, 17), (3, 9))]))
    for prio in ((1, 0, 3, 2), (0, 3, 2, 1)):
        keep(pool.cycle(append=[{"seq": 1, "vectors": vec(1)},
                                {"seq": 3, "vectors": vec(1)}],
                        read=[{"seq": 1, "positions": np.arange(41)},
                              {"seq": 2, "positions": np.arange(17)}],
                        priority=prio))
    keep(pool.cycle(scrub=pool.free(2),
                    read={"seq": 3, "positions": np.arange(10)}))
    return got


@pytest.mark.cuda
def test_sharded_pool_step_on_four_virtual_shards_is_bit_exact(cuda_device):
    """The pool sharded over 4 virtual shards of the card (one storage
    tensor and one pool-step launch per shard a traversal) == the
    unsharded pool with the same control plane, every read and the
    storage after every traversal bit-exact; 4 launches a traversal."""
    from repro_torch.launch.mesh import make_kv_mesh
    from repro_torch.memory.paged_kv import PagedPool
    kw = dict(n_pages=64, page_tokens=8, word_width=11264, kv_shards=4,
              use_kernel=True, device=cuda_device)
    flat = PagedPool.create(**kw)
    mesh = make_kv_mesh(4, devices=[cuda_device] * 4)
    sharded = PagedPool.create(mesh=mesh, **kw)
    a = _pool_session(flat, np.random.default_rng(0))
    before = launch_counts()["multiport_sram_step"]
    b = _pool_session(sharded, np.random.default_rng(0))
    assert launch_counts()["multiport_sram_step"] - before == \
        4 * sharded.traversals
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 8])
def test_sharded_decode_kernels_on_four_virtual_shards(rng, cuda_device,
                                                       splits):
    """B1 (or B4a + B4b) once per shard on its row block: caches and tile
    counts bit-exact with one launch over all rows, outputs within 1e-5
    (a shard's fewer rows may take another cluster size); launches = 4."""
    from repro_torch.distributed.sharding import shard_apply
    from repro_torch.launch.mesh import make_kv_mesh
    b, s, hkv, g, d = 8, 2048, 4, 8, 64
    lens = _ints(cuda_device, [1500, 3, -1, 2047, 640, 64, 1999, 0])
    args = (_normal(rng, cuda_device, "f32", b, hkv * g, d),
            _normal(rng, cuda_device, "f32", b, s, hkv, d),
            _normal(rng, cuda_device, "f32", b, s, hkv, d),
            _normal(rng, cuda_device, "f32", b, hkv, d),
            _normal(rng, cuda_device, "f32", b, hkv, d), lens)
    ref = tuple(a.clone() for a in args)
    kw = dict(seq_tile=64, dynamic_grid=True, num_kv_splits=splits,
              return_tiles=True)
    fn = lambda *a: kvmp.fused_append_attend(*a, **kw)  # noqa: E731
    before = launch_counts()
    o, ck, cv, t = shard_apply(make_kv_mesh(4, devices=[cuda_device] * 4),
                               fn, *args)
    ran = {k: v - before[k] for k, v in launch_counts().items()
           if v != before[k]}
    assert ran == ({"kv_decode_append_attend": 4} if splits == 1 else
                   {"kv_decode_split_partial": 4,
                    "kv_decode_split_combine": 4})
    o1, ck1, cv1, t1 = fn(*ref)
    assert ck is args[1] and torch.equal(ck, ck1) and torch.equal(cv, cv1)
    assert torch.equal(t, t1)
    torch.testing.assert_close(o, o1, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
def test_sharded_kernels_on_two_cards(rng, cuda_device):
    """The mesh over two real cards: B1 once per card on its row block
    (each launch with its card current) and the pool sharded over both,
    equal to one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from repro_torch.distributed.sharding import shard_apply
    from repro_torch.launch.mesh import make_kv_mesh
    from repro_torch.memory.paged_kv import PagedPool
    mesh = make_kv_mesh(2)
    b, s, hkv, g, d = 4, 256, 4, 8, 64
    args = (_normal(rng, cuda_device, "f32", b, hkv * g, d),
            _normal(rng, cuda_device, "f32", b, s, hkv, d),
            _normal(rng, cuda_device, "f32", b, s, hkv, d),
            _normal(rng, cuda_device, "f32", b, hkv, d),
            _normal(rng, cuda_device, "f32", b, hkv, d),
            _ints(cuda_device, [200, 3, -1, 255]))
    ref = tuple(a.clone() for a in args)
    fn = lambda *a: kvmp.fused_append_attend(  # noqa: E731
        *a, seq_tile=64, dynamic_grid=True, return_tiles=True)
    o, ck, cv, t = shard_apply(mesh, fn, *args)
    o1, ck1, cv1, t1 = fn(*ref)
    assert torch.equal(ck, ck1) and torch.equal(cv, cv1)
    assert torch.equal(t, t1)
    torch.testing.assert_close(o, o1, atol=F32_TOL, rtol=F32_TOL)
    kw = dict(n_pages=16, page_tokens=8, word_width=512, kv_shards=2,
              use_kernel=True, device=cuda_device)
    sharded = PagedPool.create(mesh=mesh, **kw)
    assert [st.device for st in sharded.storage] == list(mesh.devices)
    a = _pool_session(PagedPool.create(**kw), np.random.default_rng(0))
    b = _pool_session(sharded, np.random.default_rng(0))
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y.to(x.device))


@pytest.mark.cuda
def test_launcher_kv_shards_over_the_visible_cards(cuda_device):
    """``--kv-shards N`` over the N cards of the host, through the
    launcher: one storage shard per card, each kernel launched once per
    card, and the greedy tokens of one card (f32)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards")
    from repro_torch.launch import serve
    argv = ["--dtype", "float32", "--requests", "4", "--max-new", "4"]
    flat = serve.main(argv)
    before = launch_counts()
    eng = serve.main(argv + ["--kv-shards", str(n)])
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    assert [st.device for st in eng.pool.storage] == \
        [torch.device("cuda", i) for i in range(n)]
    layers = eng.cfg.n_layers
    assert ran["kv_decode_append_attend"] == layers * eng.decode_steps * n
    assert ran["kv_chunk_append_attend"] == layers * eng.prefill_steps * n
    assert ran["multiport_sram_step"] == eng.pool.traversals * n
    assert {r.rid: r.generated for r in eng.finished} == \
        {r.rid: r.generated for r in flat.finished}


@pytest.mark.cuda
def test_bmm_f32_on_card_matches_the_cast_product(rng, cuda_device):
    """``layers.bmm_f32`` of bf16 operands on the card (no f32 copies)
    against the product of their f32 copies, values and gradients (the
    products of bf16 values are exact in f32; only the summation order
    differs)."""
    from repro_torch.models.layers import bmm_f32
    a = _normal(rng, cuda_device, "bf16", 6, 96, 64).requires_grad_()
    b = _normal(rng, cuda_device, "bf16", 6, 64, 80).requires_grad_()
    got = bmm_f32(a, b)
    assert got.dtype == torch.float32
    want = torch.bmm(a.float(), b.float())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    g = _normal(rng, cuda_device, "f32", 6, 96, 80)
    ga, gb = torch.autograd.grad(got, (a, b), g)
    wa, wb = torch.autograd.grad(want, (a, b), g)
    assert ga.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(ga, wa) and torch.equal(gb, wb)


# ---- sharded training: ranks that share the card (ROADMAP A8b) -------------

def _local_job(target: str, world: int, tmp_path, backend=None,
               **kwargs) -> list:
    """A job of ``world`` ranks on the cards (``local_ranks``' backend:
    peer memory where ranks share a card, NCCL with a card a rank, unless
    ``backend`` names one)."""
    import os

    from repro_torch.launch import local_ranks
    return local_ranks.run(target, world, device="cuda", kwargs=kwargs,
                           timeout=300, workdir=str(tmp_path / "job"),
                           path=[os.path.dirname(os.path.abspath(__file__))],
                           backend=backend)


@pytest.mark.cuda
def test_host_staged_collectives_on_two_ranks_of_one_card(cuda_device,
                                                          tmp_path):
    """Every collective DTensor issues, plain and functional, on CUDA
    tensors of 2 ranks that share the card, through the host-staged
    backend named explicitly, == its local reduction."""
    got = _local_job("repro_torch.distributed.hoststaged:probe", 2, tmp_path,
                     backend="hoststaged")
    assert all(all(r.values()) for r in got) and len(got[0]) == 10


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_peer_memory_collectives_on_ranks_of_one_card(cuda_device, tmp_path,
                                                      world):
    """``world`` ranks on the card (``peermem`` named, so that a host of
    several cards tests it too): every collective DTensor issues == its
    local reduction, and all-reduce, all-gather, reduce-scatter and
    all-to-all of CUDA tensors copy nothing between host and device
    (``torch.profiler``'s memcpy events) and take no pinned host memory."""
    for r in _local_job("torch_mesh_ranks:host_traffic", world, tmp_path,
                        backend="peermem"):
        assert r["backend"] == "peermem"
        assert len(r["probe"]) == 10 and all(r["probe"].values()), r["probe"]
        assert r["copies"] == 0 and r["pinned"] == {}, r


@pytest.mark.cuda
def test_host_staging_shows_in_the_host_traffic_check(cuda_device, tmp_path):
    """The same check over the host-staged backend counts its copies and
    pinned blocks: the check above can see host staging."""
    for r in _local_job("torch_mesh_ranks:host_traffic", 2, tmp_path,
                        backend="hoststaged"):
        assert r["backend"] == "hoststaged" and all(r["probe"].values())
        assert r["copies"] > 0 and r["pinned"], r


@pytest.mark.cuda
def test_nccl_collectives_on_two_cards(cuda_device, tmp_path):
    """Two ranks on two cards join NCCL (``local_ranks``' own choice), and
    every collective DTensor issues == its local reduction."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    for r in _local_job("torch_mesh_ranks:host_traffic", 2, tmp_path):
        assert r["backend"] == "nccl"
        assert len(r["probe"]) == 10 and all(r["probe"].values()), r["probe"]


@pytest.mark.cuda
def test_sharded_step_on_one_card_matches_one_device(cuda_device, tmp_path):
    """Reduced tinyllama (f32) trained by ``train_on_mesh`` over (data 1,
    model 2), 2 ranks on the card, against the one-device launcher on the
    card: ce at every step within rtol 1e-5."""
    from repro_torch.launch import train as launch_train
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cuda",
            "--steps", "3", "--batch", "8", "--seq", "16"]
    ranks = _local_job("torch_mesh_ranks:launcher_on_mesh", 2, tmp_path,
                       shape=[1, 2], device="cuda",
                       argv=argv + ["--ckpt-dir", str(tmp_path / "mesh")])
    one = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    np.testing.assert_allclose(ranks[0]["ce"], [h["ce"] for h in one.history],
                               rtol=1e-5)
    assert "devices=2 (data 1 x model 2 on " in ranks[0]["lines"]


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_dispatch_on_two_ranks_of_one_card(cuda_device, tmp_path,
                                               capacity_factor):
    """``mlp.moe_ffn`` of reduced deepseek-moe-16b (f32) on DTensors over
    (data 1, model 2), 2 ranks on the card, the experts split over
    ``model``: output, aux loss and every gradient within 1e-5 of the
    plain call on the card, with and without capacity drops."""
    ranks = _local_job("torch_mesh_ranks:moe_ffn_on_mesh", 2, tmp_path,
                       shape=[1, 2], seed=3, capacity_factor=capacity_factor,
                       device="cuda")
    for r in ranks:
        assert not {k: v for k, v in r.items() if not v <= 1e-5}, r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 4e-2)])
def test_scan_on_two_ranks_of_one_card(cuda_device, tmp_path, dtype, tol):
    """``linear_scan``'s chunked forms and step on DTensors over (data 1,
    model 2), 2 ranks on the card, heads over ``model``: in bf16 the
    products take ``layers.bmm_f32``'s bf16-in, f32-out route on each
    rank's local tensors (DTensor has no rule for it). Outputs, states and
    gradients against the plain calls on the card."""
    ranks = _local_job("torch_mesh_ranks:scan_on_mesh", 2, tmp_path,
                       shape=[1, 2], seed=5, dtype=dtype, device="cuda")
    for r in ranks:
        assert len(r) == 3 * 8 - 1
        assert not {k: v for k, v in r.items() if not v <= tol}, r


@pytest.mark.cuda
def test_serve_multiport_example_on_card(cuda_device):
    """``repro_torch.examples.serve_multiport`` on the card in its three
    modes: every request served, equal greedy tokens, B1 = layers x decode
    cycles, B2 = layers x prefill cycles, B3 = pool traversals, and 1.00
    (fused) / 2.00 (single-port, reference) traversals a steady decode
    step."""
    from repro_torch.examples import serve_multiport
    from repro_torch.kernels import reset_launch_counts
    tokens = {}
    for mode, flags in (("pallas", []), ("single-port", ["--single-port"]),
                        ("reference", ["--kernel-mode", "reference"])):
        reset_launch_counts()
        eng = serve_multiport.main(flags)
        torch.cuda.synchronize()
        got = launch_counts()
        L, pallas = eng.cfg.n_layers, mode != "reference"
        assert got["kv_decode_append_attend"] == (
            L * eng.decode_steps if pallas else 0)
        assert got["kv_chunk_append_attend"] == (
            L * eng.prefill_steps if pallas else 0)
        assert got["multiport_sram_step"] == (
            eng.pool.traversals if pallas else 0)
        assert eng.decode_steps and eng.prefill_steps and eng.pool.traversals
        assert len(eng.finished) == 8
        assert eng.steady_decode_traversals == (
            1 if mode == "pallas" else 2) * eng.steady_decode_steps
        tokens[mode] = {r.rid: list(r.generated) for r in eng.finished}
    assert tokens["pallas"] == tokens["single-port"] == tokens["reference"]


@pytest.mark.cuda
def test_multiport_memory_demo_on_card_equals_the_cpu(cuda_device):
    from repro_torch.examples import multiport_memory_demo
    card = multiport_memory_demo.main([])
    cpu = multiport_memory_demo.main(["--device", "cpu"])
    assert card["reads"] == cpu["reads"] and card["slots"] == cpu["slots"]


@pytest.mark.cuda
def test_training_examples_on_card(cuda_device, tmp_path):
    """``quickstart`` and ``train_100m`` take 2 finite steps on the card;
    ``elastic_restart`` recovers with drift < 1e-5."""
    import math

    from repro_torch.examples import elastic_restart, quickstart, train_100m
    hist = quickstart.main(["--steps", "2"])
    assert all(math.isfinite(h["ce"]) for h in hist)
    runner = train_100m.main(["--steps", "2", "--ckpt",
                              str(tmp_path / "ckpt")])
    assert len(runner.history) == 2
    assert all(math.isfinite(h["ce"]) for h in runner.history)
    got = elastic_restart.main(["--work-dir", str(tmp_path / "elastic")])
    assert got["restarts"] == 2 and got["drift"] < elastic_restart.DRIFT_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"microbatches": 2}, {"remat": "none"},
                                {"optimizer": "adafactor"}], ids=str)
def test_dryrun_options_trace_on_the_card_s_path(cuda_device, kw):
    """``dryrun.trace_cell`` with each build option on fake CUDA tensors
    over a counting world of 4 (the card's code path)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import countgroup
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    cfg = registry.get("tinyllama-1.1b", reduced=True)
    with countgroup.world(4):
        mesh = make_mesh((2, 2), ("data", "model"), devices="cuda")
        ops = dryrun.trace_cell(cfg, ShapeCell("train", 16, 8, "train"), mesh,
                                shd.Rules.for_mesh(mesh), **kw)
    assert ops["dot_flops"] > 0 and ops["staged"]
