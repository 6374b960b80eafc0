"""Each CUDA kernel of the port against its plain torch version, on the card.

These tests need a CUDA device and the CUDA toolkit (the kernels are built
by ``nvcc`` at first use); without a card they skip. They import no JAX, so
they run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerances are those of the JAX suite (``tests/kernels/
test_attention_kernels.py``): f32 1e-5 with TF32 off, bf16 4e-2. Cache
updates, serviced-tile counts and the pool step are bit-exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ports import READ, WRITE
from repro_torch.kernels import kv_multiport as kvmp
from repro_torch.kernels import kv_prefill_chunk as kvpc
from repro_torch.kernels import launch_counts
from repro_torch.kernels import multiport_sram as mps

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


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,cdt", [("f32", "f32"), ("bf16", "f32"),
                                     ("bf16", "bf16")])
def test_chunk_kernel_on_card(rng, cuda_device, qdt, cdt):
    """Offsets at 0 and at tile edges, a one-row and an empty chunk, a dead
    row; 16 chunk rows x 32 heads spread over two query-row blocks."""
    s, c, hkv, g, d, tile = 128, 16, 4, 8, 64, 16
    off = [0, tile - 1, tile, 40, -1, 100, 3]
    cl = [16, 16, 1, 9, 0, 16, 0]
    b = len(off)
    q = _normal(rng, cuda_device, qdt, b, c, hkv * g, d)
    ck, cv = (_normal(rng, cuda_device, cdt, b, s, hkv, d) for _ in "kv")
    nk, nv = (_normal(rng, cuda_device, cdt, b, c, hkv, d) for _ in "kv")
    of, ln = _ints(cuda_device, off), _ints(cuda_device, cl)
    ck_p, cv_p = ck.clone(), cv.clone()
    o, _, _, t = kvpc.fused_chunk_append_attend(
        q, ck, cv, nk, nv, of, ln, seq_tile=tile, return_tiles=True)
    o_p, t_p = kvpc.fused_chunk_append_attend_plain(
        q, ck_p, cv_p, nk, nv, of, ln, seq_tile=tile, n_tiles=s // tile)
    tol = F32_TOL if qdt == cdt == "f32" else BF16_TOL
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)
    assert torch.equal(t, t_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("roles", [(WRITE, READ, WRITE, READ),
                                   (WRITE, WRITE, READ), (READ,)])
def test_pool_step_kernel_on_card(rng, cuda_device, dt, roles):
    """Bit-exact, with reads of words an earlier port wrote this cycle."""
    words, width, q = 512, 300, 64        # width not a multiple of 128
    storage = _normal(rng, cuda_device, dt, words, width)
    addr = rng.integers(0, words, (len(roles), q)).astype(np.int32)
    addr[1:, : q // 2] = addr[0, : q // 2]
    mask = rng.random((len(roles), q)) > 0.2
    for slot, role in enumerate(roles):        # dedup write lanes, last wins
        if role == WRITE:
            last = {w: i for i, w in enumerate(addr[slot])}
            mask[slot] &= [last[w] == i for i, w in enumerate(addr[slot])]
    addr_t = torch.from_numpy(addr).to(cuda_device)
    mask_t = torch.from_numpy(mask).to(cuda_device)
    data = _normal(rng, cuda_device, dt, len(roles), q, width)
    st_p = storage.clone()
    before = launch_counts()["multiport_sram_step"]
    r_k = mps.multiport_sram_step(storage, addr_t, data, mask_t, roles=roles)
    assert launch_counts()["multiport_sram_step"] == before + 1
    r_p = mps.multiport_sram_step_plain(st_p, addr_t, data, mask_t,
                                        roles=roles)
    assert torch.equal(storage, st_p) and torch.equal(r_k, r_p)


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
    out = kvmp.split_combine(acc, st, torch.float32, hkv)
    out_p = kvmp.split_combine_plain(acc, st, torch.float32)
    torch.testing.assert_close(out, out_p, atol=F32_TOL, rtol=F32_TOL)
