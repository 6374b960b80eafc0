"""The pool step (B3) on the CPU: its plain version, which takes payloads
for the write slots only and returns results for the read slots only, and
the ``ops.multiport_step`` that packs for it, against the JAX package's
pool step (the Pallas kernel in interpret mode) and ``core.step`` on the
same numpy-drawn inputs. The kernel itself is held against the plain
version on the card by ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MemorySpec as JSpec
from repro.core import PortConfig as JConfig
from repro.core import PortRequest as JRequest
from repro.core import step as jstep
from repro.kernels import ops as jops
from repro_torch.core import READ, WRITE, MemorySpec, PortConfig, PortRequest
from repro_torch.core.multiport import _dedup_last_wins
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import multiport_sram as mps

DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
R, W = READ, WRITE


def _case(rng, num_words, width, q, jdt, addr_hi, on=0.75):
    """Four ports' requests, the same in both packages; ``on`` is the share
    of lanes on (or a lane count when it is an int)."""
    reqs_j, reqs_t = [], []
    for _ in range(4):
        addr = rng.integers(0, addr_hi, q).astype(np.int32)
        data = rng.normal(size=(q, width)).astype(np.float32)
        if isinstance(on, int):
            mask = np.zeros(q, bool)
            mask[rng.choice(q, on, replace=False)] = True
        else:
            mask = rng.random(q) < on
        reqs_j.append(JRequest(addr=jnp.asarray(addr),
                               data=jnp.asarray(data, jdt),
                               mask=jnp.asarray(mask)))
        reqs_t.append(PortRequest(addr=torch.from_numpy(addr),
                                  data=torch.from_numpy(data).to(DT[jdt]),
                                  mask=torch.from_numpy(mask)))
    storage = rng.normal(size=(num_words, width)).astype(np.float32)
    return (jnp.asarray(storage, jdt), torch.from_numpy(storage).to(DT[jdt]),
            reqs_j, reqs_t)


def _pack(cfg: PortConfig, num_words: int, reqs):
    """The packed operands of the plain version, as ``ops.multiport_step``
    builds them: enabled ports in service order, write lanes deduplicated,
    out-of-range lanes off, payloads for the write slots only."""
    addrs, masks, payloads = [], [], []
    order = cfg.service_order()
    for p in order:
        r = reqs[p]
        m = r.mask
        if cfg.roles[p] == WRITE:
            m = _dedup_last_wins(r.addr, m)
            payloads.append(r.data)
        m = m & (r.addr >= 0) & (r.addr < num_words)
        addrs.append(torch.where(m, r.addr, 0))
        masks.append(m)
    return (torch.stack(addrs).to(torch.int32), payloads, torch.stack(masks),
            tuple(cfg.roles[p] for p in order), order)


def _same(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def _check_plain(cfg_t, num_words, ts, tr, s_want, r_want):
    """The plain version on the packed ports: storage as JAX's, one result
    per read slot in slot order, each equal to that port's JAX result."""
    addr, payloads, mask, roles, order = _pack(cfg_t, num_words, tr)
    st = ts.clone()
    got = mps.multiport_sram_step_plain(st, addr, payloads, mask, roles=roles)
    reads = [p for p in order if cfg_t.roles[p] == READ]
    assert got.shape == (len(reads), addr.shape[1], ts.shape[1])
    _same(st, s_want)
    for slot, p in enumerate(reads):
        _same(got[slot], r_want[p])


def _check_ops(spec_t, cfg_t, ts, tr, s_want, r_want):
    """The repacked ``ops.multiport_step``: storage updated in place, one
    [Q, W] result per port, zeros for write and disabled ports, and no
    launch on CPU tensors."""
    st = ts.clone()
    before = launch_counts()
    s_k, r_k = ops.multiport_step(spec_t, cfg_t, st, tr)
    assert s_k is st and launch_counts() == before
    _same(s_k, s_want)
    assert len(r_k) == 4
    for p in range(4):
        assert r_k[p].shape == (tr[0].queue_len, ts.shape[1])
        _same(r_k[p], r_want[p])


@pytest.mark.parametrize("num_words,width,banks,q", [
    (32, 4, 4, 4),
    (64, 8, 8, 16),
    (128, 16, 4, 32),
    (64, 4, 1, 8),
    (64, 4, 64, 8),
])
@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
def test_plain_pool_step_matches_jax_kernel(rng, num_words, width, banks, q,
                                            jdt):
    """The plain version's packed interface against the JAX Pallas pool
    step (interpret) on the sweep of tests/kernels/test_multiport_kernel.py,
    2W+2R with out-of-range lanes."""
    roles = (WRITE, READ, WRITE, READ)
    js, ts, jr, tr = _case(rng, num_words, width, q, jdt, num_words + 4)
    spec_j = JSpec(num_words=num_words, word_width=width, num_banks=banks,
                   dtype=jdt)
    s_j, r_j = jops.multiport_step(spec_j, JConfig(enabled=(True,) * 4,
                                                   roles=roles),
                                   js, jr, interpret=True)
    _check_plain(PortConfig(enabled=(True,) * 4, roles=roles), num_words, ts,
                 tr, s_j, r_j)


HAZARDS = {
    # every port hits the same 3 words, so each pair of neighbours in the
    # service order is a hazard of its kind
    "R>W>R>W": ((True,) * 4, (R, W, R, W), (0, 1, 2, 3)),    # R->W, W->R
    "W>W>R>R": ((True,) * 4, (W, W, R, R), (0, 1, 2, 3)),    # W->W, R->R
    "permuted": ((True,) * 4, (R, W, W, R), (3, 1, 0, 2)),   # R->W->W->R
    "W>R, two off": ((True, False, True, False), (W, R, R, R), (2, 0, 1, 3)),
}


@pytest.mark.parametrize("mix", sorted(HAZARDS))
@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
def test_pool_step_hazard_orders_match_jax(rng, mix, jdt):
    """Ports that hit the same words in the orders R->W, W->R and W->W
    (under the default and a permuted priority): the plain version and
    ``ops.multiport_step`` against JAX's ``core.step`` and its Pallas pool
    step."""
    enabled, roles, prio = HAZARDS[mix]
    num_words, width, q = 16, 8, 24
    js, ts, jr, tr = _case(rng, num_words, width, q, jdt, 3)
    cfg_j = JConfig(enabled=enabled, roles=roles, priority=prio)
    cfg_t = PortConfig(enabled=enabled, roles=roles, priority=prio)
    spec_j = JSpec(num_words=num_words, word_width=width, num_banks=4,
                   dtype=jdt)
    spec_t = MemorySpec(num_words=num_words, word_width=width, num_banks=4,
                        dtype=DT[jdt])
    s_j, r_j = jstep(spec_j, cfg_j, js, jr)
    s_k, r_k = jops.multiport_step(spec_j, cfg_j, js, jr, interpret=True)
    _same(torch.tensor(np.asarray(s_k, np.float32)), s_j)
    _check_plain(cfg_t, num_words, ts, tr, s_j, r_j)
    _check_ops(spec_t, cfg_t, ts, tr, s_j, r_j)


@pytest.mark.parametrize("what,enabled,roles,q,on", [
    # a read-only port with almost every lane off, as the long path's
    # short gathers are
    ("read-only, 3 of 1024 on", (False, True, False, False), (W, R, W, W),
     1024, 3),
    # every lane of every port off: storage unchanged, every read zeros
    ("all lanes off", (True,) * 4, (W, R, W, R), 32, 0),
])
def test_pool_step_sparse_lanes_match_jax(rng, what, enabled, roles, q, on):
    num_words, width = 64, 8
    js, ts, jr, tr = _case(rng, num_words, width, q, jnp.float32, num_words,
                           on=on)
    cfg_j = JConfig(enabled=enabled, roles=roles)
    cfg_t = PortConfig(enabled=enabled, roles=roles)
    spec_j = JSpec(num_words=num_words, word_width=width, num_banks=8)
    spec_t = MemorySpec(num_words=num_words, word_width=width, num_banks=8)
    s_j, r_j = jstep(spec_j, cfg_j, js, jr)
    s_k, r_k = jops.multiport_step(spec_j, cfg_j, js, jr, interpret=True)
    for p in range(4):
        _same(torch.tensor(np.asarray(r_k[p], np.float32)), r_j[p])
    if on == 0:
        _same(ts, s_j)
        assert not any(np.asarray(r).any() for r in r_j)
    _check_plain(cfg_t, num_words, ts, tr, s_j, r_j)
    _check_ops(spec_t, cfg_t, ts, tr, s_j, r_j)


def test_plain_pool_step_takes_payloads_for_write_slots_only():
    """The wrapper takes one payload per write slot and refuses any other
    count; W->R and W->W order hold within the call."""
    storage = torch.zeros((8, 4))
    addr = torch.tensor([[1, 2], [1, 3], [2, 2]], dtype=torch.int32)
    mask = torch.tensor([[True, True], [True, False], [False, True]])
    roles = (WRITE, READ, WRITE)
    data = torch.arange(2 * 2 * 4, dtype=torch.float32).reshape(2, 2, 4)
    with pytest.raises(ValueError, match="packed ports disagree"):
        mps.multiport_sram_step(storage, addr, list(data) * 2, mask,
                                roles=roles)
    with pytest.raises(ValueError, match="packed ports disagree"):
        mps.multiport_sram_step(storage, addr, [data[0]], mask, roles=roles)
    reads = mps.multiport_sram_step(storage, addr, list(data), mask,
                                    roles=roles)
    assert reads.shape == (1, 2, 4)
    assert torch.equal(reads[0, 0], data[0, 0])          # W->R
    assert not reads[0, 1].any()                         # lane off
    assert torch.equal(storage[2], data[1, 1])           # W->W, last wins
    assert torch.equal(storage[1], data[0, 0])
