"""The paper's baseline designs, the tensor priority encoder and the tensor
FSM walk of the port against the JAX package's, on the same numpy-drawn
inputs (mirrors of tests/core/test_baselines.py, of
test_multiport_semantics.py's single-port case and of test_ports.py's
encoder and walk cases)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MemorySpec as JSpec
from repro.core import PortConfig as JConfig
from repro.core import PortRequest as JRequest
from repro.core import baselines as jb
from repro.core import fsm as jfsm
from repro.core import priority as jprio
from repro.core.multiport import pack_requests as j_pack
from repro_torch.core import (READ, WRITE, MemorySpec, PortConfig,
                              PortRequest, reference_step, step)
from repro_torch.core import fsm, priority as prio
from repro_torch.core.baselines import (ReplicatedReads, SinglePortNPass,
                                        TrafficCounters, XorCoded,
                                        footprint_ratio)
from repro_torch.core.multiport import pack_requests

SPEC = MemorySpec(num_words=16, word_width=2, num_banks=4)
MASKS = [tuple(bool(m >> i & 1) for i in range(4)) for m in range(1, 16)]
PERMS = list(itertools.permutations(range(4)))


def _all_configs():
    """Every 1-4-port enable set x R/W role assignment (80 combinations)."""
    out = []
    for enabled in MASKS:
        on = [i for i in range(4) if enabled[i]]
        for bits in range(1 << len(on)):
            roles = [READ] * 4
            for k, p in enumerate(on):
                roles[p] = WRITE if bits >> k & 1 else READ
            out.append((enabled, tuple(roles)))
    return out


CONFIGS = _all_configs()


def _reqs(rng, num_words=16, width=2, q=5, hi=None):
    """Four port bundles drawn from ``rng``, as (torch, JAX) lists."""
    tr, jr = [], []
    for _ in range(4):
        addr = rng.integers(0, hi or num_words, q).astype(np.int32)
        data = rng.normal(size=(q, width)).astype(np.float32)
        mask = rng.random(q) > 0.3
        tr.append(PortRequest(addr=torch.from_numpy(addr),
                              data=torch.from_numpy(data),
                              mask=torch.from_numpy(mask)))
        jr.append(JRequest(addr=jnp.asarray(addr), data=jnp.asarray(data),
                           mask=jnp.asarray(mask)))
    return tr, jr


CFG = PortConfig(enabled=(True, True, True, True),
                 roles=(WRITE, READ, READ, READ))


def _zeros():
    return np.zeros((16, 2), np.float32)


# ---- mirrors of tests/core/test_baselines.py -------------------------------

def test_replicated_reads_semantics():
    base = ReplicatedReads(SPEC, n_read_ports=3)
    reqs, _ = _reqs(np.random.default_rng(3))
    s, reads = base.step(CFG, base.init_storage(device="cpu"), reqs)
    ref_s, ref_reads = reference_step(SPEC, CFG, _zeros(), reqs)
    for rep in range(3):   # every replica coherent with the reference
        np.testing.assert_array_equal(s[rep].numpy(), ref_s)
    for p in range(4):
        np.testing.assert_array_equal(reads[p].numpy(), ref_reads[p])


def test_xor_coded_semantics_and_parity():
    base = XorCoded(SPEC)
    reqs, _ = _reqs(np.random.default_rng(3))
    (data, parity), reads = base.step(CFG, base.init_storage(device="cpu"),
                                      reqs)
    ref_s, ref_reads = reference_step(SPEC, CFG, _zeros(), reqs)
    np.testing.assert_allclose(data.reshape(16, 2).numpy(), ref_s, atol=1e-6)
    for p in range(4):
        np.testing.assert_allclose(reads[p].numpy(), ref_reads[p])
    # parity bank == sum over banks (reconstruction invariant)
    np.testing.assert_allclose(parity.numpy(), data.sum(0).numpy(),
                               atol=1e-5)


def test_footprint_ratios_match_paper_table():
    """Area analogue: proposed = 1x; replicated-quad ~ the 12T school;
    XOR-coded = 1 + 1/banks."""
    q = 8
    single = SinglePortNPass(SPEC).counters(CFG, q)
    assert single.footprint_words == SPEC.num_words            # proposed: 1x
    rep = ReplicatedReads(SPEC, 3).counters(CFG, q)
    assert rep.footprint_words == 3 * SPEC.num_words
    xor = XorCoded(SPEC).counters(CFG, q)
    assert xor.footprint_words == SPEC.num_words + SPEC.words_per_bank
    assert footprint_ratio(rep, SPEC.num_words) == 3.0
    assert footprint_ratio(xor, SPEC.num_words) == 1.25


def test_bandwidth_traversal_counts():
    """Claim C1 structurally: the bare macro traverses storage once per
    enabled port."""
    q = 8
    for n in range(1, 5):
        cfg = PortConfig(enabled=tuple(i < n for i in range(4)),
                         roles=(WRITE, READ, READ, READ))
        c = SinglePortNPass(SPEC).counters(cfg, q)
        assert c.storage_traversals == n       # baseline: N passes


# ---- the single-port baseline over every mix (test_multiport_semantics) ----

@pytest.mark.parametrize("idx", range(0, 80, 5))
def test_single_port_baseline_matches_reference(idx):
    """SinglePortNPass == reference_step == core.step over every enable x
    role mix, each under a seeded priority permutation, with addresses that
    repeat (every hazard order) and a few out of range."""
    spec = MemorySpec(num_words=32, word_width=4, num_banks=4)
    rng = np.random.default_rng(idx)
    for enabled, roles in CONFIGS[idx:idx + 5]:
        cfg = PortConfig(enabled=enabled, roles=roles,
                         priority=PERMS[int(rng.integers(24))])
        reqs, _ = _reqs(rng, 32, 4, 6, hi=36)
        storage = torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4)
        s_b, r_b = SinglePortNPass(spec).step(cfg, storage, reqs)
        assert torch.equal(storage, torch.arange(128.).reshape(32, 4))
        s_ref, r_ref = reference_step(spec, cfg, storage, reqs)
        s_s, r_s = step(spec, cfg, storage, reqs)
        np.testing.assert_array_equal(s_b.numpy(), s_ref)
        assert torch.equal(s_b, s_s)
        for p in range(4):
            np.testing.assert_array_equal(r_b[p].numpy(), r_ref[p])
            assert torch.equal(r_b[p], r_s[p])


# ---- the port's baselines against the JAX baselines ------------------------

def _baseline_pair(name):
    jspec = JSpec(num_words=16, word_width=2, num_banks=4)
    return {"single": (SinglePortNPass(SPEC), jb.SinglePortNPass(jspec)),
            "replicated": (ReplicatedReads(SPEC, 3),
                           jb.ReplicatedReads(jspec, 3)),
            "xor": (XorCoded(SPEC), jb.XorCoded(jspec))}[name]


@pytest.mark.parametrize("name", ["single", "replicated", "xor"])
@pytest.mark.parametrize("idx", range(0, 80, 10))
def test_baselines_match_jax(name, idx):
    """Each baseline's storage, reads and counters == the JAX baseline's on
    the same inputs, two steps from an empty storage, over every mix under a
    seeded priority: bit-exact, except the XOR parity's float sums (1e-6)."""
    tb, jbase = _baseline_pair(name)
    rng = np.random.default_rng(100 + idx)
    for enabled, roles in CONFIGS[idx:idx + 10]:
        perm = PERMS[int(rng.integers(24))]
        tcfg = PortConfig(enabled=enabled, roles=roles, priority=perm)
        jcfg = JConfig(enabled=enabled, roles=roles, priority=perm)
        tr, jr = _reqs(rng, q=6)
        ts, js = tb.init_storage(device="cpu"), jbase.init_storage()
        # a first step from zeros, then a second one on its result
        for _ in range(2):
            ts, t_reads = tb.step(tcfg, ts, tr)
            js, j_reads = jbase.step(jcfg, js, jr)
            for p in range(4):
                np.testing.assert_array_equal(t_reads[p].numpy(),
                                              np.asarray(j_reads[p]))
            if name == "xor":
                np.testing.assert_array_equal(ts[0].numpy(),
                                              np.asarray(js[0]))
                np.testing.assert_allclose(ts[1].numpy(), np.asarray(js[1]),
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            tr, jr = _reqs(rng, q=6)
        assert (_fields(tb.counters(tcfg, 6))
                == _fields(jbase.counters(jcfg, 6)))


def _fields(c) -> tuple:
    return (c.storage_traversals, c.words_read, c.words_written,
            c.footprint_words)


def test_xor_parity_telescopes_on_duplicate_lanes():
    """Three lanes of one write port hit the same word: only the last value
    lands, and the parity moves by (v_last - old) only."""
    base = XorCoded(SPEC)
    data, parity = base.init_storage(device="cpu")
    data.reshape(16, 2)[5] = torch.tensor([1.0, 2.0])
    parity.copy_(data.sum(0))
    w = PortRequest(addr=torch.tensor([5, 5, 5, 9], dtype=torch.int32),
                    data=torch.tensor([[7., 7.], [8., 8.], [9., 3.],
                                       [4., 4.]]),
                    mask=torch.tensor([True, True, True, False]))
    idle = PortRequest(addr=torch.zeros(4, dtype=torch.int32),
                       data=torch.zeros(4, 2), mask=torch.zeros(4, dtype=bool))
    cfg = PortConfig(enabled=(True, False, False, False),
                     roles=(WRITE, READ, READ, READ))
    (d2, p2), _ = base.step(cfg, (data, parity), [w, idle, idle, idle])
    assert d2.reshape(16, 2)[5].tolist() == [9.0, 3.0]
    assert torch.equal(p2, d2.sum(0))
    assert data.reshape(16, 2)[5].tolist() == [1.0, 2.0]   # input untouched


def test_xor_parity_skips_dropped_out_of_range_writes():
    """A write lane past the storage is dropped, and so is its parity
    delta: the parity stays the sum of the banks. (The JAX baseline adds
    the delta of such a lane; ROADMAP section C records the difference.)"""
    base = XorCoded(SPEC)
    w = PortRequest(addr=torch.tensor([3, 16, 40], dtype=torch.int32),
                    data=torch.ones(3, 2), mask=torch.ones(3, dtype=bool))
    cfg = PortConfig(enabled=(True, False, False, False),
                     roles=(WRITE, READ, READ, READ))
    (d, p), _ = base.step(cfg, base.init_storage(device="cpu"),
                          [w] + [w] * 3)
    assert float(d.sum()) == 2.0
    assert torch.equal(p, d.sum(0))


def test_traffic_counters_are_jax_fields():
    t = TrafficCounters(1, 2, 3, 4)
    j = jb.TrafficCounters(1, 2, 3, 4)
    assert _fields(t) == _fields(j)


# ---- the priority encoder and the FSM walk (test_ports.py) -----------------

def _t(x, dtype=None):
    return torch.tensor(x, dtype=dtype)


@pytest.mark.parametrize("enabled", MASKS)
def test_static_vs_dynamic_encoder_agree(enabled):
    """encode_static == the port's encode_dynamic == JAX's, for every
    priority permutation; rank_of is JAX's inverse permutation."""
    for priority in PERMS:
        st = prio.encode_static(enabled, priority)
        assert st == jprio.encode_static(enabled, priority)
        dy = prio.encode_dynamic(_t(enabled), _t(priority))
        assert dy.dtype == torch.int32 and dy.shape == ()
        assert int(dy) == st == int(jprio.encode_dynamic(
            jnp.array(enabled), jnp.array(priority)))
        assert prio.order_static(enabled, priority) == \
            jprio.order_static(enabled, priority)
        np.testing.assert_array_equal(
            prio.rank_of(_t(priority)).numpy(),
            np.asarray(jprio.rank_of(jnp.array(priority))))


def test_encoder_with_nothing_enabled_returns_jax_value():
    """All-False mask: JAX's argmax of an all-False vector is 0, so it
    returns priority[0] (its docstring says priority[-1]); the port returns
    what JAX computes."""
    none = (False,) * 4
    for priority in PERMS:
        got = int(prio.encode_dynamic(_t(none), _t(priority)))
        assert got == int(jprio.encode_dynamic(jnp.array(none),
                                               jnp.array(priority)))
        assert got == priority[0]
    with pytest.raises(ValueError, match="no port enabled"):
        prio.encode_static(none, (0, 1, 2, 3))


@pytest.mark.parametrize("enabled", MASKS)
def test_dynamic_fsm_walk_matches_static_order(enabled):
    """Walking next_port_dynamic from the reset state visits service_order,
    one more transition wraps to the start (Fig. 2's reset arc); the port
    and JAX agree at every step, for every permutation."""
    en = _t(enabled)
    for priority in PERMS:
        pr = _t(priority)
        order = prio.order_static(enabled, priority)
        cur = fsm.reset_state(en, pr)
        jcur = jfsm.reset_state(jnp.array(enabled), jnp.array(priority))
        walked = [int(cur)]
        for _ in range(len(order)):
            cur = fsm.transition(cur, en, pr)
            jcur = jfsm.transition(jcur, jnp.array(enabled),
                                   jnp.array(priority))
            assert int(cur) == int(jcur)
            walked.append(int(cur))
        assert tuple(walked[:-1]) == order
        assert walked[-1] == order[0]
        # and from every port, enabled or not, one transition agrees
        for p in range(4):
            assert int(prio.next_port_dynamic(_t(p), en, pr)) == int(
                jprio.next_port_dynamic(jnp.array(p), jnp.array(enabled),
                                        jnp.array(priority)))


@pytest.mark.parametrize("enabled", MASKS)
def test_walk_order_dynamic_matches_jax(enabled):
    for priority in PERMS:
        ports, active = fsm.walk_order_dynamic(_t(enabled), _t(priority))
        jp, ja = jfsm.walk_order_dynamic(jnp.array(enabled),
                                         jnp.array(priority))
        assert ports.dtype == torch.int32 and active.dtype == torch.bool
        np.testing.assert_array_equal(ports.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(active.numpy(), np.asarray(ja))
        n = sum(enabled)
        assert tuple(ports[:n].tolist()) == prio.order_static(enabled,
                                                              priority)


@pytest.mark.parametrize("enabled", MASKS)
def test_walk_dynamic_equals_walk_static(enabled):
    """walk_dynamic with a service that is a no-op on inactive slots does
    what walk_static does with the same service: here, one port step each
    on the same storage, and the visit log."""
    spec = MemorySpec(num_words=16, word_width=2, num_banks=4)
    rng = np.random.default_rng(sum(enabled))
    for priority in PERMS[::5]:
        roles = tuple(int(r) for r in rng.integers(0, 2, 4))
        cfg = PortConfig(enabled=enabled, roles=roles, priority=priority)
        reqs, _ = _reqs(rng, q=6)

        def service(state, port):
            storage, log = state
            one = PortConfig(enabled=tuple(i == port for i in range(4)),
                             roles=roles)
            storage, _ = step(spec, one, storage, reqs)
            return storage, log + [port]

        def dyn_service(state, port, active):
            # a tensor port id; a no-op when the slot is idle
            storage, log = state
            p = int(port)
            new, _ = step(spec, PortConfig(
                enabled=tuple(i == p for i in range(4)), roles=roles),
                storage, reqs)
            keep = active.reshape(1, 1)
            return torch.where(keep, new, storage), log + (
                [p] if bool(active) else [])

        storage = torch.from_numpy(rng.normal(size=(16, 2)).astype(
            np.float32))
        want = fsm.walk_static(cfg, (storage, []), service)
        got = fsm.walk_dynamic(_t(enabled), _t(priority), (storage, []),
                               dyn_service)
        assert got[1] == want[1] == list(cfg.service_order())
        assert torch.equal(got[0], want[0])


def test_pack_requests_matches_jax():
    tr, jr = _reqs(np.random.default_rng(7), q=6)
    cfg = PortConfig(enabled=(True, False, True, False),
                     roles=(WRITE, READ, READ, READ))
    jcfg = JConfig(enabled=(True, False, True, False),
                   roles=(WRITE, READ, READ, READ))
    jspec = JSpec(num_words=16, word_width=2, num_banks=4)
    got = pack_requests(cfg, 6, SPEC, device="cpu", a=tr[0], c=tr[2])
    want = j_pack(jcfg, 6, jspec, a=jr[0], c=jr[2])
    assert got[0] is tr[0] and got[2] is tr[2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.addr.numpy(), np.asarray(w.addr))
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        assert g.data.dtype == torch.float32
