"""The port's core (port semantics, the pool-step wrapper) against the JAX
package's, on the same numpy-drawn inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MemorySpec as JSpec
from repro.core import PortConfig as JConfig
from repro.core import PortRequest as JRequest
from repro.core import step as jstep
from repro.core.fsm import rotate_single_port as j_rotate
from repro.core.multiport import _dedup_last_wins as j_dedup
from repro.kernels import ops as jops
from repro_torch.core import (READ, WRITE, MemorySpec, PortConfig,
                              PortRequest, build_schedule, empty_request,
                              read_request, reference_step, step)
from repro_torch.core.fsm import PhaseError, rotate_single_port
from repro_torch.core.multiport import _dedup_last_wins
from repro_torch.configs import registry as treg
from repro_torch.core.priority import complete_priority
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.attention import attention_init
from repro_torch.models.blocks import transformer_block_init
from repro_torch.models.mlp import moe_init, swiglu_init

DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _all_configs():
    """Every 1-4-port enable set x R/W role assignment (80 combinations)."""
    out = []
    for mask in range(1, 16):
        enabled = tuple(bool(mask >> i & 1) for i in range(4))
        on = [i for i in range(4) if enabled[i]]
        for bits in range(1 << len(on)):
            roles = [READ] * 4
            for k, p in enumerate(on):
                roles[p] = WRITE if bits >> k & 1 else READ
            out.append((enabled, tuple(roles)))
    return out


CONFIGS = _all_configs()


def _case(rng, num_words, width, q, jdt=jnp.float32, addr_hi=None):
    reqs_j, reqs_t = [], []
    for _ in range(4):
        addr = rng.integers(0, addr_hi or num_words, q).astype(np.int32)
        data = rng.normal(size=(q, width)).astype(np.float32)
        mask = rng.random(q) > 0.25
        reqs_j.append(JRequest(addr=jnp.asarray(addr), data=jnp.asarray(data, jdt),
                               mask=jnp.asarray(mask)))
        reqs_t.append(PortRequest(addr=torch.from_numpy(addr),
                                  data=torch.from_numpy(data).to(DT[jdt]),
                                  mask=torch.from_numpy(mask)))
    storage = rng.normal(size=(num_words, width)).astype(np.float32)
    return (jnp.asarray(storage, jdt), torch.from_numpy(storage).to(DT[jdt]),
            reqs_j, reqs_t)


def _same(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_eighty_configurations_enumerated():
    assert len(CONFIGS) == 80


@pytest.mark.parametrize("idx", range(0, 80, 5))
def test_step_matches_jax_over_all_80_mixes(idx):
    """core.step == JAX core.step (storage and every port's reads) for each
    enable x role combination; addresses repeat so same-cycle W->R
    visibility and last-wins dedup are exercised."""
    rng = np.random.default_rng(idx)
    for enabled, roles in CONFIGS[idx:idx + 5]:
        jcfg = JConfig(enabled=enabled, roles=roles)
        tcfg = PortConfig(enabled=enabled, roles=roles)
        spec_j = JSpec(num_words=16, word_width=4, num_banks=4)
        spec_t = MemorySpec(num_words=16, word_width=4, num_banks=4)
        js, ts, jr, tr = _case(rng, 16, 4, 12)
        s_j, r_j = jstep(spec_j, jcfg, js, jr)
        s_t, r_t = step(spec_t, tcfg, ts, tr)
        _same(s_t, s_j)
        for p in range(4):
            _same(r_t[p], r_j[p])
        s_r, r_r = reference_step(spec_t, tcfg, ts, tr)
        np.testing.assert_array_equal(s_t.numpy(), s_r)
        # the kernel wrapper (plain version on CPU) keeps the same contract
        s_k, r_k = ops.multiport_step(spec_t, tcfg, ts.clone(), tr)
        _same(s_k, s_j)
        for p in range(4):
            _same(r_k[p], r_j[p])


@pytest.mark.parametrize("num_words,width,banks,q", [
    (32, 4, 4, 4),
    (64, 8, 8, 16),
    (128, 16, 4, 32),
    (64, 4, 1, 8),
    (64, 4, 64, 8),
])
@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
def test_multiport_step_matches_jax_kernel(rng, num_words, width, banks, q,
                                           jdt):
    """ops.multiport_step against the JAX Pallas pool step (interpret), on
    the sweep of tests/kernels/test_multiport_kernel.py; out-of-range lanes
    are dropped by both."""
    cfg_j = JConfig(enabled=(True,) * 4, roles=(WRITE, READ, WRITE, READ))
    cfg_t = PortConfig(enabled=(True,) * 4, roles=(WRITE, READ, WRITE, READ))
    js, ts, jr, tr = _case(rng, num_words, width, q, jdt,
                           addr_hi=num_words + 4)
    spec_j = JSpec(num_words=num_words, word_width=width, num_banks=banks,
                   dtype=jdt)
    spec_t = MemorySpec(num_words=num_words, word_width=width,
                        num_banks=banks, dtype=DT[jdt])
    s_j, r_j = jops.multiport_step(spec_j, cfg_j, js, jr, interpret=True)
    s_t, r_t = ops.multiport_step(spec_t, cfg_t, ts, tr)
    assert s_t is ts                                  # updated in place
    _same(s_t, s_j)
    for p in range(4):
        _same(r_t[p], r_j[p])


@pytest.mark.parametrize("q,hi", [(1, 4), (16, 4), (64, 8), (257, 32)])
def test_dedup_mask_identical_to_jax(q, hi):
    rng = np.random.default_rng(q)
    addr = rng.integers(0, hi, q).astype(np.int32)
    mask = rng.random(q) > 0.3
    got = _dedup_last_wins(torch.from_numpy(addr), torch.from_numpy(mask))
    want = j_dedup(jnp.asarray(addr), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_describe_parse_round_trip_matches_jax():
    for enabled, roles in CONFIGS:
        t = PortConfig(enabled=enabled, roles=roles)
        j = JConfig(enabled=enabled, roles=roles)
        assert t.describe() == j.describe()
        back = PortConfig.parse(t.describe())
        assert back.describe() == t.describe()
        assert back.service_order() == t.service_order()
        assert build_schedule(t).slots == t.service_order()
    assert complete_priority((3, 0, 1)) == (3, 0, 1, 2)


def test_rotate_single_port_matches_jax():
    sched = (0, 2, 3)
    for phase in range(9):
        assert rotate_single_port(sched, phase) == j_rotate(sched, phase)
    with pytest.raises(PhaseError):
        rotate_single_port(sched, -1)


@pytest.mark.parametrize("make", [
    lambda **kw: MemorySpec(num_words=16, word_width=4).init_storage(**kw),
    lambda **kw: empty_request(4, 8, **kw).data,
    lambda **kw: read_request([0, 3], 8, **kw).data,
], ids=["init_storage", "empty_request", "read_request"])
def test_memory_helpers_default_to_the_card(make):
    """Like every entry point of the port, the memory's own constructors
    put their tensors on the card unless asked for the CPU, and raise
    without one (they defaulted to the CPU before)."""
    assert make(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def _init_gen(kw):
    """A generator on the device the call will draw on (the card when the
    call names none and one is present)."""
    on_card = "device" not in kw and torch.cuda.is_available()
    return torch.Generator(device="cuda" if on_card else "cpu").manual_seed(0)




@pytest.mark.parametrize("make", [
    lambda **kw: L.linear_init(_init_gen(kw), 4, 8, **kw)["w"],
    lambda **kw: L.embedding_init(_init_gen(kw), 10, 4, **kw)["w"],
    lambda **kw: L.rmsnorm_init(4, **kw)["scale"],
    lambda **kw: L.rope_frequencies(8, **kw),
    lambda **kw: swiglu_init(_init_gen(kw), 4, 8, **kw)["w_up"]["w"],
    lambda **kw: attention_init(_init_gen(kw), 16, 4, 2, 4, **kw)["wq"]["w"],
    lambda **kw: transformer_block_init(
        _init_gen(kw), treg.get("tinyllama-1.1b", reduced=True),
        **kw)["ln1"]["scale"],
    lambda **kw: moe_init(
        _init_gen(kw), 8, treg.get("deepseek-moe-16b", reduced=True).moe,
        **kw)["w_down"],
    lambda **kw: L.sinusoidal_positions(4, 8, **kw),
], ids=["linear_init", "embedding_init", "rmsnorm_init", "rope_frequencies",
        "swiglu_init", "attention_init", "transformer_block_init",
        "moe_init", "sinusoidal_positions"])
def test_model_init_helpers_default_to_the_card(make):
    """The model's public init helpers, like ``init_params`` and the JAX
    counterparts, build on the accelerator unless asked for the CPU, and
    raise without one (they defaulted to the CPU before)."""
    assert make(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
