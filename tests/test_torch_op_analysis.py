"""The port's per-rank op analysis (``repro_torch.launch.op_analysis``)
against hand-countable programs: the counterpart of
tests/launch/test_hlo_analysis.py, case for case, with the JAX analyzer's
own count beside the port's where the two count the same thing.

The port runs each Python loop iteration op by op, so the JAX tests' scans
are plain loops here; the collectives run over an in-process counting
world (``distributed/countgroup.py``) on fake tensors, as the dry run
runs them. Two cases are the port's own: a matmul on a (2, 2) mesh counts
the rank's quarter of the global FLOPs, and a chain's peak bytes.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, empty

from repro.launch import hlo_analysis as HA
from repro_torch.distributed import countgroup
from repro_torch.launch import op_analysis as OA
from repro_torch.launch.mesh import make_mesh


def _jax(fn, *args):
    return HA.analyze(jax.jit(fn).lower(*args).compile().as_text())


def test_loop_of_matmuls_counts_every_iteration():
    w = torch.ones(256, 256)

    def looped(x):
        for _ in range(7):
            x = x @ w
        return x

    def body(c, _):
        return c @ jnp.ones((256, 256), jnp.float32), None

    _, a = OA.analyze(looped, torch.ones(256, 256))
    want = 2 * 256 ** 3 * 7
    assert a["dot_flops"] == want
    jx = _jax(lambda x: jax.lax.scan(body, x, None, length=7)[0],
              jnp.ones((256, 256), jnp.float32))
    assert jx["dot_flops"] == a["dot_flops"]


def test_nested_loops_multiply():
    w = torch.ones(128, 128)

    def f(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    _, a = OA.analyze(f, torch.ones(128, 128))
    assert a["dot_flops"] == 2 * 128 ** 3 * 15


def test_gqa_einsum_flops():
    q, k = torch.ones(2, 4, 64, 32), torch.ones(2, 4, 64, 32)
    _, a = OA.analyze(lambda q, k: torch.einsum("bhsd,bhtd->bhst", q, k),
                      q, k)
    assert a["dot_flops"] == 2 * 2 * 4 * 64 * 64 * 32
    jx = _jax(lambda q, k: jnp.einsum("bhsd,bhtd->bhst", q, k),
              jnp.ones((2, 4, 64, 32)), jnp.ones((2, 4, 64, 32)))
    assert jx["dot_flops"] == a["dot_flops"]


def test_slice_counts_window_not_operand():
    big = torch.ones(4096, 256)                   # 4 MB
    _, a = OA.analyze(lambda x: x[16:32] * 2.0, big)
    # refined traffic must be well under one full read of the operand
    assert a["traffic_bytes"] < big.numel() * 4 * 0.5
    assert a["traffic_bytes"] == 2 * 16 * 256 * 4     # read and write
    assert a["traffic_bytes_naive"] >= big.numel() * 4


def test_update_counts_twice_its_window():
    big, upd = torch.zeros(4096, 256), torch.ones(16, 256)

    def f(x, u):
        x[16:32] = u
        return x

    _, a = OA.analyze(f, big, upd)
    assert a["traffic_bytes"] == 2 * upd.numel() * 4
    assert a["traffic_bytes"] < big.numel() * 4
    assert a["alias_bytes"] == a["output_bytes"] == big.numel() * 4
    assert a["temp_bytes"] == 0


def test_collectives_counted_in_every_iteration():
    """A weight split over ``model`` by rows: each of the 5 layers sums
    partial products, one collective or more per iteration."""
    with countgroup.world(8):
        mesh = make_mesh((8,), ("model",), devices="cpu").device_mesh
        with FakeTensorMode():
            x = empty(64, 64, device_mesh=mesh, placements=[Shard(1)])
            ws = [empty(64, 64, device_mesh=mesh, placements=[Shard(0)])
                  for _ in range(5)]

        def f(x, ws):
            for w in ws:
                x = torch.tanh(x @ w)
            return x

        _, a = OA.analyze(f, x, ws)
    assert sum(a["collective_counts"].values()) >= 5
    assert sum(n for n, _ in a["staged"].values()) >= 5
    assert all(k.endswith(" x8") for k in a["staged"])


@pytest.mark.parametrize("fake", [True, False])
def test_sharded_matmul_counts_the_ranks_quarter(fake):
    """x [64, 32] split by rows over ``data`` times w [32, 16] split by
    columns over ``model``: the rank computes its [32, 8] block alone, a
    quarter of the global product, and moves nothing."""
    with countgroup.world(4):
        mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
        dm = mesh.device_mesh
        mode = FakeTensorMode() if fake else None
        with mode or torch.device("cpu"):
            x = empty(64, 32, device_mesh=dm,
                      placements=[Shard(0), Replicate()])
            w = empty(32, 16, device_mesh=dm,
                      placements=[Replicate(), Shard(1)])
        y, a = OA.analyze(lambda x, w: x @ w, x, w)
    assert a["dot_flops"] == 2 * 64 * 32 * 16 / 4
    assert a["staged"] == {}
    assert sum(a["collective_counts"].values()) == 0
    assert tuple(y.to_local().shape) == (32, 8)
    assert a["argument_bytes"] == (32 * 32 + 32 * 8) * 4
    assert a["output_bytes"] == a["temp_bytes"] == 32 * 8 * 4


def test_peak_bytes_of_a_chain():
    """x [1000] f32: ``x * 2`` (4000 B) lives until ``+ 1`` (4000 B) has
    been made, so the peak of the temporaries is 8000 B; the sum's 4 B
    come after ``x * 2`` is freed; ``x.add_`` allocates nothing and
    returns its argument."""
    x = torch.ones(1000)
    _, a = OA.analyze(lambda x: ((x * 2) + 1).sum(), x)
    assert a["argument_bytes"] == 4000
    assert a["temp_bytes"] == 8000
    assert a["peak_bytes"] == 12000
    assert a["output_bytes"] == 4
    _, a = OA.analyze(lambda x: x.add_(1), x)
    assert a["temp_bytes"] == 0
    assert a["alias_bytes"] == a["output_bytes"] == 4000
