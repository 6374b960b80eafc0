"""Sharded training of the attention-free (rwkv6) and hybrid (zamba2)
families over CPU meshes of gloo ranks, against the JAX package's
one-device jitted step, with tests/distributed/test_multidevice.py's
tolerances (the helpers are tests/test_torch_mesh_families.py's):

* reduced rwkv6-3b and zamba2-7b over (data 2, model 2), batch 8 x 16,
  from the JAX initial parameters, for 3 steps (each step's ce and
  grad_norm, the last ``lm_head/w``; step 0's learning rate is 0): the
  scan on each rank's own rows and heads;
* ``linear_scan``'s chunked form (per-channel decay with the RWKV bonus,
  scalar decay) and its step form on DTensors, rows over ``data`` and
  heads over ``model``, against the plain calls at 1e-6 of each value's
  largest |value|, outputs and gradients;
* tp cutting a head: the same with a head dim of 32 (rwkv6) / 64
  (zamba2's Mamba2), so that their 2 heads do not split over (data 1,
  model 4): the head projections gather their columns and every rank of
  ``model`` computes both heads.

Every case runs in one world of 4 ranks (one start-up).
"""
import pytest

from test_torch_mesh_families import check_case, check_within, run_world

# (name, arch, edit of the reduced config, mesh (data, model))
CASES = [("rwkv6-3b", "rwkv6-3b", None, (2, 2)),
         ("zamba2-7b", "zamba2-7b", None, (2, 2)),
         ("rwkv6-3b heads cut", "rwkv6-3b", {"rwkv": {"head_dim": 32}},
          (1, 4)),
         ("zamba2-7b heads cut", "zamba2-7b", {"ssm": {"head_dim": 64}},
          (1, 4))]


SCAN_TOL = 1e-6
SCAN_MESHES = [(2, 2), (1, 4)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("recurrent"), CASES, [
        {"name": f"scan {s}", "fn": "scan_on_mesh", "shape": list(s),
         "seed": 5, "dtype": "float32"} for s in SCAN_MESHES])


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_step_matches_jax_one_device(world, name):
    check_case(world, name)


@pytest.mark.parametrize("shape", SCAN_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_scan_on_dtensors_matches_the_plain_call(world, shape):
    """Both chunked forms and the step on each rank's own rows and heads:
    outputs, final states and every gradient (the bonus's summed over the
    row shards) within 1e-6 of the plain calls'."""
    assert len(world[0][0][f"scan {shape}"]) == 3 * 8 - 1
    check_within(world, f"scan {shape}", SCAN_TOL)
