"""The training launcher's mesh path and the meshes, on CPU jobs of gloo
ranks (``repro_torch.launch.local_ranks``; rank bodies in
tests/torch_mesh_ranks.py): ``train_on_mesh`` (the body of ``--mesh
production`` once the mesh is built) against the one-device launcher,
the three optimizers' states staying on their specs through sharded
steps, the production mesh's refusal of a job of another size, and the
host-staged backend's collective probe on CPU ranks."""
import os

import numpy as np
import pytest

from repro_torch.launch import local_ranks
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launch_train

HERE = os.path.dirname(os.path.abspath(__file__))
CE_RTOL = 1e-5
WORLD_TIMEOUT = 300

@pytest.mark.parametrize("extra", [[], ["--multi-pod", "--compress-grads"]],
                         ids=["adamw", "int8_ef_without_a_pod_axis"])
def test_launcher_trains_on_a_debug_mesh(tmp_path, capsys, extra):
    """``train_on_mesh`` over (data 2, model 2): the one-device launcher's
    losses (seed-0 parameters drawn once, on rank 0), rank 0's two report
    lines, and a resumed run that takes no step. With int8_ef over 2 pods
    on a mesh without a ``pod`` axis, every rank takes both pods' grads and
    reduces them alike."""
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "8", "--seq", "16", *extra]
    ranks = local_ranks.run(
        "torch_mesh_ranks:launcher_on_mesh", 4, device="cpu",
        kwargs=dict(shape=[2, 2],
                    argv=argv + ["--ckpt-dir", str(tmp_path / "mesh")]),
        timeout=WORLD_TIMEOUT, path=[HERE], workdir=str(tmp_path / "job"))
    one = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    capsys.readouterr()
    r0 = ranks[0]
    np.testing.assert_allclose(r0["ce"], [h["ce"] for h in one.history],
                               rtol=CE_RTOL)
    assert r0["resumed"] == 0 and all(r["lines"] == "" for r in ranks[1:])
    lines = r0["lines"].splitlines()
    assert lines[0].startswith("arch=tinyllama-1.1b") and \
        "devices=4 (data 2 x model 2 on cpu)" in lines[0]
    assert lines[1].startswith("ce first5=") and \
        "(data 2 x model 2 on cpu)" in lines[1]
    assert "step_s median=none" in lines[3]


def test_host_staged_backend_probe_on_cpu_ranks(tmp_path):
    """Every collective DTensor issues, plain and functional, through the
    host-staged backend, == its local reduction on 3 ranks."""
    got = local_ranks.run("repro_torch.distributed.hoststaged:probe", 3,
                          device="cpu", kwargs={"device": "cpu"},
                          backend="hoststaged", timeout=WORLD_TIMEOUT,
                          workdir=str(tmp_path / "probe"))
    assert all(all(r.values()) for r in got) and len(got[0]) == 10


@pytest.mark.parametrize("multi_pod,shape,n", [(False, "(16, 16)", 256),
                                               (True, "(2, 16, 16)", 512)])
def test_production_mesh_names_the_shape_it_needs(multi_pod, shape, n):
    """A job of another size (this single process) cannot build it; the
    debug mesh's 8 ranks neither."""
    with pytest.raises(ValueError, match=rf"{shape[1:-1]}.*needs {n} ranks "
                                         rf"but the job has 1"):
        M.make_production_mesh(multi_pod=multi_pod, devices="cpu")
    with pytest.raises(ValueError, match=r"needs 8 ranks but the job has 1"):
        M.make_debug_mesh(devices="cpu")
    with pytest.raises(ValueError, match="differ in rank"):
        M.make_mesh((2, 2), ("data",), devices="cpu")


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit", "adafactor"])
def test_optimizer_states_stay_placed_by_their_specs(tmp_path, optimizer):
    """Two sharded steps from ``build_on_mesh`` over (data 2, model 2):
    every state leaf is placed by ``train_state_pspecs`` before and after
    (no pending reduction kept in the state), and the losses are the
    one-device build's."""
    got = local_ranks.run("torch_mesh_ranks:optimizer_state_placements", 4,
                          device="cpu", kwargs={"optimizer": optimizer},
                          timeout=WORLD_TIMEOUT, path=[HERE],
                          workdir=str(tmp_path / "job"))[0]
    assert got["before"] and got["after_bad"] == []
    args = launch_train.parse_args([
        "--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
        "--batch", "8", "--seq", "16", "--optimizer", optimizer])
    s = launch_train.build(args)
    state, ces = s.state, []
    for i in range(2):
        state, m = s.step(state, s.loader.get(i))
        ces.append(float(m["ce"]))
    np.testing.assert_allclose(got["ce"], ces, rtol=CE_RTOL)
