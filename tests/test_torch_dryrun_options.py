"""The dry run's build options (``repro_torch.launch.dryrun``: the
optimizer, gradient compression, microbatches and remat) against the
JAX package's ``launch/dryrun.py``.

* ``build_step``'s train config equals the one JAX's ``build_step``
  builds for the same options (the optimizer's default by arch, ``n_pods``
  from the mesh's ``pod`` axis under compression only), and the state it
  places has, leaf by leaf, the shape, dtype and ``PartitionSpec`` of
  JAX's ``train_state_shapes`` / ``train_state_pspecs``: adamw, adamw8bit,
  adafactor and int8_ef with 2 pods, reduced tinyllama over (data 2,
  model 4) and (pod 2, data 2, model 2);
* ``run_cell`` names its record as JAX's ``run_cell`` does for the same
  options;
* ``build_cell_fn`` with each option traces on a counting mesh, and
  ``remat`` reaches every kind of cell;
* on 4 CPU ranks of the peer-memory group (one job; the rank body is
  ``torch_mesh_ranks.option_steps``): the traced tally of the launcher's
  step with ``microbatches=2``, ``remat="none"`` and ``adafactor`` equals
  rank 0's counted one key by key (the CPU counterpart of
  ``chip_smoke.py`` phase 8g), and a sharded ``microbatches=2`` step from
  the JAX initial parameters equals JAX's jitted ``microbatches=2`` step
  over 2 steps (ce rtol 1e-5, ``lm_head/w`` atol 2e-5 / rtol 1e-4, the
  mesh tests' tolerances); the compressed step's traced tally equals its
  counted one on (pod 2, data 1, model 2);
* ``tree_map`` frees its leaves without the cyclic collector.
"""
import dataclasses
import importlib
import os

import jax
import numpy as np
import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as jreg
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import ShardedLoader as JLoader
from repro.distributed import sharding as jshd
from repro.launch import specs as JSP
from repro.models import init_params as j_init
from repro.optim import AdamWConfig as JAdamW
from repro.train import train_step as jts
from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import countgroup
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, local_ranks, op_analysis
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.train_step import make_train_step
import torch_mesh_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
CE_RTOL = 1e-5                                   # the mesh tests'
W_TOL = dict(atol=2e-5, rtol=1e-4)
MICRO_STEPS = 2
ARCH = "tinyllama-1.1b"
MESHES = {"data2_model4": ((2, 4), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}
OPTIONS = {"adamw": {}, "adamw8bit": {"optimizer": "adamw8bit"},
           "adafactor": {"optimizer": "adafactor"},
           "int8_ef": {"grad_compression": "int8_ef"},
           "adafactor_int8_ef": {"optimizer": "adafactor",
                                 "grad_compression": "int8_ef"}}
# the launcher's flags and the remat of each variant ranks and trace share
VARIANTS = {"microbatches=2": (["--microbatches", "2"], None),
            "remat=none": ([], "none"),
            "adafactor": (["--optimizer", "adafactor"], None)}


class FakeMesh:
    """Shape-only stand-in of a JAX mesh (no devices needed for specs)."""

    def __init__(self, shape: tuple, axes: tuple):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)
        self.size = int(np.prod(shape))


class Built(Exception):
    """Raised by a stand-in to stop JAX's dry run once it has built what a
    test reads."""


@pytest.fixture(scope="module")
def jdry():
    """The JAX package's ``launch/dryrun.py``. Importing it sets
    ``XLA_FLAGS`` to 512 host devices: the backend is started first with
    the flags this process has, and the variable is put back after."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def _jax_tcfg(jdry, jcfg, mesh, kw, monkeypatch):
    """The train config JAX's ``build_step`` builds for ``kw``."""
    got = {}

    def stop(cfg, tcfg):
        got["tcfg"] = tcfg
        raise Built
    monkeypatch.setattr(jdry, "make_train_step", stop)
    with pytest.raises(Built):
        jdry.build_step(jcfg, ShapeCell("train", 16, 8, "train"), mesh,
                        jshd.Rules.for_mesh(mesh), **kw)
    return got["tcfg"]


def _jax_flat(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): x for path, x in flat}


@pytest.mark.parametrize("opt", OPTIONS)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_build_step_places_the_state_as_jax_specs_it(jdry, opt, mesh_name,
                                                     monkeypatch):
    shape, axes = MESHES[mesh_name]
    kw = OPTIONS[opt]
    cfg, jcfg = registry.get(ARCH, reduced=True), jreg.get(ARCH, reduced=True)
    jmesh = FakeMesh(shape, axes)
    jt = _jax_tcfg(jdry, jcfg, jmesh, kw, monkeypatch)
    with countgroup.world(int(np.prod(shape))):
        mesh = make_mesh(shape, axes, devices="cpu")
        t = dryrun.train_config(cfg, mesh, **kw)
        assert (t.optimizer, t.microbatches, t.grad_compression, t.n_pods) \
            == (jt.optimizer, jt.microbatches, jt.grad_compression, jt.n_pods)
        with FakeTensorMode(allow_non_fake_inputs=True):
            _, (state, _) = dryrun.build_step(
                cfg, ShapeCell("train", 16, 8, "train"), mesh,
                shd.Rules.for_mesh(mesh), **kw)
        got = {shd.path_str(p): (tuple(x.shape), str(x.dtype).split(".")[-1],
                                 tuple(shd.spec_of(x)))
               for p, x in T.leaves_with_path(state)}
    shapes = JSP.train_state_shapes(jcfg, jt)
    specs = JSP.train_state_pspecs(jcfg, jmesh, jshd.Rules.for_mesh(jmesh),
                                   shapes)
    jspec = _jax_flat(specs)
    want = {k: (tuple(x.shape), np.dtype(x.dtype).name,
                tuple(jspec[k]) + (None,) * (len(x.shape) - len(jspec[k])))
            for k, x in _jax_flat(shapes).items()}
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad
    if "grad_compression" in kw:
        assert jt.n_pods == dict(zip(axes, shape)).get("pod", 1)
        assert any(k.startswith("ef/") for k in got)


@pytest.mark.parametrize("arch", ["llama3-405b", "qwen2.5-3b"])
def test_the_default_optimizer_is_jax_s(jdry, arch, monkeypatch):
    """8-bit AdamW for llama3-405b, AdamW for the others; no compression:
    one pod whatever the mesh."""
    jmesh = FakeMesh((2, 2, 2), ("pod", "data", "model"))
    jt = _jax_tcfg(jdry, jreg.get(arch, reduced=True), jmesh, {}, monkeypatch)
    with countgroup.world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices="cpu")
        t = dryrun.train_config(registry.get(arch, reduced=True), mesh)
    assert (t.optimizer, t.n_pods) == (jt.optimizer, jt.n_pods) \
        == ("adamw8bit" if arch == "llama3-405b" else "adamw", 1)


@pytest.mark.parametrize("build_kw", [
    {}, {"microbatches": 4}, {"remat": "none"}, {"optimizer": "adafactor"},
    {"grad_compression": "int8_ef", "optimizer": "adamw8bit"},
    {"microbatches": 2, "remat": "block", "optimizer": "adamw",
     "grad_compression": "int8_ef"}], ids=str)
def test_run_cell_names_its_record_as_jax_does(jdry, build_kw, tmp_path,
                                               monkeypatch):
    """JAX's ``run_cell`` with its mesh and ``build_cell_fn`` stood in for (it
    writes an error record under its tag) against the port's file name."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jdry, "make_production_mesh", lambda multi_pod: (
        FakeMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
        else FakeMesh((16, 16), ("data", "model"))))

    def stop(*a, **kw):
        raise Built
    monkeypatch.setattr(jdry, "build_cell_fn", stop)
    monkeypatch.setattr(dryrun, "trace_cell", stop)
    for mk in ("single", "multi"):
        jdry.run_cell(ARCH, "train_4k", mk, str(jdir), **build_kw)
        rec = dryrun.run_cell(ARCH, "train_4k", mk, str(tdir), **build_kw)
        assert rec["status"] == "error" and "Built" in rec["error"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == sorted(
        dryrun.cell_tag(ARCH, "train_4k", mk, **build_kw) + ".json"
        for mk in ("single", "multi"))


@pytest.mark.parametrize("kw", [
    {"microbatches": 2}, {"remat": "none"}, {"optimizer": "adafactor"},
    {"optimizer": "adamw8bit"}], ids=str)
def test_build_cell_fn_traces_each_option_on_a_counting_mesh(kw):
    cfg = registry.get(ARCH, reduced=True)
    with countgroup.world(8):
        mesh = make_mesh((2, 4), ("data", "model"), devices="cpu")
        ops = dryrun.trace_cell(cfg, ShapeCell("train", 16, 8, "train"), mesh,
                                shd.Rules.for_mesh(mesh), **kw)
    assert ops["dot_flops"] > 0 and ops["temp_bytes"] > 0 and ops["staged"]


def test_compressed_trace_counts_the_pods_int8_all_reduce():
    """int8_ef on (pod 2, data 1, model 2), under the hints: the hints'
    ``pod`` axis is dropped inside each pod's step, and the pods' sum is an
    int8 all-reduce over groups of 2."""
    cfg = registry.get(ARCH, reduced=True)
    with countgroup.world(4):
        mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), devices="cpu")
        ops = dryrun.trace_cell(cfg, ShapeCell("train", 16, 8, "train"), mesh,
                                shd.Rules.for_mesh(mesh),
                                grad_compression="int8_ef")
    n, nbytes = ops["staged"]["all_reduce int8 x2"]
    assert n > 0 and nbytes > 0


@pytest.mark.parametrize("kind,seq", [("train", 16), ("prefill", 16),
                                      ("decode", 32)])
def test_remat_reaches_every_kind_of_cell(kind, seq, monkeypatch):
    cfg = registry.get(ARCH, reduced=True)
    seen = []
    orig = dryrun._with_hints

    def spy(fn, specs):
        seen.append(fn)
        return orig(fn, specs)
    monkeypatch.setattr(dryrun, "_with_hints", spy)
    with countgroup.world(4):
        mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            dryrun.build_cell_fn(cfg, ShapeCell(kind, seq, 8, kind), mesh,
                                 shd.Rules.for_mesh(mesh), remat="none")
    cells = [c.cell_contents for fn in seen for c in (fn.__closure__ or ())
             if dataclasses.is_dataclass(c.cell_contents)
             and hasattr(c.cell_contents, "remat")]
    assert cells and all(c.remat == "none" for c in cells)


def test_remat_none_holds_more_and_recomputes_nothing():
    """Without remat every block's activations stay live until its
    backward (more temporaries) and the backward recomputes no forward
    (fewer dot FLOPs)."""
    cfg = dataclasses.replace(registry.get(ARCH, reduced=True), n_layers=4)
    got = {}
    for remat in ("block", "none"):
        with countgroup.world(4):
            mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
            got[remat] = dryrun.trace_cell(
                cfg, ShapeCell("train", 64, 8, "train"), mesh,
                shd.Rules.for_mesh(mesh), remat=remat)
    assert got["none"]["temp_bytes"] > 2 * got["block"]["temp_bytes"]
    assert got["none"]["dot_flops"] < got["block"]["dot_flops"]
    assert got["none"]["argument_bytes"] == got["block"]["argument_bytes"]


@pytest.fixture(scope="module")
def option_job(tmp_path_factory):
    """The JAX initial parameters (seed 0) and the ranks' results of
    ``option_steps``, one job of 4 CPU ranks on the peer-memory group."""
    tmp = tmp_path_factory.mktemp("options")
    pj = j_init(jax.random.PRNGKey(0), jreg.get(ARCH, reduced=True))
    flat = {"/".join(str(k.key) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(pj)[0]}
    np.savez(tmp / "params.npz", **flat)
    ranks = local_ranks.run(
        "torch_mesh_ranks:option_steps", 4, device="cpu", timeout=300,
        path=[HERE], workdir=str(tmp / "job"), backend="peermem",
        kwargs=dict(params_npz=str(tmp / "params.npz"),
                    out_npz=str(tmp / "w.npz"), steps=MICRO_STEPS,
                    variants={k: list(v) for k, v in VARIANTS.items()}))
    return pj, ranks, np.load(tmp / "w.npz")["lm_head"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_traced_tally_equals_the_counted_tally_of_rank_0(option_job,
                                                         variant):
    """The launcher's step with the option, traced on fake tensors as rank
    0 of a counting world of 4 (the dry run's train config and
    placements), against rank 0's tally of the same step."""
    _, ranks, _ = option_job
    flags, remat = VARIANTS[variant]
    kw = {"microbatches": 2} if "--microbatches" in flags else \
        {"optimizer": "adafactor"} if "--optimizer" in flags else {}
    cfg = registry.get(ARCH, reduced=True)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    with countgroup.world(4):
        mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
        tcfg = dryrun.train_config(cfg, mesh, **kw)
        assert [tcfg.optimizer, tcfg.microbatches] == ranks[0][variant]["tcfg"]
        with FakeTensorMode(allow_non_fake_inputs=True):
            state, batch = dryrun.train_args(
                cfg, tcfg, ShapeCell("step", R.SEQ, R.BATCH, "train"), mesh,
                shd.Rules.for_mesh(mesh))
        _, ops = op_analysis.analyze(make_train_step(cfg, tcfg), state,
                                     batch)
    row = ranks[0][variant]
    assert row["remat"] == cfg.remat
    assert ops["staged"] == row["counted"]
    assert all(r[variant]["ce"] == row["ce"] for r in ranks)


def test_traced_compressed_tally_equals_the_counted_one(option_job):
    """int8_ef through the dry run's options (``n_pods`` from the mesh's
    ``pod`` axis) on (pod 2, data 1, model 2), traced, against rank 0's
    tally of ``compressed_steps``' first step there: key by key, the
    pods' int8 all-reduce among them."""
    _, ranks, _ = option_job
    cfg = registry.get(ARCH, reduced=True)
    shape, axes = (2, 1, 2), ("pod", "data", "model")
    with countgroup.world(4):
        mesh = make_mesh(shape, axes, devices="cpu")
        tcfg = dryrun.train_config(cfg, mesh, grad_compression="int8_ef")
        assert tcfg.n_pods == 2
        with FakeTensorMode(allow_non_fake_inputs=True):
            state, batch = dryrun.train_args(
                cfg, tcfg, ShapeCell("step", R.SEQ, R.BATCH, "train"), mesh,
                shd.Rules.for_mesh(mesh))
        _, ops = op_analysis.analyze(make_train_step(cfg, tcfg), state,
                                     batch)
    assert ops["staged"] == ranks[0]["compressed"]
    assert ops["staged"]["all_reduce int8 x2"][0] > 0


def test_microbatched_tally_gathers_the_batch_rows(option_job):
    """Slicing the batch, split over ``data``, into 2 microbatches of JAX's
    row order gathers each microbatch's ids and labels (int32) on every
    rank; the plain step gathers none."""
    _, ranks, _ = option_job
    counted = ranks[0]["counted"][0]
    assert counted["all_gather int32 x2"][0] == 2 * 2
    assert not any("int32" in k for k in ranks[0]["adafactor"]["counted"])


def test_sharded_microbatched_steps_equal_jax(option_job):
    pj, ranks, w = option_job
    r0 = ranks[0]
    assert r0["backend"] == "peermem" and r0["placed"]
    assert all(r["ce"] == r0["ce"] for r in ranks), "ranks disagree"
    t = dataclasses.replace(R.PLAIN, microbatches=2)
    jcfg = jreg.get(ARCH, reduced=True)
    tcfg = jts.TrainConfig(peak_lr=t.peak_lr, warmup_steps=t.warmup_steps,
                           total_steps=t.total_steps, microbatches=2,
                           adamw=JAdamW(weight_decay=t.adamw.weight_decay))
    state = jts.init_train_state(pj, tcfg)
    step = jax.jit(jts.make_train_step(jcfg, tcfg))
    loader = JLoader(jcfg, JDataConfig(seed=1), batch=R.BATCH, seq=R.SEQ)
    ces = []
    for i in range(MICRO_STEPS):
        state, m = step(state, loader.get(i))
        ces.append(float(m["ce"]))
    np.testing.assert_allclose(r0["ce"], ces, rtol=CE_RTOL)
    np.testing.assert_allclose(w, np.asarray(state["params"]["lm_head"]["w"]),
                               **W_TOL)


def test_tree_map_frees_its_leaves_without_the_cyclic_collector():
    """The dry run counts a tensor as freed when its last reference goes;
    the real step must free it then too. ``tree.unflatten`` once built its
    result with a closure that called itself, a reference cycle that kept
    every ``tree_map``'s leaves (an old gradient sum, say) alive until the
    cyclic collector ran, which put a microbatched sharded step's peak on
    the card above the dry run's prediction."""
    import gc
    import weakref

    import torch
    was = gc.isenabled()
    gc.disable()
    try:
        tree = {"a": torch.ones(3), "b": [torch.ones(2), (torch.ones(4),)]}
        out = T.tree_map(lambda t: t * 2, tree)
        refs = [weakref.ref(x) for x in T.leaves(out)]
        del out
        assert all(r() is None for r in refs)
    finally:
        if was:
            gc.enable()
