"""Sharded training of the MoE, VLM and audio families over CPU meshes of
gloo ranks (``repro_torch.launch.local_ranks``; the rank bodies are in
tests/torch_mesh_ranks.py), against the JAX package's one-device jitted
step, with tests/distributed/test_multidevice.py's tolerances (ce rtol
1e-5, ``lm_head/w`` atol 2e-5 / rtol 1e-4; grad_norm rtol 2e-4):

* reduced deepseek-moe-16b, qwen2-vl-7b and musicgen-large over (data 2,
  model 2), batch 8 x 16, from the JAX initial parameters, for 3 steps:
  the first step's learning rate is 0 (a warmup of 2), so the later
  steps' ce and the last ``lm_head/w`` are what hold the backward;
* ``mlp.moe_ffn`` on DTensors against the plain call at 1e-6 of each
  value's largest |value| (output, aux loss, every gradient), with and
  without capacity drops, experts split 2 and 4 ways.

The attention-free and hybrid families are in
tests/test_torch_mesh_recurrent.py. Every case of a file runs in one
world of 4 ranks (one start-up), which has a limit of its own (300 s).
"""
import dataclasses
import os
from unittest import mock

import jax
import numpy as np
import pytest

from repro import models as jm
from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import ShardedLoader as JLoader
from repro.optim import AdamWConfig as JAdamW
from repro.train import train_step as jts
from repro_torch.launch import local_ranks
import torch_mesh_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
CE_RTOL = 1e-5                                   # the JAX test's
W_TOL = dict(atol=2e-5, rtol=1e-4)
# grad_norm: reduced rwkv6-3b's gradient is ill-conditioned (nudging its
# parameters at f32's rounding moves its bonus and r/k projections'
# gradients far more): its (data 2, model 2) grad_norm lies 7.8e-5 from
# JAX's where each ce and the last lm_head/w agree as above
GRAD_NORM_RTOL = 2e-4
# steps of each case: step 0 has lr 0, steps 1 and 2 move every parameter
STEPS = 3
MOE_TOL = 1e-6
WORLD, WORLD_TIMEOUT = 4, 300

# (name, arch, edit of the reduced config, mesh (data, model))
CASES = [("deepseek-moe-16b", "deepseek-moe-16b", None, (2, 2)),
         ("qwen2-vl-7b", "qwen2-vl-7b", None, (2, 2)),
         ("musicgen-large", "musicgen-large", None, (2, 2))]
# (mesh (data, model), capacity factor): 2.0 drops no slot, 0.5 drops many
MOE_CASES = [((2, 2), 2.0), ((2, 2), 0.5), ((1, 4), 0.5)]


def _jax_cfg(arch, edit):
    cfg = jreg.get(arch, reduced=True)
    for field, value in (edit or {}).items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, field), **value)
        cfg = dataclasses.replace(cfg, **{field: value})
    return cfg


def _jax_steps(cfg, pj):
    """``STEPS`` of the JAX package's one-device jitted step: (each step's
    ce, each step's grad_norm, ``lm_head/w`` after the last)."""
    t = R.PLAIN
    tcfg = jts.TrainConfig(peak_lr=t.peak_lr, warmup_steps=t.warmup_steps,
                           total_steps=t.total_steps,
                           adamw=JAdamW(weight_decay=t.adamw.weight_decay))
    step = jax.jit(jts.make_train_step(cfg, tcfg))
    loader = JLoader(cfg, JDataConfig(seed=1), batch=R.BATCH, seq=R.SEQ)
    # the stub frontend's table cache is keyed without the data seed: an
    # earlier test in this process may have cached another seed's table,
    # where the ranks (fresh processes) draw seed 1's
    with mock.patch.dict(jpipe._FRONTEND_CACHE, clear=True):
        batches = [loader.get(i) for i in range(STEPS)]
    state, ces, norms = jts.init_train_state(pj, tcfg), [], []
    for batch in batches:
        state, m = step(state, batch)
        ces.append(float(m["ce"]))
        norms.append(float(m["grad_norm"]))
    return ces, norms, np.asarray(state["params"]["lm_head"]["w"])


def run_world(tmp, cases, checks=()) -> tuple:
    """Each case's sharded steps (and each of ``checks``: dicts of a rank
    body's ``name``, ``fn`` and keyword arguments) in one world of 4
    ranks, and the JAX one-device steps of each case: (every rank's
    results, rank 0's last ``lm_head/w`` by case, JAX's (ces, grad_norms,
    ``lm_head/w``) by case)."""
    specs, jax_out = [], {}
    for name, arch, edit, shape in cases:
        cfg = _jax_cfg(arch, edit)
        pj = jm.init_params(jax.random.PRNGKey(0), cfg)
        path = tmp / f"params{len(specs)}.npz"
        np.savez(path, **{"/".join(str(k.key) for k in kp): np.asarray(x)
                          for kp, x in jax.tree_util.tree_flatten_with_path(
                              pj)[0]})
        specs.append({"name": name, "arch": arch, "edit": edit,
                      "shape": list(shape), "params": str(path)})
        jax_out[name] = _jax_steps(cfg, pj)
    ranks = local_ranks.run(
        "torch_mesh_ranks:family_steps", WORLD, device="cpu",
        kwargs={"cases": specs, "out_npz": str(tmp / "heads.npz"),
                "steps": STEPS, "checks": list(checks)},
        timeout=WORLD_TIMEOUT, path=[HERE], workdir=str(tmp / "steps"))
    with np.load(tmp / "heads.npz") as f:
        heads = {k: f[k] for k in f.files}
    return ranks, heads, jax_out


def check_within(world, name, tol) -> None:
    """Every rank's ``name`` check: each relative difference within
    ``tol``."""
    for r in world[0]:
        bad = {k: v for k, v in r[name].items() if not v <= tol}
        assert not bad, bad


def check_case(world, name) -> None:
    """The port's sharded steps == the JAX package's one-device jitted
    steps (each step's ce and grad_norm, the last ``lm_head/w``); every
    rank agrees; the state stays placed by ``train_state_pspecs``."""
    ranks, heads, jax_out = world
    got = ranks[0][name]
    assert all(r[name] == got for r in ranks), "ranks disagree"
    assert got["placed"]
    ce, norm, w = jax_out[name]
    np.testing.assert_allclose(got["ce"], ce, rtol=CE_RTOL)
    np.testing.assert_allclose(got["grad_norm"], norm, rtol=GRAD_NORM_RTOL)
    np.testing.assert_allclose(heads[name], w, **W_TOL)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("families"), CASES, [
        {"name": f"moe {i}", "fn": "moe_ffn_on_mesh", "shape": list(shape),
         "seed": 3, "capacity_factor": cf}
        for i, (shape, cf) in enumerate(MOE_CASES)])


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_step_matches_jax_one_device(world, name):
    check_case(world, name)


@pytest.mark.parametrize("i", range(len(MOE_CASES)),
                         ids=[f"{s[0]}x{s[1]}-cf{cf}" for s, cf in MOE_CASES])
def test_moe_ffn_on_dtensors_matches_the_plain_call(world, i):
    """Dispatch on each rank's rows, products on each rank's experts, the
    combine after gathering the expert outputs: output, aux loss and every
    gradient within 1e-6 of the plain call's (relative to each value's
    largest |value|), on every rank."""
    assert set(world[0][0][f"moe {i}"]) >= {
        "out", "aux", "x", "router/w", "w_gate", "w_up", "w_down",
        "shared/w_down/w"}
    check_within(world, f"moe {i}", MOE_TOL)
