"""Sharded training of the port over CPU meshes of gloo ranks
(``repro_torch.launch.local_ranks``; the rank bodies are in
tests/torch_mesh_ranks.py), against the JAX package's one-device jitted
step and the port's one-device step: the mirror of
tests/distributed/test_multidevice.py.

* the sharded step on ``make_debug_mesh((2, 4))`` (8 ranks; reduced
  tinyllama's 8 / 2 heads, so k/v take the GQA fallback): ce at rtol
  1e-5, ``lm_head/w`` at atol 2e-5 / rtol 1e-4, the state placed by
  ``train_state_pspecs``;
* the compressed step (int8_ef, 2 pods) on (pod 2, data 2, model 2): the
  pods' all-reduce carries int8, the first step equals JAX's, and 40
  steps converge (last 5 < first 5 - 0.3);
* elastic: a checkpoint of 8 ranks restored onto 4, the next step's ce at
  rtol 1e-5; ``reshard_tree`` to another mesh and back, and
  ``replicate_tree``, bit for bit.

The launcher's mesh path is in tests/test_torch_mesh_launch.py.

The parent computes the references and hands the ranks the JAX initial
parameters as ``.npz``. Each world has a limit of its own (300 s).
"""
import os

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import ShardedLoader as JLoader
from repro.models import init_params as j_init
from repro.optim import AdamWConfig as JAdamW
from repro.train import train_step as jts
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.launch import local_ranks
from repro_torch.models import params_from_numpy
from repro_torch.train.train_step import init_train_state, make_train_step
import torch_mesh_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
CE_RTOL = 1e-5                                   # the JAX test's
W_TOL = dict(atol=2e-5, rtol=1e-4)
COMPRESSED_STEPS = 40
WORLD_TIMEOUT = 300


def _job(target: str, world: int, tmp_path, backend=None, **kwargs
         ) -> list:
    return local_ranks.run(f"torch_mesh_ranks:{target}", world, device="cpu",
                           kwargs=kwargs, timeout=WORLD_TIMEOUT, path=[HERE],
                           workdir=str(tmp_path / target), backend=backend)


@pytest.fixture(scope="module")
def jax_params(tmp_path_factory):
    """The JAX initial parameters (seed 0) as an ``.npz`` of leaf paths,
    and bridged into the port."""
    cfg = jreg.get("tinyllama-1.1b", reduced=True)
    pj = j_init(jax.random.PRNGKey(0), cfg)
    flat = {"/".join(str(k.key) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(pj)[0]}
    path = tmp_path_factory.mktemp("params") / "params.npz"
    np.savez(path, **flat)
    return pj, str(path)


def _jax_steps(pj, tcfg, seed: int, n: int):
    """The JAX package's one-device jitted step, ``n`` times: ([ce], the
    first step's ``lm_head/w``)."""
    cfg = jreg.get("tinyllama-1.1b", reduced=True)
    state = jts.init_train_state(pj, tcfg)
    step = jax.jit(jts.make_train_step(cfg, tcfg))
    loader = JLoader(cfg, JDataConfig(seed=seed), batch=R.BATCH, seq=R.SEQ)
    ces, w = [], None
    for i in range(n):
        state, m = step(state, loader.get(i))
        ces.append(float(m["ce"]))
        if i == 0:
            w = np.asarray(state["params"]["lm_head"]["w"])
    return ces, w


def _port_step(pj, tcfg, seed: int):
    """The port's one-device step on the CPU: (ce, ``lm_head/w``)."""
    cfg = treg.get("tinyllama-1.1b", reduced=True)
    params = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    loader = ShardedLoader(cfg, DataConfig(seed=seed), batch=R.BATCH,
                           seq=R.SEQ, device="cpu")
    state, m = make_train_step(cfg, tcfg)(init_train_state(params, tcfg),
                                          loader.get(0))
    return float(m["ce"]), state["params"]["lm_head"]["w"].numpy()


def _jax_tcfg(t):
    return jts.TrainConfig(
        peak_lr=t.peak_lr, warmup_steps=t.warmup_steps,
        total_steps=t.total_steps, grad_compression=t.grad_compression,
        n_pods=t.n_pods, adamw=JAdamW(weight_decay=t.adamw.weight_decay))


def test_sharded_step_and_elastic_reshard(jax_params, tmp_path):
    """(2, 4): the sharded step == JAX's and the port's one-device step;
    its checkpoint restored onto (2, 2) takes the next step as (2, 4)
    does, and as JAX's one device does; live resharding is exact."""
    pj, npz = jax_params
    ckpt_dir = str(tmp_path / "ckpt")
    ranks = _job("debug_mesh_steps", 8, tmp_path, params_npz=npz,
                 out_npz=str(tmp_path / "w8.npz"), ckpt_dir=ckpt_dir)
    r0 = ranks[0]
    assert all(r == r0 for r in ranks), "ranks disagree"
    assert r0["placed"] and r0["placed_after"]
    assert r0["round_trip"] and r0["replicated"]
    jces, jw = _jax_steps(pj, _jax_tcfg(R.PLAIN), 1, 2)
    ce1, w1 = _port_step(pj, R.PLAIN, 1)
    w8 = np.load(tmp_path / "w8.npz")["lm_head"]
    np.testing.assert_allclose(r0["ce"], jces[0], rtol=CE_RTOL)
    np.testing.assert_allclose(r0["ce"], ce1, rtol=CE_RTOL)
    np.testing.assert_allclose(w8, jw, **W_TOL)
    np.testing.assert_allclose(w8, w1, **W_TOL)

    four = _job("elastic_restore", 4, tmp_path, ckpt_dir=ckpt_dir)
    assert all(r == four[0] for r in four)
    assert four[0]["step"] == 0 and four[0]["placed"]
    np.testing.assert_allclose(four[0]["ce"], r0["ce_next"], rtol=CE_RTOL)
    np.testing.assert_allclose(four[0]["ce"], jces[1], rtol=CE_RTOL)


def test_compressed_step_int8_on_the_pod_axis_and_converges(jax_params,
                                                            tmp_path):
    """(pod 2, data 2, model 2), int8_ef over 2 pods: the first step ==
    JAX's one-device compressed step, the pods' sum travels as an int8
    all-reduce over groups of 2, and the loss falls by 0.3 in 40 steps."""
    pj, npz = jax_params
    # the host-staged backend passes CPU tensors to gloo and counts them
    ranks = _job("compressed_steps", 8, tmp_path, backend="hoststaged",
                 params_npz=npz, out_npz=str(tmp_path / "wc.npz"),
                 steps=COMPRESSED_STEPS)
    r0 = ranks[0]
    assert all(r["ce"] == r0["ce"] for r in ranks)
    assert r0["placed"] and r0["placed_after"]
    assert r0["staged"].get("all_reduce int8 x2", [0])[0] > 0, r0["staged"]
    jces, jw = _jax_steps(pj, _jax_tcfg(R.COMPRESSED), 2, 1)
    np.testing.assert_allclose(r0["ce"][0], jces[0], rtol=CE_RTOL)
    np.testing.assert_allclose(np.load(tmp_path / "wc.npz")["lm_head"], jw,
                               **W_TOL)
    losses = r0["ce"]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_placements_round_trip_through_spec_of(tmp_path):
    """``spec_of`` reads back the spec a DTensor was placed by, a dim over
    two axes included (a one-rank-per-position CPU job of 8)."""
    got = _job("spec_round_trip", 8, tmp_path)
    assert all(g == got[0] for g in got)
    assert got[0] == [True] * len(got[0])

