"""The peer-memory process group (``distributed/peermem.py``) on CPU ranks,
whose slots are shared-memory files: the same collective code runs on the
card, where the slots are mapped through CUDA IPC.

* ``hoststaged.probe``'s 10 collectives on 3 ranks == their local
  reductions;
* reduced tinyllama's sharded steps on (data 2, model 2) == JAX's
  one-device steps (ce rtol 1e-5, ``lm_head/w`` atol 2e-5 / rtol 1e-4: the
  JAX multidevice test's tolerances; grad_norm rtol 2e-4), every
  replicated leaf bit-identical on every rank, and the collectives they
  count == the host-staged backend's key by key;
* the compressed int8_ef steps on (pod 2, data 1, model 2) == the same
  steps over the host-staged backend (groups of 2: a sum of two is the
  same bits in either order) and JAX's;
* collectives of 3.5 slots (a group with a small slot) == gloo's, the
  all-reduce in 4 rounds and bit-identical on every rank;
* ``choose_backend`` over a table of layouts.

Rank bodies are in tests/torch_mesh_ranks.py; each world has a limit of
its own (300 s).
"""
import os

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import ShardedLoader as JLoader
from repro.train import train_step as jts
from repro_torch.distributed import peermem
from repro_torch.launch import local_ranks
import test_torch_multidevice as MD
import torch_mesh_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
CE_RTOL, W_TOL = MD.CE_RTOL, MD.W_TOL
# tests/test_torch_mesh_families.py's grad_norm tolerance
GRAD_NORM_RTOL = 2e-4
WORLD_TIMEOUT = 300
# PLAIN's warmup is 2 steps and COMPRESSED's 3: the first step's learning
# rate is 0, so these take steps that move the weights
STEPS, COMPRESSED_STEPS = 3, 2
jax_params = MD.jax_params


def _jax_steps(pj, tcfg, seed: int, n: int):
    """``n`` of the JAX package's one-device jitted steps: (each step's ce,
    each step's grad_norm, ``lm_head/w`` after the last)."""
    cfg = jreg.get("tinyllama-1.1b", reduced=True)
    tc = MD._jax_tcfg(tcfg)
    state = jts.init_train_state(pj, tc)
    step = jax.jit(jts.make_train_step(cfg, tc))
    loader = JLoader(cfg, JDataConfig(seed=seed), batch=R.BATCH, seq=R.SEQ)
    ces, norms = [], []
    for i in range(n):
        state, m = step(state, loader.get(i))
        ces.append(float(m["ce"]))
        norms.append(float(m["grad_norm"]))
    return ces, norms, np.asarray(state["params"]["lm_head"]["w"])


def _job(target: str, world: int, tmp_path, backend="peermem", **kwargs):
    return local_ranks.run(f"torch_mesh_ranks:{target}", world, device="cpu",
                           kwargs=kwargs, timeout=WORLD_TIMEOUT, path=[HERE],
                           workdir=str(tmp_path / f"{target}-{backend}"),
                           backend=backend)


def test_probe_on_three_cpu_ranks(tmp_path):
    """Every collective DTensor issues, plain and functional, == its local
    reduction on 3 ranks of the peer-memory group."""
    got = local_ranks.run("repro_torch.distributed.hoststaged:probe", 3,
                          device="cpu", kwargs={"device": "cpu"},
                          backend="peermem", timeout=WORLD_TIMEOUT,
                          workdir=str(tmp_path / "probe"))
    assert len(got[0]) == 10 and all(all(r.values()) for r in got), got


def test_sharded_step_matches_jax_and_counts_as_host_staging(jax_params,
                                                             tmp_path):
    """(data 2, model 2) over peer memory, 3 steps (the first at learning
    rate 0, so the later ones hold the backward's collectives): each
    step's ce and grad_norm and the last ``lm_head/w`` == JAX's one-device
    steps; replicated leaves bit-identical on every rank; each step's
    collectives == the host-staged backend's, key by key."""
    pj, npz = jax_params
    runs = {b: _job("mesh_step", 4, tmp_path, backend=b, params_npz=npz,
                    out_npz=str(tmp_path / f"w-{b}.npz"), shape=[2, 2],
                    steps=STEPS)
            for b in ("peermem", "hoststaged")}
    ranks = runs["peermem"]
    r0 = ranks[0]
    assert [r["backend"] for r in ranks] == ["peermem"] * 4
    assert all(r["replicated"] == r0["replicated"] and r["ce"] == r0["ce"]
               for r in ranks)
    jces, jnorms, jw = _jax_steps(pj, R.PLAIN, 1, STEPS)
    np.testing.assert_allclose(r0["ce"], jces, rtol=CE_RTOL)
    np.testing.assert_allclose(r0["grad_norm"], jnorms, rtol=GRAD_NORM_RTOL)
    np.testing.assert_allclose(np.load(tmp_path / "w-peermem.npz")["lm_head"],
                               jw, **W_TOL)
    staged = runs["hoststaged"][0]["staged"]
    assert r0["staged"] == staged and all(staged), (r0["staged"], staged)


def test_compressed_step_equals_host_staging(jax_params, tmp_path):
    """int8_ef over 2 pods on (pod 2, data 1, model 2), 2 steps (the
    second at a learning rate above 0): the peer-memory steps == the
    host-staged ones (ce, grad_norm and the last ``lm_head/w`` to the bit)
    and JAX's one-device steps, with the pods' int8 all-reduce counted
    alike."""
    pj, npz = jax_params
    got = {}
    for b in ("peermem", "hoststaged"):
        ranks = _job("compressed_steps", 4, tmp_path, backend=b,
                     params_npz=npz, out_npz=str(tmp_path / f"c-{b}.npz"),
                     steps=COMPRESSED_STEPS, shape=[2, 1, 2],
                     head_after=COMPRESSED_STEPS - 1)
        assert all(r["ce"] == ranks[0]["ce"] for r in ranks)
        got[b] = (ranks[0], np.load(tmp_path / f"c-{b}.npz")["lm_head"])
    (pm, wp), (hs, wh) = got["peermem"], got["hoststaged"]
    assert pm["ce"] == hs["ce"] and pm["grad_norm"] == hs["grad_norm"]
    assert np.array_equal(wp, wh)
    assert pm["staged"] == hs["staged"]
    assert pm["staged"].get("all_reduce int8 x2", [0])[0] > 0, pm["staged"]
    jces, jnorms, jw = _jax_steps(pj, R.COMPRESSED, 2, COMPRESSED_STEPS)
    np.testing.assert_allclose(pm["ce"], jces, rtol=CE_RTOL)
    np.testing.assert_allclose(pm["grad_norm"], jnorms, rtol=GRAD_NORM_RTOL)
    np.testing.assert_allclose(wp, jw, **W_TOL)


def test_operands_larger_than_the_slot_go_in_chunks(tmp_path):
    """A 64 KiB slot: all-reduce (f32 in rank order, ints, int8 wrapping,
    max, avg), all-gather, reduce-scatter, uneven all-to-all, broadcast and
    scatter of 3.5 slots == gloo's; the all-reduce takes 4 rounds and is
    bit-identical on every rank; PREMUL_SUM, which gloo lacks, raises."""
    ranks = _job("chunked_collectives", 3, tmp_path, backend="gloo",
                 slot_bytes=64 * 1024)
    for r in ranks:
        assert all(r["ok"].values()), r["ok"]
    assert all(r["digest"] == ranks[0]["digest"] for r in ranks)


@pytest.mark.parametrize("layout,want", [
    (("cpu", 8, 0, 8), "gloo"),
    (("cpu", 4, 2, 8), "gloo"),
    (("cuda", 4, 1, 4), "peermem"),
    (("cuda", 8, 4, 8), "peermem"),
    (("cuda", 1, 1, 1), "nccl"),
    (("cuda", 4, 4, 4), "nccl"),
    (("cuda", 8, 8, 256), "nccl"),
    (("cuda", 2, 8, 2), "nccl"),
])
def test_choose_backend(layout, want):
    assert peermem.choose_backend(*layout) == want


@pytest.mark.parametrize("layout,match", [
    (("cuda", 8, 4, 16), "spans one host"),
    (("cuda", 4, 0, 4), "no card"),
    (("xpu", 4, 4, 4), "no backend"),
])
def test_choose_backend_refuses(layout, match):
    with pytest.raises(ValueError, match=match):
        peermem.choose_backend(*layout)
