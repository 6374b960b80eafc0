"""The port's training slice against the JAX package's, on the same
numpy-drawn inputs and the JAX parameters bridged across
(``params_from_numpy``), reduced configs in f32 on the CPU:

* ``loss_fn``: the loss, each metric and every gradient leaf against
  ``jax.value_and_grad(loss_fn)`` (rtol 1e-5, atol 1e-6 of the leaf's
  largest |value|) for a dense, an MoE (with capacity drops), a VLM
  (embedding input, M-RoPE positions) and an audio model; block remat on
  and off give identical grads;
* the train step: a 10-step AdamW trajectory against the JAX package's
  jitted ``make_train_step`` (ce and grad_norm rtol 1e-4 at every step),
  and so ``microbatches=4`` and ``int8_ef`` over 2 pods;
* the runner: the mirrors of ``tests/train/test_train_loop.py``;
* the launcher on the CPU.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import registry as jreg
from repro.optim import AdamWConfig as JAdamW
from repro.train import train_step as jts
from repro_torch import models as tm
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig, ShardedLoader, make_batch
from repro_torch.distributed.fault import FailureInjector, StragglerDetector
from repro_torch.launch import train as launch_train
from repro_torch.models import mlp as tmlp
from repro_torch.optim import AdamWConfig
from repro_torch.train import train_step as tts
from repro_torch.train.loop import RunnerConfig, TrainingRunner
from test_torch_moe import slots_over_capacity

LOSS_RTOL, LOSS_ATOL_OF_MAX = 1e-5, 1e-6
STEP_RTOL = 1e-4


def _configs(arch, moe=None, **kw):
    """The JAX and port reduced configs of ``arch``, with ``kw`` replaced
    and the MoE config's fields ``moe`` replaced."""
    out = []
    for reg in (jreg, treg):
        c = dataclasses.replace(reg.get(arch, reduced=True), **kw)
        if moe:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
        out.append(c)
    return tuple(out)


def _bridge(cfg_j, cfg_t, seed=0):
    pj = jm.init_params(jax.random.PRNGKey(seed), cfg_j)
    return pj, tm.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t,
                                    "cpu")


def _leaf(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", k))]
    return tree


def _close_tree(t_tree, j_tree, rtol=LOSS_RTOL, atol_of_max=LOSS_ATOL_OF_MAX):
    n = 0
    for path, jl in jax.tree_util.tree_flatten_with_path(j_tree)[0]:
        want = np.asarray(jl, np.float32)
        got = _leaf(t_tree, path).detach().float().numpy()
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=atol_of_max * scale,
                                   err_msg=jax.tree_util.keystr(path))
        n += 1
    return n


def _batch(rng, cfg, b, s, masked=True):
    """A loss batch: inputs (ids or embeddings), labels with a few masked
    (-1) positions, and for an M-RoPE model (t, h, w) positions whose
    three streams all differ: t the index, (h, w) the cell of a grid 4
    wide. (No stream is constant: on a constant stream the K bias's
    gradient in that stream's rotary section is zero in exact arithmetic,
    since softmax ignores a shift shared by every key, and both packages'
    f32 values there are rounding noise, 1e-4 of the leaf's largest value
    away from an f64 run of the same loss.)"""
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if masked:
        labels[0, :3] = -1
        labels[-1, -1] = -1
    if cfg.input_mode == "tokens":
        inputs = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    else:
        inputs = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    out = {"inputs": inputs, "labels": labels}
    if cfg.pos_embed == "mrope":
        h, w = np.divmod(np.arange(s), 4)
        pos = np.stack([np.arange(s), h, w], -1).astype(np.int32)
        out["positions"] = np.ascontiguousarray(
            np.broadcast_to(pos, (b, s, 3)))
    return out


def _drops(monkeypatch, cfg):
    """Record, for every MoE layer the port runs, the slots its capacity
    drops, counted from the router independently of the port's dispatch."""
    seen = []
    moe_ffn = tmlp.moe_ffn

    def counted(p, x, moe, compute_dtype=None):
        with torch.no_grad():
            seen.append(slots_over_capacity(p, x, moe))
        return moe_ffn(p, x, moe, compute_dtype)
    monkeypatch.setattr(tmlp, "moe_ffn", counted)
    return seen


LOSS_CASES = {
    "tinyllama-1.1b": {},
    # capacity 1.0 of the mean load: a random router overfills some experts
    "deepseek-moe-16b": {"capacity_factor": 1.0},
    "qwen2-vl-7b": {},
    "musicgen-large": {},
}


@pytest.mark.parametrize("arch", list(LOSS_CASES))
def test_loss_fn_and_grads_match_jax(rng, monkeypatch, arch):
    cj, ct = _configs(arch, moe=LOSS_CASES[arch])
    pj, pt = _bridge(cj, ct)
    nb = _batch(rng, cj, 2, 16)
    drops = _drops(monkeypatch, cj) if cj.moe is not None else None

    (lj, mj), gj = jax.value_and_grad(
        lambda p: jm.loss_fn(p, cj, {k: jnp.asarray(v) for k, v in nb.items()}),
        has_aux=True)(pj)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    leaves = [p.requires_grad_() for p in T.leaves(pt)]
    lt, mt = tm.loss_fn(pt, ct, tb)
    gt = T.unflatten(pt, torch.autograd.grad(lt, leaves))
    mt = {k: v.detach() for k, v in mt.items()}

    np.testing.assert_allclose(float(mt["loss"]), float(lj), rtol=LOSS_RTOL)
    assert set(mt) == set(mj) == {"loss", "ce", "z_loss", "moe_aux",
                                  "accuracy", "tokens"}
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert int(mt["tokens"]) == int((nb["labels"] >= 0).sum())
    n = _close_tree(gt, gj)
    assert n == len(jax.tree_util.tree_leaves(pj))
    if drops is not None:
        assert float(mt["moe_aux"]) > 0 and sum(drops) > 0, drops


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b"])
def test_remat_on_and_off_give_identical_grads(rng, arch):
    grads = {}
    for remat in ("block", "none"):
        _, ct = _configs(arch, remat=remat)
        pt = tm.init_params(ct, torch.Generator().manual_seed(0), "cpu")
        tb = {k: torch.from_numpy(v)
              for k, v in _batch(np.random.default_rng(1), ct, 2, 16).items()}
        leaves = [p.requires_grad_() for p in T.leaves(pt)]
        loss, _ = tm.loss_fn(pt, ct, tb)
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["block"], grads["none"]):
        assert torch.equal(a, b)


def test_forward_unbinds_each_stacked_leaf_once(rng):
    """The layer loops take per-layer views by one ``unbind`` per stacked
    leaf; each view is the stacked leaf indexed at its layer."""
    from repro_torch.models import model as M
    _, ct = _configs("deepseek-moe-16b")
    pt = tm.init_params(ct, torch.Generator().manual_seed(0), "cpu")
    layers = M._unbind_layers(pt["layers"], ct.n_layers)
    assert len(layers) == ct.n_layers
    stacked = list(T.leaves_with_path(pt["layers"]))
    for i, got in enumerate(layers):
        got = list(T.leaves_with_path(got))
        assert [k for k, _ in got] == [k for k, _ in stacked]
        for (_, a), (_, b) in zip(got, stacked):
            assert torch.equal(a, b[i]) and a.data_ptr() == b[i].data_ptr()


# ---- the train step against the JAX package's jitted step ----------------

def _step_pair(tkw, arch="tinyllama-1.1b"):
    cj, ct = _configs(arch)
    common = dict(peak_lr=3e-3, warmup_steps=3, total_steps=10, **tkw)
    tcj = jts.TrainConfig(adamw=JAdamW(), **common)
    tct = tts.TrainConfig(adamw=AdamWConfig(), **common)
    pj, pt = _bridge(cj, ct)
    return (cj, ct, tcj, tct, jts.init_train_state(pj, tcj),
            tts.init_train_state(pt, tct))


def _trajectories(tkw, steps, batch=8, seq=16):
    cj, ct, tcj, tct, sj, st = _step_pair(tkw)
    jstep = jax.jit(jts.make_train_step(cj, tcj))
    tstep = tts.make_train_step(ct, tct)
    dc = DataConfig(seed=3)
    out = []
    for i in range(steps):
        nb = make_batch(ct, dc, i, batch, seq)
        sj, mj = jstep(sj, {k: jnp.asarray(v) for k, v in nb.items()})
        st, mt = tstep(st, {k: torch.from_numpy(v) for k, v in nb.items()})
        out.append((mj, mt))
    return out, sj, st


def _check_step_metrics(pairs):
    for i, (mj, mt) in enumerate(pairs):
        assert set(mt) == set(mj)
        for k in ("ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=STEP_RTOL,
                                       err_msg=f"step {i} {k}")


def test_adamw_trajectory_matches_jax():
    pairs, sj, st = _trajectories({}, 10)
    _check_step_metrics(pairs)
    assert int(st["opt"]["step"]) == int(sj["opt"]["step"]) == 10
    assert float(pairs[-1][1]["ce"]) < float(pairs[0][1]["ce"])


@pytest.mark.parametrize("tkw", [{"microbatches": 4},
                                 {"grad_compression": "int8_ef", "n_pods": 2}],
                         ids=["microbatches4", "int8_ef_2pods"])
def test_train_step_paths_match_jax(tkw):
    pairs, sj, st = _trajectories(tkw, 3)
    _check_step_metrics(pairs)
    if "n_pods" in tkw:       # the residuals' codes: test_torch_optim.py
        for a, b in zip(T.leaves(st["ef"]), jax.tree_util.tree_leaves(sj["ef"])):
            assert tuple(a.shape) == b.shape and a.shape[0] == 2


def test_step_leaves_its_input_state_untouched():
    """Two steps from one state (the second at lr > 0): the state given
    keeps its values, and the new one has no autograd flags."""
    _, ct, _, tct, _, st = _step_pair({})
    before = [x.clone() for x in T.leaves(st)]
    step = tts.make_train_step(ct, tct)
    new = st
    for i in range(2):
        nb = make_batch(ct, DataConfig(seed=3), i, 8, 16)
        new, _ = step(new, {k: torch.from_numpy(v) for k, v in nb.items()})
    for a, b in zip(before, T.leaves(st)):
        assert torch.equal(a, b)
    assert not any(x.requires_grad for x in T.leaves(new))
    assert not any(torch.equal(a, b) for a, b in
                   zip(T.leaves(st["params"]), T.leaves(new["params"])))


# ---- the runner: mirrors of tests/train/test_train_loop.py ----------------

def _setup(**tkw):
    cfg = treg.get("tinyllama-1.1b", reduced=True)
    tcfg = tts.TrainConfig(peak_lr=3e-3, warmup_steps=5, total_steps=60,
                           adamw=AdamWConfig(weight_decay=0.0), **tkw)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = tts.init_train_state(params, tcfg)
    step = tts.make_train_step(cfg, tcfg)
    loader = ShardedLoader(cfg, DataConfig(seed=7), batch=8, seq=16,
                           device="cpu")
    return cfg, state, step, loader


def test_loss_decreases(tmp_path):
    cfg, state, step, loader = _setup()
    runner = TrainingRunner(step, state, loader.get,
                            RunnerConfig(ckpt_dir=str(tmp_path / "ck"),
                                         ckpt_every=20, async_ckpt=False))
    runner.run(40)
    first = np.mean([h["ce"] for h in runner.history[:5]])
    last = np.mean([h["ce"] for h in runner.history[-5:]])
    assert last < first - 0.5, (first, last)
    assert all(isinstance(h["ce"], float) for h in runner.history)


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_restart_reproduces_identical_losses(tmp_path, async_ckpt):
    """Crash at step 12, restart from the step-10 checkpoint: the restarted
    steps' losses equal an uninterrupted run's, from one shared state."""
    cfg, state, step, loader = _setup()
    rc = RunnerConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=5,
                      async_ckpt=async_ckpt)
    clean = TrainingRunner(step, state, loader.get, rc)
    clean.run(20)
    losses_clean = {h["step"]: h["ce"] for h in clean.history}

    rc2 = RunnerConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=5,
                       async_ckpt=async_ckpt)
    faulty = TrainingRunner(step, state, loader.get, rc2,
                            injector=FailureInjector(fail_at_steps=(12,)))
    faulty.run(20)
    assert faulty.restarts == 1
    losses_faulty = {h["step"]: h["ce"] for h in faulty.history}
    assert [h["step"] for h in faulty.history] == \
        list(range(12)) + list(range(11, 20))
    for s in range(20):
        np.testing.assert_allclose(losses_faulty[s], losses_clean[s],
                                   rtol=1e-6)


def test_microbatch_accumulation_matches_full_batch():
    """grad accumulation (4 microbatches) == single big batch."""
    cfg, state, step1, loader = _setup(microbatches=1)
    _, state4, step4, _ = _setup(microbatches=4)
    b = loader.get(0)
    _, m1 = step1(state, b)
    _, m4 = step4(state4, b)
    np.testing.assert_allclose(float(m1["ce"]), float(m4["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m4["grad_norm"]),
                               rtol=1e-3)
    g1, _ = tts.compute_grads(state["params"], cfg, tts.TrainConfig(), b)
    g4, _ = tts.compute_grads(state["params"], cfg,
                              tts.TrainConfig(microbatches=4), b)
    for a, c in zip(T.leaves(g4), T.leaves(g1)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0,
                                   atol=1e-5 * float(c.abs().max()))


def test_straggler_detection():
    det = StragglerDetector(multiplier=3.0, warmup=2)
    for s in range(6):
        assert not det.record(s, 0.1)
    assert det.record(6, 1.0)          # 10x the EMA -> straggler
    assert det.events and det.events[0]["step"] == 6
    assert not det.record(7, 0.1)      # EMA not poisoned by the outlier


# ---- the launcher --------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--multi-pod", "--compress-grads"],
                                   ["--optimizer", "adafactor",
                                    "--microbatches", "2"]],
                         ids=["adamw", "int8_ef", "adafactor_micro"])
def test_launcher_trains_on_the_cpu(tmp_path, capsys, extra):
    runner = launch_train.main(
        ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
         "--steps", "3", "--ckpt-dir", str(tmp_path / "ck"), *extra])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=tinyllama-1.1b-reduced params=")
    assert "devices=1 (cpu)" in out[0]
    assert out[1].startswith("ce first5=") and "stragglers=" in out[1]
    assert len(runner.history) == 3
    assert all(np.isfinite(h["ce"]) for h in runner.history)


def test_launcher_run_again_resumes_its_own_checkpoint(tmp_path, capsys):
    """A second run of one command in one directory resumes after the
    first run's last step: it takes no steps and still prints both
    lines."""
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
            "--steps", "3", "--ckpt-dir", str(tmp_path / "ck")]
    assert len(launch_train.main(argv).history) == 3
    capsys.readouterr()
    assert launch_train.main(argv).history == []
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("ce first5=0.0000 last5=0.0000 ")
    assert "step_s median=none (cpu)" in out[1]


def test_launcher_default_ckpt_dir_is_per_train_state():
    """Runs whose train states differ in shape never share the default
    checkpoint directory."""
    base = ["--arch", "tinyllama-1.1b"]
    variants = [[], ["--reduced"], ["--optimizer", "adafactor"],
                ["--multi-pod", "--compress-grads"],
                ["--arch", "deepseek-moe-16b"]]
    dirs = [launch_train.ckpt_dir(launch_train.parse_args(base + v))
            for v in variants]
    assert len(set(dirs)) == len(dirs)
    assert all(d.startswith(os.path.join("build", "repro_torch_train"))
               for d in dirs)
    same = launch_train.parse_args(base + ["--microbatches", "2", "--seq",
                                           "64"])
    assert launch_train.ckpt_dir(same) == dirs[0]
    given = launch_train.parse_args(base + ["--ckpt-dir", "x"])
    assert launch_train.ckpt_dir(given) == "x"


def test_launcher_multi_pod_runs_two_pods():
    args = launch_train.parse_args(["--arch", "tinyllama-1.1b", "--multi-pod",
                                    "--compress-grads"])
    tcfg = launch_train.train_config(args)
    assert (tcfg.grad_compression, tcfg.n_pods) == ("int8_ef", 2)
    assert args.device == "cuda"


def test_launcher_refuses_the_production_mesh():
    """``--mesh production`` parses; on a job smaller than 16 x 16 ranks
    (this single process) building the mesh raises, naming the shape."""
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
            "--mesh", "production"]
    assert launch_train.parse_args(argv).mesh == "production"
    with pytest.raises(ValueError, match=r"\(16, 16\).*needs 256 ranks"):
        launch_train.main(argv)
    with pytest.raises(ValueError, match=r"\(2, 16, 16\).*needs 512 ranks"):
        launch_train.main(argv + ["--multi-pod"])


def test_launcher_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = launch_train.parse_args(["--arch", "tinyllama-1.1b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.build(args)
