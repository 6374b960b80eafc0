"""The port's examples (``repro_torch.examples``) against the JAX package's
``examples/``, on the CPU.

* ``multiport_memory_demo`` prints the JAX script's lines letter for
  letter, and its waveform, service orders and read lanes equal JAX's
  ``simulate_waveform``, ``build_schedule`` and ``step`` exactly;
* ``serve_multiport``, from the JAX package's seed-0 parameters carried
  across, gives the JAX ``MultiPortEngine``'s greedy tokens, macro-cycles,
  pool traversals, steady traversals per decode step and first 6 cycles'
  port schedule at the script's settings, in the pallas, reference and
  single-port modes (1.00 traversals a steady decode step fused, 2.00
  single-port);
* ``elastic_restart`` recovers with drift < 1e-5 at the script's size;
* ``quickstart`` and ``train_100m`` (JAX's ``config_100m``, shapes and
  dtypes leaf by leaf) take 2 steps with a finite ce;
* every example refuses a card where there is none.
"""
import contextlib
import io
import math
import runpy
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import registry as jreg
from repro.models import init_params as j_init
from repro.serve.engine import MultiPortEngine as JEngine
from repro_torch.configs import registry
from repro_torch.examples import (elastic_restart, multiport_memory_demo,
                                  quickstart, serve_multiport, train_100m)
from repro_torch import tree as T
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as SP
from repro_torch.models import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
MODES = {"pallas": [], "reference": ["--kernel-mode", "reference"],
         "single-port": ["--single-port"]}


def _jax_example(name: str, argv=()) -> str:
    """The JAX package's ``examples/<name>.py`` run as a script: its
    standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        saved = sys.argv
        sys.argv = [name, *argv]
        try:
            runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
        finally:
            sys.argv = saved
    return out.getvalue()


def test_demo_prints_the_jax_lines():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        multiport_memory_demo.main(["--device", "cpu"])
    assert out.getvalue() == _jax_example("multiport_memory_demo")


def test_demo_waveform_slots_and_reads_equal_jax():
    got = multiport_memory_demo.main(["--device", "cpu"])
    jconfigs = [jcore.PortConfig(c.enabled, c.roles, c.priority)
                for c in multiport_memory_demo.CONFIGS]
    want = jcore.simulate_waveform(jconfigs, resolution=12)
    for sig in ("clk", "clkp", "back", "clk2", "selected_port"):
        np.testing.assert_array_equal(getattr(got["waveform"], sig),
                                      getattr(want, sig))
    spec = jcore.MemorySpec(num_words=32, word_width=4, num_banks=4)
    storage = spec.init_storage()
    rng = np.random.default_rng(0)
    for cyc, cfg in enumerate(jconfigs):
        assert got["slots"][cyc] == tuple(jcore.build_schedule(cfg).slots)
        reqs = []
        for p in range(4):
            if not cfg.enabled[p]:
                reqs.append(jcore.empty_request(4, 4))
            elif cfg.roles[p] == jcore.WRITE:
                reqs.append(jcore.write_request(
                    jnp.asarray(rng.integers(0, 32, 4), jnp.int32),
                    jnp.full((4, 4), float(10 * (p + 1)))))
            else:
                reqs.append(jcore.read_request(
                    jnp.asarray(rng.integers(0, 32, 4), jnp.int32), 4))
        storage, reads = jcore.step(spec, cfg, storage, reqs)
        want_lanes = {p: np.asarray(reads[p])[0].tolist() for p in range(4)
                      if cfg.enabled[p] and cfg.roles[p] == jcore.READ}
        assert got["reads"][cyc] == want_lanes


@pytest.fixture(scope="module")
def jax_params():
    cfg = jreg.get("tinyllama-1.1b", reduced=True)
    return cfg, j_init(jax.random.PRNGKey(0), cfg)


def _jax_serve(cfg, params, argv) -> JEngine:
    """The JAX script's engine and requests (its defaults)."""
    eng = JEngine(params, cfg, slots=4, max_len=64, prefill_bucket=8,
                  kernel_mode=("reference" if "reference" in argv
                               else "pallas"),
                  single_port="--single-port" in argv)
    rng = np.random.default_rng(0)
    for _ in range(8):
        eng.submit(list(rng.integers(0, cfg.vocab, int(rng.integers(3, 8)))),
                   max_new=8)
    while eng.pending_work():
        eng.step()
    return eng


def _summary(eng) -> dict:
    return {"tokens": {r.rid: [int(t) for t in r.generated]
                       for r in eng.finished},
            "cycles": eng.cycles, "pool_traversals": eng.pool_traversals,
            "steady": (eng.steady_decode_traversals,
                       eng.steady_decode_steps),
            "port_log": [tuple(c) for c in eng.port_log[:6]]}


@pytest.mark.parametrize("mode", MODES)
def test_serve_multiport_equals_the_jax_engine(jax_params, mode, capsys):
    cfg, pj = jax_params
    params = params_from_numpy(jax.tree.map(np.asarray, pj),
                               registry.get("tinyllama-1.1b", reduced=True),
                               "cpu")
    got = serve_multiport.main(["--device", "cpu", *MODES[mode]],
                               params=params)
    want = _jax_serve(cfg, pj, MODES[mode])
    assert _summary(got) == _summary(want)
    steady, steps = got.steady_decode_traversals, got.steady_decode_steps
    assert steps > 0
    assert steady / steps == (2.0 if mode != "pallas" else 1.0)
    printed = capsys.readouterr().out
    assert f"{steady / steps:.2f} per steady decode step" in printed
    assert "kernel launches: " in printed


def test_elastic_restart_recovers_exactly(tmp_path):
    got = elastic_restart.main(["--device", "cpu",
                                "--work-dir", str(tmp_path)])
    assert got["restarts"] == 2
    assert got["drift"] < elastic_restart.DRIFT_LIMIT


def test_quickstart_takes_two_steps():
    hist = quickstart.main(["--device", "cpu", "--steps", "2"])
    assert len(hist) == 2 and all(math.isfinite(h["ce"]) for h in hist)


def test_config_100m_is_jax_s():
    """The port's ``config_100m`` builds JAX's parameter tree: every leaf's
    shape and dtype (the JAX script's ``config_100m``, run from its file)."""
    jcfg = runpy.run_path(str(EXAMPLES / "train_100m.py"))["config_100m"]()
    want = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jcfg))
    got = SP.params_shapes(train_100m.config_100m())
    flat = {"/".join(str(k.key) for k in path): (tuple(x.shape),
                                                 np.dtype(x.dtype).name)
            for path, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    mine = {shd.path_str(p): (tuple(x.shape), str(x.dtype).split(".")[-1])
            for p, x in T.leaves_with_path(got)}
    assert mine == flat


def test_train_100m_takes_two_steps(tmp_path):
    ckpt = tmp_path / "ckpt"
    try:
        runner = train_100m.main(["--device", "cpu", "--steps", "2",
                                  "--batch", "1", "--seq", "64",
                                  "--ckpt", str(ckpt)])
        assert len(runner.history) == 2
        assert all(math.isfinite(h["ce"]) for h in runner.history)
        assert (ckpt / "hb").is_dir()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)      # 1.4 GB a checkpoint


@pytest.mark.parametrize("example", [multiport_memory_demo, serve_multiport,
                                     quickstart, elastic_restart, train_100m])
def test_examples_refuse_a_missing_card(example):
    """Without ``--device`` each example runs on the card, and raises
    where there is none (it never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
