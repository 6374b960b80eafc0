"""The reference against the port's engine at small sizes on the CPU: the
served tokens of every cell are the float32 reference's first choices, the
float8 control is not, and a run whose timed path is broken underneath
comes out not correct."""
import pytest
import torch

from portbench import serve
from portbench.reference import compare
from portbench.reference import model as ref_model
from portbench.tests import small

CELLS = sorted(small.CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_served_tokens_are_the_references_first_choice(name):
    run = small.run(name)
    assert run.correct
    assert run.readings["widest"] <= 1e-4
    assert sum(len(t) for t in run.sample[2]) >= 8


@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_is_not_correct(name):
    run = small.run(name)
    seqs, pos, toks = run.sample
    ref = ref_model.logits(run.cfg, 2**31 + 11, seqs, pos, "cpu")
    low = ref_model.logits(run.cfg, 2**31 + 11, seqs, pos, "cpu",
                           precision="fp8")
    got = compare.readings(ref, compare.control_tokens(low))
    number = run.workload["correct"]["number"]
    assert got[serve.NUMBERS[number]] > run.workload["correct"]["limit"]


def _altered(decode_step):
    calls = [0]

    def step(params, cfg, state, batch, **kw):
        st, logits = decode_step(params, cfg, state, batch, **kw)
        logits = logits.clone()
        row = calls[0] % logits.shape[0]       # one row's token a step
        logits[row] = logits[row].roll(1)
        calls[0] += 1
        return st, logits
    return step


def _unchanged(decode_step):
    def step(params, cfg, state, batch, **kw):
        copy = {k: v.clone() for k, v in state.items()}
        _, logits = decode_step(params, cfg, copy, batch, **kw)
        return dict(state, len=state["len"] + 1), logits   # state as it was
    return step


def _half(decode_step):
    def step(params, cfg, state, batch, **kw):
        rows = torch.arange(0, state["len"].shape[0], 2)   # odd rows left out
        part = {k: v[:, rows] if v.dim() > 1 else v[rows]
                for k, v in state.items()}
        st, lg = decode_step(params, cfg, part,
                             {"inputs": batch["inputs"][rows]}, **kw)
        for k in ("cache_k", "cache_v"):
            state[k][:, rows] = st[k]
        logits = torch.zeros((state["len"].shape[0],) + lg.shape[1:],
                             dtype=lg.dtype)
        logits[rows] = lg
        return dict(state, len=state["len"] + 1), logits
    return step


@pytest.mark.parametrize("fault", [_altered, _unchanged, _half])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    from repro_torch.serve import engine
    monkeypatch.setattr(engine, "decode_step", fault(engine.decode_step))
    run = small.run(name)
    assert not run.correct
    (check,) = run.checks.values()
    assert check["value"] > check["limit"]
