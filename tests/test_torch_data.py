"""The port's data pipeline against the JAX package's: ``make_batch`` is
byte-equal for the chain and uniform tasks, token and embedding input, and
M-RoPE positions; the loader puts those bytes on the device it names. Plus
the mirrors of ``tests/data/test_pipeline.py``."""
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import pipeline as jdp
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tdp

ARCHS = ["tinyllama-1.1b", "musicgen-large", "qwen2-vl-7b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("task", ["chain", "uniform"])
@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (42, 1000)])
def test_make_batch_is_byte_equal_to_jax(arch, task, seed, step):
    cj = jreg.get(arch, reduced=True)
    ct = treg.get(arch, reduced=True)
    want = jdp.make_batch(cj, jdp.DataConfig(seed=seed, task=task), step,
                          4, 16)
    got = tdp.make_batch(ct, tdp.DataConfig(seed=seed, task=task), step, 4,
                         16)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    assert ("positions" in got) == (ct.pos_embed == "mrope")


def test_loader_puts_the_batch_on_its_device():
    cfg = treg.get("qwen2-vl-7b", reduced=True)
    loader = tdp.ShardedLoader(cfg, tdp.DataConfig(seed=3), batch=2, seq=8,
                               device="cpu")
    host = tdp.make_batch(cfg, tdp.DataConfig(seed=3), 5, 2, 8)
    got = loader.get(5)
    for k, v in host.items():
        assert torch.is_tensor(got[k]) and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_loader_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdp.ShardedLoader(treg.get("tinyllama-1.1b", reduced=True),
                          tdp.DataConfig(), batch=2, seq=8)


# ---- mirrors of tests/data/test_pipeline.py -------------------------------

def test_batches_are_pure_functions_of_step():
    cfg = treg.get("tinyllama-1.1b", reduced=True)
    dc = tdp.DataConfig(seed=42)
    a = tdp.make_batch(cfg, dc, step=7, batch=4, seq=16)
    b = tdp.make_batch(cfg, dc, step=7, batch=4, seq=16)
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    c = tdp.make_batch(cfg, dc, step=8, batch=4, seq=16)
    assert not np.array_equal(a["inputs"], c["inputs"])


def test_different_seeds_differ():
    cfg = treg.get("tinyllama-1.1b", reduced=True)
    a = tdp.make_batch(cfg, tdp.DataConfig(seed=1), 0, 4, 16)
    b = tdp.make_batch(cfg, tdp.DataConfig(seed=2), 0, 4, 16)
    assert not np.array_equal(a["inputs"], b["inputs"])


def test_chain_task_structure():
    """labels are the chain continuation of inputs: x_{t+1} = a*x_t + b."""
    cfg = treg.get("tinyllama-1.1b", reduced=True)
    batch = tdp.make_batch(cfg, tdp.DataConfig(seed=0), 0, 4, 32)
    x, y = batch["inputs"], batch["labels"]
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])   # shifted by one
    v = cfg.vocab
    for row in range(4):
        assert any(all((a * int(x[row, t]) + (int(y[row, 0]) - a *
                                               int(x[row, 0])) % v) % v
                       == int(y[row, t]) for t in range(8))
                   for a in range(1, 97)), f"row {row} is not a chain"


def test_embeddings_mode_stub_frontend():
    cfg = treg.get("musicgen-large", reduced=True)
    batch = tdp.make_batch(cfg, tdp.DataConfig(seed=0), 0, 2, 8)
    assert batch["inputs"].shape == (2, 8, cfg.d_model)
    assert batch["inputs"].dtype == np.float32
    assert batch["labels"].shape == (2, 8)


def test_loader_iteration():
    cfg = treg.get("tinyllama-1.1b", reduced=True)
    loader = tdp.ShardedLoader(cfg, tdp.DataConfig(seed=0), batch=2, seq=8,
                               device="cpu")
    it = iter(loader)
    b0, b1 = next(it), next(it)
    assert tuple(b0["inputs"].shape) == (2, 8)
    assert not torch.equal(b0["inputs"], b1["inputs"])
