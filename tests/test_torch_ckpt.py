"""The port's checkpoints: the mirrors of ``tests/checkpoint/test_ckpt.py``
(round trip, checksum, gc, async, shape mismatch, no partial checkpoint on
a crash), a bf16 round trip that is bit-exact, and f32 checkpoints that
cross between the packages both ways (keys, manifest and crc are the JAX
package's)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.optim import AdamWConfig as JAdamW
from repro.optim import quantized as jq
from repro_torch import tree as T
from repro_torch.checkpoint import ckpt
from repro_torch.optim import AdamWConfig, make_optimizer


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": [torch.ones((2, 2)), torch.zeros((3,))]}}


def _equal_trees(a, b):
    la, lb = T.leaves_with_path(a), T.leaves_with_path(b)
    for (pa, x), (pb, y) in zip(la, lb, strict=True):
        assert pa == pb and x.dtype == y.dtype
        assert torch.equal(x, y), pa


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t, extra={"note": "x"})
    restored, manifest = ckpt.restore(str(tmp_path), t)
    assert manifest["step"] == 5 and manifest["extra"]["note"] == "x"
    _equal_trees(t, restored)


def test_checksum_detects_corruption(tmp_path):
    t = _tree()
    d = ckpt.save(str(tmp_path), 1, t)
    mpath = os.path.join(d, "manifest.json")
    with open(mpath) as f:
        m = json.load(f)
    first = next(iter(m["leaves"]))
    m["leaves"][first]["crc32"] ^= 0xFF
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(str(tmp_path), t)


def test_gc_keeps_last_n(tmp_path):
    t = _tree()
    for s in range(6):
        ckpt.save(str(tmp_path), s, t, keep_last=3)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == [f"step_{s:09d}" for s in (3, 4, 5)]
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_async_saver(tmp_path):
    """The snapshot is taken on the caller's thread: changing the tree in
    place after ``save`` returns does not reach the checkpoint."""
    t = _tree()
    want = T.tree_map(torch.clone, t)
    s = ckpt.AsyncSaver()
    s.save(str(tmp_path), 7, t)
    t["a"].add_(1.0)
    s.wait()
    restored, m = ckpt.restore(str(tmp_path), t)
    assert m["step"] == 7
    _equal_trees(want, restored)


def test_shape_mismatch_rejected(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    bad = dict(t, a=torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), bad)


def test_no_partial_checkpoint_on_crash(tmp_path, monkeypatch):
    """A crash mid-write leaves only a .tmp dir; restore uses the previous
    complete step."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)

    def boom(src, dst):
        raise RuntimeError("simulated crash before publish")
    monkeypatch.setattr(os, "rename", boom)
    with pytest.raises(RuntimeError):
        ckpt.save(str(tmp_path), 2, t)
    monkeypatch.undo()
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert os.path.isdir(tmp_path / "step_000000002.tmp")
    restored, m = ckpt.restore(str(tmp_path), t)
    assert m["step"] == 1


def test_bf16_round_trip_is_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(3)
    t = {"w": torch.randn((64, 33), generator=g).to(torch.bfloat16),
         "s": torch.tensor(-0.0, dtype=torch.bfloat16),
         "f": torch.randn((5,), generator=g)}
    d = ckpt.save(str(tmp_path), 0, t)
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)["leaves"]
    assert meta["w"]["dtype"] == "bfloat16" and meta["f"]["dtype"] == "float32"
    with np.load(os.path.join(d, "arrays.npz")) as data:
        assert data["w"].dtype == np.uint16
    restored, _ = ckpt.restore(str(tmp_path), t)
    assert restored["w"].dtype == torch.bfloat16
    for k in t:
        assert torch.equal(restored[k].view(torch.int16)
                           if t[k].dtype == torch.bfloat16 else restored[k],
                           t[k].view(torch.int16)
                           if t[k].dtype == torch.bfloat16 else t[k])


# ---- checkpoints cross between the packages --------------------------------

def _train_like_states():
    """The same f32 train-state-shaped tree in both packages: params, an
    8-bit AdamW state (int8/uint8 codes, f32 scales, an int32 step)."""
    rng = np.random.default_rng(0)
    p = {"layers": {"w": rng.normal(size=(2, 8, 70)).astype(np.float32)},
         "lm_head": {"w": rng.normal(size=(8, 16)).astype(np.float32)}}
    pj = jax.tree.map(jnp.asarray, p)
    sj = {"params": pj, "opt": jq.adamw8bit_init(pj, JAdamW())}
    g = jax.tree.map(lambda a: jnp.asarray(a) * 0.1, p)
    _, sj["opt"], _ = jq.adamw8bit_update(g, sj["opt"], pj, 1e-2, JAdamW())
    pt = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)
    st = {"params": pt, "opt": make_optimizer("adamw8bit",
                                              AdamWConfig())[0](pt)}
    return sj, st


def _same_values(t_tree, j_tree):
    jl = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    tl = list(T.leaves_with_path(t_tree))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        ["".join(f"[{k!r}]" for k in p) for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    sj, st = _train_like_states()
    jckpt.save(str(tmp_path), 4, sj)
    restored, m = ckpt.restore(str(tmp_path), st)
    assert m["step"] == 4
    _same_values(restored, sj)


def test_port_checkpoint_restores_in_jax(tmp_path):
    sj, st = _train_like_states()
    # the port's tree with the JAX state's values
    st = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), sj)
    ckpt.save(str(tmp_path), 9, st)
    restored, m = jckpt.restore(str(tmp_path), sj)
    assert m["step"] == 9
    _same_values(st, restored)
    with open(tmp_path / "step_000000009" / "manifest.json") as f:
        port_manifest = json.load(f)
    jckpt.save(str(tmp_path / "j"), 9, sj)
    with open(tmp_path / "j" / "step_000000009" / "manifest.json") as f:
        assert json.load(f) == port_manifest
