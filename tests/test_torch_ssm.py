"""The port's attention-free and hybrid families (ROADMAP A9b) against the
JAX package's on the same numpy-drawn inputs, with the JAX parameters
bridged across (``params_from_numpy``), reduced configs in f32 on the CPU:

* the modules: RWKV6 time-mix and channel-mix (apply, apply with carried
  states, step), Mamba2 (the same three) and its causal conv with a
  carried state, at 1e-5 of each output's largest |value|;
* the models, reduced rwkv6-3b and zamba2-7b: the parameter and
  decode-state trees (at the published configs too: JAX through
  ``jax.eval_shape``, the port on the meta device); ``forward``,
  ``prefill`` and ``decode_step`` in both kernel modes, logits and every
  decode-state leaf at 1e-4 (as ``test_torch_models.py``: sums taken in
  another order compound through the layers); prefill then decode equals
  ``forward`` (atol 3e-3 / rtol 1e-3, ``tests/models/test_decode_equiv.py``);
  ``loss_fn`` and every grad leaf against ``jax.value_and_grad`` (rtol
  1e-5 as ``test_torch_train.py``; atol 5e-6 of the leaf's largest
  |value| where that file has 1e-6: against an f64 run of the same loss,
  the JAX package's own f32 grads are off by up to 2.1e-6 (rwkv6) and
  3.8e-6 (zamba2) of a leaf's largest |value|, the port's by 2.1e-6 and
  3.0e-6, through the chunked recurrences), block remat on and off
  identical;
* a hybrid train state (``groups`` a nested [g, m] stack) whose checkpoint
  crosses between the packages both ways, and the launcher's 2 CPU steps
  of each family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jreg
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.optim import AdamWConfig as JAdamW
from repro.train import train_step as jts
from repro_torch import models as tm
from repro_torch import tree as T
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry as treg
from repro_torch.launch import train as launch_train
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.optim import AdamWConfig
from repro_torch.train import train_step as tts

TOL = 1e-5
MODEL_TOL = 1e-4
DECODE_TOL = dict(atol=3e-3, rtol=1e-3)
LOSS_RTOL, LOSS_ATOL_OF_MAX = 1e-5, 5e-6
ARCHS = ("rwkv6-3b", "zamba2-7b")
B, S, PREFIX = 2, 32, 16       # reduced q_chunk 16, la_chunk 8


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else \
        x.detach().float().numpy()


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _bridge_tree(tree):
    return tm.params_from_numpy(jax.tree.map(np.asarray, tree), None, "cpu")


def _pair(rng, *shape):
    """The same N(0, 1) f32 draw as a jax array and a torch tensor."""
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _walk(t_tree, j_tree):
    """(path, port leaf, JAX leaf) for every leaf of the JAX tree."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(j_tree)[0]:
        got = t_tree
        for k in path:
            got = got[k.key]
        yield jax.tree_util.keystr(path), got, leaf


def _close_trees(t_tree, j_tree, tol=MODEL_TOL):
    n = 0
    for path, got, want in _walk(t_tree, j_tree):
        try:
            _close(got, want, tol)
        except AssertionError as e:
            raise AssertionError(path) from e
        n += 1
    assert n == len(T.leaves(t_tree))


# ---- the modules -----------------------------------------------------------

RWKV_MODES = ["apply", "apply_states", "step"]


@pytest.mark.parametrize("mode", RWKV_MODES)
def test_time_mix_matches_jax(rng, mode):
    cfg = jreg.get("rwkv6-3b", reduced=True)
    d, h, hd = cfg.d_model, cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    pj = jrwkv.time_mix_init(jax.random.PRNGKey(1), d, cfg.rwkv)
    pt = _bridge_tree(pj)
    t = 1 if mode == "step" else 11
    xj, xt = _pair(rng, B, t, d)
    sj, st = _pair(rng, B, d)
    mj, mt = _pair(rng, B, h, hd, hd)
    if mode == "apply":
        _close(trwkv.time_mix_apply(pt, xt, cfg.rwkv, la_chunk=4),
               jrwkv.time_mix_apply(pj, xj, cfg.rwkv, la_chunk=4))
        return
    if mode == "apply_states":
        got = trwkv.time_mix_apply(pt, xt, cfg.rwkv, la_chunk=4,
                                   shift_state=st, ssm_state=mt,
                                   return_state=True)
        want = jrwkv.time_mix_apply(pj, xj, cfg.rwkv, la_chunk=4,
                                    shift_state=sj, ssm_state=mj,
                                    return_state=True)
    else:
        got = trwkv.time_mix_step(pt, xt, cfg.rwkv, shift_state=st,
                                  ssm_state=mt)
        want = jrwkv.time_mix_step(pj, xj, cfg.rwkv, shift_state=sj,
                                   ssm_state=mj)
    for g, w in zip(got, want, strict=True):
        _close(g, w)


@pytest.mark.parametrize("mode", RWKV_MODES)
def test_channel_mix_matches_jax(rng, mode):
    cfg = jreg.get("rwkv6-3b", reduced=True)
    pj = jrwkv.channel_mix_init(jax.random.PRNGKey(2), cfg.d_model, cfg.d_ff)
    pt = _bridge_tree(pj)
    xj, xt = _pair(rng, B, 1 if mode == "step" else 9, cfg.d_model)
    sj, st = _pair(rng, B, cfg.d_model)
    if mode == "apply":
        _close(trwkv.channel_mix_apply(pt, xt),
               jrwkv.channel_mix_apply(pj, xj))
        return
    if mode == "apply_states":
        got = trwkv.channel_mix_apply(pt, xt, shift_state=st,
                                      return_state=True)
        want = jrwkv.channel_mix_apply(pj, xj, shift_state=sj,
                                       return_state=True)
    else:
        got = trwkv.channel_mix_step(pt, xt, shift_state=st)
        want = jrwkv.channel_mix_step(pj, xj, shift_state=sj)
    for g, w in zip(got, want, strict=True):
        _close(g, w)


def _mamba_states(rng, cfg, d_model):
    ssm = cfg.ssm
    d_in = ssm.expand * d_model
    ck = ssm.conv_kernel - 1
    conv = {n: _pair(rng, B, ck, c) for n, c in
            (("x", d_in), ("B", ssm.state_dim), ("C", ssm.state_dim))}
    rec = _pair(rng, B, d_in // ssm.head_dim, ssm.state_dim, ssm.head_dim)
    return ({k: v[0] for k, v in conv.items()}, rec[0],
            {k: v[1] for k, v in conv.items()}, rec[1])


@pytest.mark.parametrize("mode", RWKV_MODES)
def test_mamba2_matches_jax(rng, mode):
    cfg = jreg.get("zamba2-7b", reduced=True)
    d = cfg.d_model
    pj = jssm.mamba2_init(jax.random.PRNGKey(3), d, cfg.ssm)
    pt = _bridge_tree(pj)
    xj, xt = _pair(rng, B, 1 if mode == "step" else 13, d)
    cj, sj, ct, st = _mamba_states(rng, cfg, d)
    if mode == "apply":
        _close(tssm.mamba2_apply(pt, xt, d, cfg.ssm, la_chunk=4),
               jssm.mamba2_apply(pj, xj, d, cfg.ssm, la_chunk=4))
        return
    if mode == "apply_states":
        got = tssm.mamba2_apply(pt, xt, d, cfg.ssm, la_chunk=4,
                                conv_state=ct, ssm_state=st,
                                return_state=True)
        want = jssm.mamba2_apply(pj, xj, d, cfg.ssm, la_chunk=4,
                                 conv_state=cj, ssm_state=sj,
                                 return_state=True)
    else:
        got = tssm.mamba2_decode_step(pt, xt, d, cfg.ssm, conv_state=ct,
                                      ssm_state=st)
        want = jssm.mamba2_decode_step(pj, xj, d, cfg.ssm, conv_state=cj,
                                       ssm_state=sj)
    _close(got[0], want[0])
    for k in "xBC":
        _close(got[1][k], want[1][k])
    _close(got[2], want[2])


def test_conv_carries_its_state(rng):
    """The depthwise causal conv against the JAX package's, with and
    without a carried state; two halves with the state carried == one
    pass."""
    w = rng.normal(size=(4, 6)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    pj = {"w": jnp.asarray(w), "b": jnp.asarray(bias)}
    pt = {"w": torch.from_numpy(w), "b": torch.from_numpy(bias)}
    xj, xt = _pair(rng, B, 10, 6)
    sj, st = _pair(rng, B, 3, 6)
    for state in ((None, None), (sj, st)):
        yt, nt = tssm._conv(pt, xt, state[1])
        yj, nj = jssm._conv(pj, xj, state[0])
        _close(yt, yj)
        _close(nt, nj)
    y1, s1 = tssm._conv(pt, xt[:, :4], None)
    y2, s2 = tssm._conv(pt, xt[:, 4:], s1)
    whole, s_whole = tssm._conv(pt, xt, None)
    _close(torch.cat([y1, y2], 1), whole)
    assert torch.equal(s2, s_whole)


def test_softplus_matches_jax():
    """dt's softplus as ``jax.nn.softplus`` (exact above 20 too)."""
    x = np.linspace(-40, 40, 1601).astype(np.float32)
    np.testing.assert_allclose(tssm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


# ---- the models --------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    cfg_j = jreg.get(request.param, reduced=True)
    cfg_t = treg.get(request.param, reduced=True)
    params_j = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, params_j, _bridge_tree(params_j)


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(7).integers(0, 256, (B, S)).astype(np.int32)


def _same_specs(t_tree, j_tree):
    n = 0
    for path, got, want in _walk(t_tree, j_tree):
        assert tuple(got.shape) == tuple(want.shape), path
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        n += 1
    assert n == len(T.leaves(t_tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_trees_match_jax_at_the_published_config(arch):
    """Parameters and decode state of the published config: every leaf's
    shape and dtype, JAX's through ``jax.eval_shape``, the port's own init
    on the meta device."""
    cfg_j, cfg_t = jreg.get(arch), treg.get(arch)
    pj = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), cfg_j))
    sj = jax.eval_shape(lambda: jm.init_decode_state(cfg_j, B, 64))
    _same_specs(tm.init_params(cfg_t, torch.Generator(), "meta"), pj)
    _same_specs(tm.init_decode_state(cfg_t, B, 64, "meta"), sj)


def test_forward_matches_jax(bridged, ids):
    cfg_j, cfg_t, params_j, params_t = bridged
    lj, aj = jm.forward(params_j, cfg_j, {"inputs": jnp.asarray(ids)})
    lt, at = tm.forward(params_t, cfg_t, {"inputs": torch.from_numpy(ids)})
    _close(lt, lj, MODEL_TOL)
    assert float(at) == float(aj) == 0.0


@pytest.mark.parametrize("mode", ["multiport", "reference"])
def test_prefill_and_decode_match_jax(bridged, ids, mode):
    """``prefill`` of 16 tokens, then 3 decode steps: each call's logits
    and, at the end, every decode-state leaf."""
    cfg_j, cfg_t, params_j, params_t = bridged
    sj = jm.init_decode_state(cfg_j, B, S)
    st = tm.init_decode_state(cfg_t, B, S, "cpu")
    sj, lj = jm.prefill(params_j, cfg_j, sj,
                        {"inputs": jnp.asarray(ids[:, :PREFIX])})
    st, lt = tm.prefill(params_t, cfg_t, st,
                        {"inputs": torch.from_numpy(ids[:, :PREFIX])})
    _close(lt, lj, MODEL_TOL)
    for t in range(PREFIX, PREFIX + 3):
        step = ids[:, t:t + 1]
        sj, lj = jm.decode_step(params_j, cfg_j, sj,
                                {"inputs": jnp.asarray(step)},
                                kernel_mode=mode, seq_tile=8)
        st, lt = tm.decode_step(params_t, cfg_t, st,
                                {"inputs": torch.from_numpy(step)},
                                kernel_mode=mode, seq_tile=8)
        _close(lt, lj, MODEL_TOL)
        assert np.array_equal(lt.argmax(-1).numpy(),
                              np.asarray(lj).argmax(-1))
    _close_trees(st, sj)


@pytest.mark.parametrize("mode", ["multiport", "reference"])
def test_prefill_then_decode_equals_forward(bridged, ids, mode):
    """prefill(prompt) + teacher-forced decode steps reproduce forward's
    logits at the same positions; the decode state is updated in place."""
    _, cfg_t, _, params_t = bridged
    ids_t = torch.from_numpy(ids)
    logits, _ = tm.forward(params_t, cfg_t, {"inputs": ids_t})
    state = tm.init_decode_state(cfg_t, B, S, "cpu")
    given = dict(state)
    state, lg = tm.prefill(params_t, cfg_t, state,
                           {"inputs": ids_t[:, :PREFIX]})
    torch.testing.assert_close(lg, logits[:, PREFIX - 1], **DECODE_TOL)
    for t in range(PREFIX, S):
        state, lg = tm.decode_step(params_t, cfg_t, state,
                                   {"inputs": ids_t[:, t:t + 1]},
                                   kernel_mode=mode, seq_tile=8)
        torch.testing.assert_close(lg, logits[:, t], **DECODE_TOL)
        assert torch.equal(lg.argmax(-1), logits[:, t].argmax(-1))
    assert state["len"].tolist() == [S] * B
    for k, v in given.items():
        if k != "len":
            assert state[k] is v


def _loss_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, 16)).astype(np.int32)
    labels[0, :3] = -1
    return {"inputs": rng.integers(0, cfg.vocab, (B, 16)).astype(np.int32),
            "labels": labels}


def test_loss_fn_and_grads_match_jax(bridged):
    cfg_j, cfg_t, params_j, params_t = bridged
    nb = _loss_batch(cfg_j)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jm.loss_fn(p, cfg_j, jax.tree.map(jnp.asarray, nb)),
        has_aux=True)(params_j)
    leaves = [p.detach().requires_grad_() for p in T.leaves(params_t)]
    pt = T.unflatten(params_t, leaves)
    lt, mt = tm.loss_fn(pt, cfg_t, {k: torch.from_numpy(v)
                                    for k, v in nb.items()})
    gt = T.unflatten(pt, torch.autograd.grad(lt, leaves))
    mt = {k: v.detach() for k, v in mt.items()}
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    n = 0
    for path, got, want in _walk(gt, gj):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=LOSS_RTOL,
            atol=LOSS_ATOL_OF_MAX * float(np.abs(want).max()), err_msg=path)
        n += 1
    assert n == len(leaves)


def test_remat_on_and_off_give_identical_grads(bridged):
    """Block remat (for the hybrid family a group at a time, and each
    tail block) recomputes the same forward: identical grads."""
    _, cfg_t, _, params_t = bridged
    tb = {k: torch.from_numpy(v) for k, v in _loss_batch(cfg_t, 1).items()}
    grads = {}
    for remat in ("block", "none"):
        cfg = dataclasses.replace(cfg_t, remat=remat)
        leaves = [p.detach().requires_grad_() for p in T.leaves(params_t)]
        loss, _ = tm.loss_fn(T.unflatten(params_t, leaves), cfg, tb)
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["block"], grads["none"], strict=True):
        assert torch.equal(a, b)


# ---- checkpoints and the launcher ---------------------------------------------

def _hybrid_states():
    """The reduced zamba2-7b AdamW train state in both packages, the port's
    holding the JAX state's values."""
    cfg_j = jreg.get("zamba2-7b", reduced=True)
    pj = jm.init_params(jax.random.PRNGKey(4), cfg_j)
    sj = jts.init_train_state(pj, jts.TrainConfig(adamw=JAdamW()))
    st = tts.init_train_state(_bridge_tree(pj),
                              tts.TrainConfig(adamw=AdamWConfig()))
    return sj, jax.tree.map(np.asarray, sj), st


def _equal_to(t_tree, j_tree):
    n = 0
    for path, got, want in _walk(t_tree, j_tree):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
        n += 1
    assert n == len(T.leaves(t_tree))


def test_hybrid_checkpoint_crosses_both_ways(tmp_path):
    sj, sj_np, st = _hybrid_states()
    assert st["params"]["groups"]["ln"]["scale"].dim() == 3    # [g, m, d]
    jckpt.save(str(tmp_path / "j"), 3, sj)
    restored, m = ckpt.restore(str(tmp_path / "j"), st)
    assert m["step"] == 3
    _equal_to(restored, sj_np)
    port = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), sj_np)
    ckpt.save(str(tmp_path / "t"), 5, port)
    back, m = jckpt.restore(str(tmp_path / "t"), sj)
    assert m["step"] == 5
    _equal_to(port, jax.tree.map(np.asarray, back))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_each_family_on_the_cpu(tmp_path, capsys, arch):
    runner = launch_train.main(
        ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
         "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch}-reduced params=")
    assert len(runner.history) == 2
    assert all(np.isfinite(h["ce"]) for h in runner.history)
