"""The port's MoE layer (``models/mlp.py``) against the JAX package's, on
the same numpy-drawn inputs and parameters: output and router aux loss
agree at 1e-5 (f32) with no drops, with forced drops, with rows of zeros
(every expert tied: the top k go to the lowest expert indices in both), and
with 0, 1 and 2 shared experts. The port's own init has the JAX shapes,
dtypes and standard deviations (router 0.02, experts 1/sqrt(fan_in))."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoE
from repro.models import mlp as jmlp
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.models import mlp as tmlp

TOL = 1e-5
D = 64


def _params(cfg: JMoE, seed: int = 0):
    p = jmlp.moe_init(jax.random.PRNGKey(seed), D, cfg)
    return p, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


def slots_over_capacity(pt, x, cfg) -> int:
    """Slots the capacity drops, counted from the router as both sides
    route (stable descending sort = lax.top_k's order)."""
    probs = torch.softmax(x.float() @ pt["router"]["w"].float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    top = top[..., :cfg.top_k]
    b, s = x.shape[:2]
    n = s * cfg.top_k
    cap = int(max(1, round(n / cfg.n_experts * cfg.capacity_factor)))
    per = torch.nn.functional.one_hot(top.reshape(b, n), cfg.n_experts).sum(1)
    return int(torch.clamp(per - cap, min=0).sum())


def _check(cfg_kw, x, seed=0):
    cj, ct = JMoE(**cfg_kw), TMoE(**cfg_kw)
    pj, pt = _params(cj, seed)
    oj, aj = jmlp.moe_apply(pj, jnp.asarray(x), cj)
    ot, at = tmlp.moe_apply(pt, torch.from_numpy(x), ct)
    assert ot.shape == x.shape and ot.dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(at), float(aj), atol=TOL, rtol=TOL)
    return pt, ct


BASE = dict(n_experts=8, top_k=2, d_expert=32, n_shared=2)


@pytest.mark.parametrize("s,cf,drops", [(4, 8.0, False), (16, 0.25, True),
                                        (96, 1.25, True), (1, 1.25, False)])
def test_moe_apply_matches_jax(rng, s, cf, drops):
    """Capacity 8 over 8 slots (none dropped); 0.25 (drops forced);
    deepseek's 1.25 at its chunk of 16 x top 6 (n = 96 over 64 experts in
    the published config; here 96 tokens x 2 over 8); a decode step's one
    token (capacity 1)."""
    kw = dict(BASE, capacity_factor=cf)
    x = rng.normal(size=(3, s, D)).astype(np.float32)
    pt, ct = _check(kw, x)
    assert (slots_over_capacity(pt, torch.from_numpy(x), ct) > 0) == drops


def test_moe_apply_ties_on_zero_rows_match_jax(rng):
    """A row of zeros gives equal logits for every expert: both sides route
    its tokens to experts 0 and 1, so those win capacity first and move the
    other tokens' slots; a zero token inside a live row does the same."""
    kw = dict(BASE, capacity_factor=1.0)
    x = rng.normal(size=(3, 12, D)).astype(np.float32)
    x[1] = 0.0
    x[2, 3] = 0.0
    x[2, 7] = 0.0
    pt, ct = _check(kw, x)
    assert slots_over_capacity(pt, torch.from_numpy(x), ct) > 0
    out = tmlp.moe_apply(pt, torch.from_numpy(x), ct)[0]
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("n_shared", [0, 1, 2])
def test_moe_apply_shared_experts_match_jax(rng, n_shared):
    kw = dict(BASE, n_shared=n_shared, capacity_factor=1.25)
    x = rng.normal(size=(2, 8, D)).astype(np.float32)
    pt, _ = _check(kw, x, seed=n_shared)
    assert ("shared" in pt) == bool(n_shared)
    if n_shared:
        assert tuple(pt["shared"]["w_gate"]["w"].shape) == (D, 32 * n_shared)


def test_moe_apply_in_bf16_keeps_the_input_dtype(rng):
    cfg = TMoE(**BASE)
    _, pt = _params(JMoE(**BASE))
    x = torch.from_numpy(rng.normal(size=(2, 5, D)).astype(np.float32))
    out, aux = tmlp.moe_apply(pt, x.to(torch.bfloat16), cfg,
                              compute_dtype=torch.bfloat16)
    ref, _ = tmlp.moe_apply(pt, x, cfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref, atol=4e-2, rtol=4e-2)


@pytest.mark.parametrize("cf", [0.25, 1.25])
def test_moe_ffn_is_moe_apply_without_its_aux(rng, cf):
    """The serving steps' MoE layer gives moe_apply's output bit for bit,
    and the routing from which ``moe_aux`` gives moe_apply's aux."""
    kw = dict(BASE, capacity_factor=cf)
    cfg = TMoE(**kw)
    _, pt = _params(JMoE(**kw))
    x = torch.from_numpy(rng.normal(size=(2, 6, D)).astype(np.float32))
    out, probs, gate_e = tmlp.moe_ffn(pt, x, cfg)
    ref, aux = tmlp.moe_apply(pt, x, cfg)
    assert torch.equal(out, ref)
    assert tuple(probs.shape) == (2, 6, 8) and probs.dtype == torch.float32
    assert tuple(gate_e.shape) == (2, 6, 2)
    assert torch.equal(tmlp.moe_aux(probs, gate_e, cfg), aux)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama4-scout-17b-a16e"])
def test_own_moe_init_shapes_dtypes_and_stddevs(arch):
    cfg = treg.get(arch, reduced=True)
    m = cfg.moe
    wide = dataclasses.replace(m, n_experts=4, d_expert=512)
    for moe, d in ((m, cfg.d_model), (wide, 256)):
        p = tmlp.moe_init(torch.Generator().manual_seed(0), d, moe,
                          device="cpu", lead=(2,))
        e, f = moe.n_experts, moe.d_expert
        assert tuple(p["router"]["w"].shape) == (2, d, e)
        assert tuple(p["w_gate"].shape) == tuple(p["w_up"].shape) == \
            (2, e, d, f)
        assert tuple(p["w_down"].shape) == (2, e, f, d)
        assert all(t.dtype == torch.float32 for t in (
            p["router"]["w"], p["w_gate"], p["w_up"], p["w_down"]))
        assert ("shared" in p) == bool(moe.n_shared)
    # the wide draw: enough samples for 5 % on each standard deviation
    assert abs(float(p["router"]["w"].std()) / 0.02 - 1) < 0.05
    for name, fan in (("w_gate", 256), ("w_up", 256), ("w_down", 512)):
        assert abs(float(p[name].std()) * fan ** 0.5 - 1) < 0.05, name
        # every layer and expert drawn, none left empty or repeated
        flat = p[name].reshape(2 * 4, -1)
        assert bool((flat.std(dim=1) > 0).all())
        assert not torch.equal(flat[0], flat[1])
    bf = tmlp.moe_init(torch.Generator().manual_seed(0), 256, wide,
                       dtype=torch.bfloat16, device="cpu", lead=(2,))
    assert bf["w_down"].dtype == torch.bfloat16
    assert abs(float(bf["w_down"].float().std()) * 512 ** 0.5 - 1) < 0.05
