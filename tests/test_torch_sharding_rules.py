"""The port's sharding rules against the JAX package's, on shape-only
trees (the port's on the meta device, JAX's from ``jax.eval_shape``) and
shape-only meshes: every registered arch at its published widths on the
two production meshes, leaf by leaf as tuples, for the parameters, the
train states of the three optimizers with and without int8_ef, the decode
states under serving rules, the batch and the KV cache. Then the port's
own checks: every spec divides its dim, norm scales replicate, and the
attention head mismatch raises while the GQA fallback holds (JAX's
tests/distributed/test_sharding_rules.py). No process group is needed."""
import functools

import jax
import pytest
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as jreg
from repro.distributed import sharding as jshd
from repro.launch import specs as JSP
from repro.train.train_step import TrainConfig as JTrainConfig
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as SP
from repro_torch.train.train_step import TrainConfig


class FakeMesh:
    """Shape-only stand-in (no devices needed for spec computation)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}
SERVING = dict(tp=("data", "model"), fsdp=(), dp=())    # JAX's test's
OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")


def _jax_flat(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _port_flat(specs) -> dict:
    return {shd.path_str(p): s for p, s in T.leaves_with_path(specs)}


def _same(port, jax_specs) -> None:
    p, j = _port_flat(port), _jax_flat(jax_specs)
    assert sorted(p) == sorted(j)
    bad = {k: (p[k], j[k]) for k in j if p[k] != j[k]}
    assert not bad, bad


def _both(fn_port, fn_jax):
    """Both sides' specs, or both sides' ValueError with the same text."""
    try:
        j = fn_jax()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_port()
        assert str(got.value) == str(e)
        return None, None
    return fn_port(), j


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    return (SP.params_shapes(treg.get(arch)),
            JSP.params_shapes(jreg.get(arch)))


@functools.lru_cache(maxsize=None)
def _train_state(arch: str, opt: str, ef: bool):
    kw = dict(optimizer=opt, grad_compression="int8_ef" if ef else None,
              n_pods=2 if ef else 1)
    return (SP.train_state_shapes(treg.get(arch), TrainConfig(**kw)),
            JSP.train_state_shapes(jreg.get(arch), JTrainConfig(**kw)))


@pytest.mark.parametrize("mesh", MESHES, ids=list(MESHES))
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_param_pspecs_match_jax(arch, mesh):
    """Raw divisibility guards, and head-aligned with the config (equal
    specs, or the same mesh/head mismatch error)."""
    m = MESHES[mesh]
    pt, pj = _params(arch)
    for cfg_t, cfg_j in ((None, None), (treg.get(arch), jreg.get(arch))):
        port, jx = _both(
            lambda: shd.param_pspecs(pt, m, shd.Rules.for_mesh(m), cfg=cfg_t),
            lambda: jshd.param_pspecs(pj, m, jshd.Rules.for_mesh(m),
                                      cfg=cfg_j))
        if jx is not None:
            _same(port, jx)


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "int8_ef"])
@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_train_state_pspecs_match_jax(arch, opt, ef):
    """The three optimizers' states (moments, 8-bit blocks, factors) and
    the error-feedback residuals; int8_ef on the two-pod mesh, where
    ``pod`` takes the residuals' lead axis."""
    m = MESHES["multi" if ef else "single"]
    st, sj = _train_state(arch, opt, ef)
    port, jx = _both(
        lambda: SP.train_state_pspecs(treg.get(arch), m,
                                      shd.Rules.for_mesh(m), st),
        lambda: JSP.train_state_pspecs(jreg.get(arch), m,
                                       jshd.Rules.for_mesh(m), sj))
    if jx is not None:
        _same(port, jx)
    else:       # the head mismatch: compare the rules without the config
        pspecs = shd.param_pspecs(st["params"], m, shd.Rules.for_mesh(m))
        jspecs = jshd.param_pspecs(sj["params"], m, jshd.Rules.for_mesh(m))
        _same(SP.opt_state_pspecs(st["opt"], pspecs, m,
                                  shd.Rules.for_mesh(m)),
              JSP.opt_state_pspecs(sj["opt"], jspecs, m,
                                   jshd.Rules.for_mesh(m)))


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_decode_state_pspecs_match_jax(arch):
    m = MESHES["single"]
    port = shd.decode_state_pspecs(
        treg.get(arch), m, shd.Rules(**SERVING),
        SP.decode_state_shapes(treg.get(arch), 128, 1024), batch=128)
    jx = jshd.decode_state_pspecs(
        jreg.get(arch), m, jshd.Rules(**SERVING),
        JSP.decode_state_shapes(jreg.get(arch), 128, 1024), batch=128)
    _same(port, jx)


@pytest.mark.parametrize("mesh", MESHES, ids=list(MESHES))
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_batch_and_kv_cache_specs_match_jax(arch, mesh):
    m = MESHES[mesh]
    for rules, jrules in ((shd.Rules.for_mesh(m), jshd.Rules.for_mesh(m)),
                          (shd.Rules(**SERVING), jshd.Rules(**SERVING))):
        for batch in (1, 8, 32, 128, 512):
            assert shd.batch_axes(m, rules, batch) == \
                jshd.batch_axes(m, jrules, batch)
            assert shd.batch_specs(treg.get(arch), m, rules,
                                   global_batch=batch) == \
                {k: tuple(v) for k, v in jshd.batch_specs(
                    jreg.get(arch), m, jrules, global_batch=batch).items()}
            for n_stack in (1, 2):
                assert shd.kv_cache_spec(treg.get(arch), m, rules,
                                         batch=batch, n_stack=n_stack) == \
                    tuple(jshd.kv_cache_spec(jreg.get(arch), m, jrules,
                                             batch=batch, n_stack=n_stack))


# ---- the port's own checks --------------------------------------------------

def _divides(shapes, specs, mesh) -> None:
    for (path, leaf), spec in zip(T.leaves_with_path(shapes),
                                  T.leaves_up_to(shapes, specs)):
        assert len(spec) <= len(leaf.shape), (path, spec, leaf.shape)
        for dim, axes in zip(leaf.shape, spec):
            n = 1
            for a in ((axes,) if isinstance(axes, str) else axes or ()):
                n *= mesh.shape[a]
            assert dim % n == 0, f"{shd.path_str(path)}: {dim} % {axes}"


@pytest.mark.parametrize("mesh", MESHES, ids=list(MESHES))
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_param_specs_divisible(arch, mesh):
    m = MESHES[mesh]
    shapes = _params(arch)[0]
    _divides(shapes, shd.param_pspecs(shapes, m, shd.Rules.for_mesh(m)), m)


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_train_state_specs_divisible(opt):
    m = MESHES["multi"]
    shapes = _train_state("llama3-405b", opt, True)[0]
    _divides(shapes, SP.train_state_pspecs(
        treg.get("llama3-405b"), m, shd.Rules.for_mesh(m), shapes), m)


def test_norm_scales_replicated():
    m = MESHES["single"]
    specs = shd.param_pspecs(_params("qwen2.5-3b")[0], m,
                             shd.Rules.for_mesh(m))
    for name, spec in _port_flat(specs).items():
        if name.endswith(("ln1/scale", "ln2/scale", "final_norm/scale")):
            assert all(a is None for a in spec), (name, spec)


def test_attention_tp_mesh_head_mismatch_raises():
    """tp that does not divide the query heads raises, naming them; tp
    that divides the query heads but not the kv heads keeps q sharded and
    replicates k/v (the GQA fallback)."""
    cfg = treg.get("tinyllama-1.1b", reduced=True)      # heads 8, kv 2
    shapes = SP.params_shapes(cfg)
    mesh = FakeMesh({"data": 2, "model": 16})
    with pytest.raises(ValueError, match=r"n_heads=8.*n_kv_heads=2"):
        shd.param_pspecs(shapes, mesh, shd.Rules.for_mesh(mesh), cfg=cfg)
    mesh = FakeMesh({"data": 2, "model": 4})
    by_name = _port_flat(shd.param_pspecs(shapes, mesh,
                                          shd.Rules.for_mesh(mesh), cfg=cfg))
    assert by_name["layers/attn/wq/w"][-1] == "model"
    assert by_name["layers/attn/wk/w"][-1] is None
    assert by_name["layers/attn/wv/w"][-1] is None
    # without cfg the raw divisibility guards apply unchanged (no raise)
    shd.param_pspecs(shapes, FakeMesh({"data": 2, "model": 16}), shd.Rules())


def test_spec_is_a_tree_leaf_equal_to_its_tuple():
    s = shd.P(("pod", "data"), None, "model")
    assert s == (("pod", "data"), None, "model") == JP(("pod", "data"), None,
                                                      "model")
    assert s != shd.P("data") and hash(s) == hash(shd.P(*s))
    assert T.leaves({"a": s, "b": [s]}) == [s, s]


@pytest.mark.parametrize("spec,want", [
    (("data", "model"), (Shard(0), Shard(1))),
    ((None, "model"), (Replicate(), Shard(1))),
    (("model", None), (Replicate(), Shard(0))),
    ((None, None), (Replicate(), Replicate())),
])
def test_placements_of_a_spec(spec, want):
    """One placement per mesh dim; a tensor dim over two mesh axes is one
    Shard of it on each, named in the mesh's order (``spec_of``, the way
    back from a DTensor, is checked in tests/test_torch_multidevice.py)."""
    m = FakeMesh({"data": 2, "model": 4})
    assert shd.placements(shd.P(*spec), m) == want
    pod = FakeMesh({"pod": 2, "data": 2, "model": 2})
    assert shd.placements(shd.P(("pod", "data"), None), pod) == \
        (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        shd.placements(shd.P(("data", "pod"), None), pod)
