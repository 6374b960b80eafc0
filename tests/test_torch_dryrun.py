"""The port's dry run (``repro_torch.launch.dryrun``) and its parts: the
activation hints (``distributed/api.py``), the counting world
(``distributed/countgroup.py``) and the sharded serving steps it traces.

* ``hint`` is the identity outside a context and on plain tensors; inside
  one it places a DTensor by the named spec, padded to its rank.
* On 4 CPU ranks of the host-staged backend (the rank bodies are in
  tests/torch_mesh_ranks.py), a reduced tinyllama step under the dry
  run's hints has the loss of the step without them (rtol 1e-6) and
  another collective tally; rank 0's tally of the step without hints
  equals, key by key, what the op analysis counts for the same step
  traced on fake tensors over a counting world of 4: the CPU counterpart
  of ``chip_smoke.py`` phase 8d.
* Sharded ``prefill`` and ``decode_step`` on 4 gloo ranks, from the JAX
  package's seed-0 parameters, equal the same steps on one device (1e-5)
  and the JAX package's ``prefill`` and ``decode_step`` (1e-5); a cache
  whose positions do not split evenly over the mesh raises.
* ``build_cell_fn`` at reduced widths runs train, prefill and decode of
  the dense family on a (2, 4) counting mesh; ``run_cell`` records the
  MoE, hybrid and ssm cells ``ok`` and the JAX rules' own head mismatch
  as an error; ``main`` writes a record with the JAX record's keys.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, empty

from repro import models as jm
from repro.configs import registry as jreg
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import countgroup
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.api import activation_specs, hint
from repro_torch.launch import dryrun, local_ranks, op_analysis, train
from repro_torch.launch.mesh import make_debug_mesh, make_mesh
from repro_torch.train.train_step import make_train_step
import torch_mesh_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
LOSS_RTOL = 1e-6
SERVE_TOL = 1e-5
JAX_KEYS = {"arch", "shape", "mesh", "kind", "chips", "tokens_per_step",
            "status", "memory", "cost", "total_s"}


def _job(target: str, tmp_path, backend=None, **kwargs) -> list:
    return local_ranks.run(f"torch_mesh_ranks:{target}", 4, device="cpu",
                           kwargs=kwargs, timeout=300, path=[HERE],
                           workdir=str(tmp_path / target), backend=backend)


def test_hint_is_the_identity_outside_a_context_and_on_plain_tensors():
    x = torch.ones(8, 4, 6)
    assert hint(x, "logits") is x
    with activation_specs({"logits": shd.P("data", None, "model")}):
        assert hint(x, "logits") is x


def test_hint_places_a_dtensor_by_its_spec_padded_to_the_rank():
    with countgroup.world(4):
        mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
        with FakeTensorMode():
            x = empty(8, 4, 6, device_mesh=mesh.device_mesh,
                      placements=[Replicate(), Replicate()])
            assert hint(x, "logits") is x
            with activation_specs({"logits": shd.P("data", None, "model"),
                                   "hidden": shd.P(None, "model"),
                                   "moe_buf": None}):
                assert hint(x, "logits").placements == (Shard(0), Shard(2))
                assert hint(x, "hidden").placements == (Replicate(),
                                                        Shard(1))
                assert hint(x, "moe_buf") is x
                assert hint(x, "other") is x


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    return _job("staged_steps", tmp_path_factory.mktemp("staged"),
                backend="hoststaged")


def test_hints_keep_the_loss_and_move_the_collectives(staged):
    for rank in staged:
        plain, hinted = rank["plain"], rank["hinted"]
        for k in ("loss", "ce"):
            assert hinted[k] == pytest.approx(plain[k], rel=LOSS_RTOL)
        assert hinted["staged"] != plain["staged"]


def test_traced_tally_equals_the_staged_tally_of_rank_0(staged):
    args = train.parse_args(["--arch", "tinyllama-1.1b", "--reduced",
                             "--device", "cpu", "--batch", str(R.BATCH),
                             "--seq", str(R.SEQ)])
    cfg, tcfg = train.arch_config(args), train.train_config(args)
    cell = ShapeCell("step", R.SEQ, R.BATCH, "train")
    with countgroup.world(4):
        mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            state, batch = dryrun.train_args(cfg, tcfg, cell, mesh,
                                             shd.Rules.for_mesh(mesh))
        _, ops = op_analysis.analyze(make_train_step(cfg, tcfg), state,
                                     batch)
    want = staged[0]["plain"]["staged"]
    assert ops["staged"] == want
    assert ops["collective_counts"]["reduce-scatter"] == sum(
        n for k, (n, _) in want.items() if k.startswith("reduce_scatter"))


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """The JAX package's seed-0 parameters of reduced tinyllama, and the
    ranks' results and sharded logits of ``sharded_serving`` from them."""
    tmp = tmp_path_factory.mktemp("serving")
    pj = jm.init_params(jax.random.PRNGKey(0),
                        jreg.get("tinyllama-1.1b", reduced=True))
    flat = {"/".join(str(k.key) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(pj)[0]}
    np.savez(tmp / "params.npz", **flat)
    ranks = _job("sharded_serving", tmp, params_npz=str(tmp / "params.npz"),
                 out_npz=str(tmp / "logits.npz"))
    with np.load(tmp / "logits.npz") as f:
        return pj, ranks, [f[f"logits{i}"] for i in range(len(f.files))]


def test_sharded_prefill_and_decode_equal_one_device(serving):
    _, ranks, _ = serving
    for rank in ranks:
        assert max(rank["diff"]) < SERVE_TOL, rank
        # positions split over data, kv heads over model
        assert rank["cache"] == "(Shard(dim=2), Shard(dim=3))"


def test_sharded_prefill_and_decode_match_jax(serving):
    """The JAX package's one-device ``prefill`` and ``decode_step`` on the
    same parameters and ids."""
    pj, _, got = serving
    cfg = jreg.get("tinyllama-1.1b", reduced=True)
    ids = jnp.asarray(R.serving_ids(cfg.vocab))
    prompt = R.SERVE_PROMPT
    st = jm.init_decode_state(cfg, R.SERVE_BATCH, prompt + R.SERVE_STEPS)
    st, lg = jm.prefill(pj, cfg, st, {"inputs": ids[:, :prompt]})
    want = [lg]
    for t in range(prompt, prompt + R.SERVE_STEPS):
        st, lg = jm.decode_step(pj, cfg, st, {"inputs": ids[:, t:t + 1]})
        want.append(lg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   atol=SERVE_TOL, rtol=SERVE_TOL)


@pytest.mark.parametrize("op", ["write_prefix", "decode_attention"])
def test_a_cache_whose_positions_split_unevenly_raises(op):
    """9 positions over 2 shards: DTensor would give the ranks 5 and 4, at
    offsets the position arithmetic does not follow, so it refuses."""
    with countgroup.world(4):
        mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
        with FakeTensorMode():
            cache = empty(4, 9, 2, 8, device_mesh=mesh.device_mesh,
                          placements=[Shard(1), Shard(2)])
            new = torch.empty(4, 2, 8)
            with pytest.raises(ValueError, match="does not split evenly"):
                if op == "write_prefix":
                    shd.write_prefix(cache, torch.empty(4, 3, 2, 8))
                else:
                    shd.decode_attention(torch.empty(4, 8, 8), cache, cache,
                                         new, new, torch.zeros(4))


@pytest.mark.parametrize("kind,seq", [("train", 16), ("prefill", 16),
                                      ("decode", 32)])
def test_build_cell_fn_runs_the_dense_family_on_a_counting_mesh(kind, seq):
    cfg = registry.get("tinyllama-1.1b", reduced=True)
    with countgroup.world(8):
        mesh = make_debug_mesh((2, 4), devices="cpu")
        ops = dryrun.trace_cell(cfg, ShapeCell(kind, seq, 8, kind), mesh,
                                shd.Rules.for_mesh(mesh))
    assert ops["dot_flops"] > 0 and ops["temp_bytes"] > 0
    assert ops["argument_bytes"] > 0 and ops["staged"]


# a depth the CPU traces in seconds; the widths stay the published ones
TRACE_LAYERS = 2


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama4-scout-17b-a16e",
                                  "rwkv6-3b"])
def test_run_cell_records_moe_and_ssm_cells_ok_and_the_head_mismatch(
        arch, tmp_path, monkeypatch):
    """deepseek-moe-16b's dispatch runs on each rank's rows and experts and
    rwkv6-3b's scan on each rank's rows and heads (its 40 heads do not
    split 16 ways: their columns are gathered first), so their
    ``train_4k`` cells record ``ok`` at the published widths, the depth
    cut to 2 layers; llama4-scout's 40 heads do not split 16 ways in
    attention, the JAX rules' own error, which the record keeps. A record
    is read back, not rerun."""
    get = registry.get
    monkeypatch.setattr(registry, "get", lambda a, **kw: dataclasses.replace(
        get(a, **kw), n_layers=TRACE_LAYERS))
    rec = dryrun.run_cell(arch, "train_4k", "single", str(tmp_path))
    assert rec["chips"] == 256 and rec["traced_on"] in ("cpu", "cuda")
    if arch == "llama4-scout-17b-a16e":
        assert rec["status"] == "error" and rec["traceback"]
        assert "attention TP mesh/head mismatch" in rec["error"]
    else:
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["memory"]["argument_bytes"] > 0
        assert rec["ops"]["dot_flops"] > 0 and rec["cost"]["flops"] > 0
    again = dryrun.run_cell(arch, "train_4k", "single", str(tmp_path))
    assert again == json.loads(json.dumps(rec))     # read back, not rerun


def test_run_cell_records_a_hybrid_cell_with_its_status(tmp_path):
    """zamba2-7b's decode (13 shared attention blocks between 81 Mamba2
    blocks) on 256 ranks: ``ok``, with the bytes it holds and its FLOPs
    (the scan's step runs on each rank's rows and heads)."""
    rec = dryrun.run_cell("zamba2-7b", "decode_32k", "single", str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["kind"] == "decode"
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["ops"]["dot_flops"] > 0


def test_main_writes_a_record_with_the_jax_keys(tmp_path):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    with open(tmp_path / "tinyllama-1.1b__train_4k__single.json") as f:
        rec = json.load(f)
    assert JAX_KEYS <= set(rec) and rec["status"] == "ok"
    assert rec["chips"] == 256 and rec["tokens_per_step"] == 256 * 4096
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    ops = rec["ops"]
    assert rec["cost"] == {"flops": ops["dot_flops"],
                           "bytes_accessed": ops["traffic_bytes_naive"]}
    assert set(op_analysis.COLLECTIVES) <= set(ops["collective_bytes"])
    assert rec["traced_on"] == dryrun.traced_on() and rec["trace_s"] > 0
    assert dryrun.DEFAULT_OUT != os.path.join("artifacts", "dryrun")


def test_hinted_train_step_folds_no_split_middle_dim(monkeypatch):
    """Under the ``hidden`` hint the sequence is split over tp; every
    product and its backward must gather it before folding it (torch 2.11
    refuses such a fold, 2.13 makes a strided shard of it): the hinted
    train step makes no strided shard."""
    from torch.distributed.tensor import placement_types
    made = []
    init = placement_types._StridedShard.__init__

    def spy(self, *args, **kwargs):
        made.append(args)
        init(self, *args, **kwargs)
    monkeypatch.setattr(placement_types._StridedShard, "__init__", spy)
    cfg = registry.get("tinyllama-1.1b", reduced=True)
    with countgroup.world(4):
        mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
        rules = shd.Rules.for_mesh(mesh)
        assert dryrun._act_specs(cfg, mesh, rules, 8, seq_len=16)[
            "hidden"] == shd.P("data", "model", None)
        dryrun.trace_cell(cfg, ShapeCell("train", 16, 8, "train"), mesh, rules)
    assert made == []


@pytest.mark.parametrize("arch,edit", [
    ("rwkv6-3b", {"rwkv": {"head_dim": 32}}),
    ("zamba2-7b", {"ssm": {"head_dim": 64}})])
def test_hinted_step_cuts_no_head_when_tp_exceeds_the_heads(arch, edit,
                                                            monkeypatch):
    """2 heads over a 4-way ``model`` axis: the head projections gather
    their columns and the head merge gathers its gradient before the
    backward cuts it into heads (torch 2.11 refuses to cut a split dim,
    2.13 makes a strided shard or refuses as well): the hinted train step
    traces and makes no strided shard."""
    from torch.distributed.tensor import placement_types
    made = []
    init = placement_types._StridedShard.__init__

    def spy(self, *args, **kwargs):
        made.append(args)
        init(self, *args, **kwargs)
    monkeypatch.setattr(placement_types._StridedShard, "__init__", spy)
    cfg = R._cfg(arch, edit)
    with countgroup.world(4):
        mesh = make_mesh((1, 4), ("data", "model"), devices="cpu")
        ops = dryrun.trace_cell(cfg, ShapeCell("train", 16, 8, "train"),
                                mesh, shd.Rules.for_mesh(mesh))
    assert ops["dot_flops"] > 0 and made == []


def test_adamw8bit_updates_a_param_whose_shards_split_a_block():
    """192 columns over 2 ranks are 1.5 blocks of 64 each: the update
    gathers them before blocking (the 8-bit state's block dim replicates),
    as llama3-405b's 128256-column head over 16 needs."""
    from repro_torch.launch import specs as SP
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.quantized import adamw8bit_init, adamw8bit_update
    with countgroup.world(2):
        mesh = make_mesh((2,), ("model",), devices="cpu")
        spec = shd.P(None, "model")
        with FakeTensorMode():
            p = {"w": empty(4, 192, device_mesh=mesh.device_mesh,
                            placements=shd.placements(spec, mesh))}
            cfg = AdamWConfig()
            state = adamw8bit_init(p, cfg)
            specs = SP.opt_state_pspecs(state, {"w": spec}, mesh,
                                        shd.Rules.for_mesh(mesh))
            assert shd.spec_of(state["m"]["w"]["q"]) == specs["m"]["w"]["q"]
            new_p, new_state, _ = adamw8bit_update(p, state, p, 1e-3, cfg)
    assert new_p["w"].placements == p["w"].placements
    assert new_state["m"]["w"]["q"].placements == \
        state["m"]["w"]["q"].placements
