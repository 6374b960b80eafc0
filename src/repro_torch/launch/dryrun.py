"""The multi-pod dry run: for each (architecture x shape x mesh) cell, what
one rank of a 256- or 512-card job computes, moves and holds, without a
card and without allocating the model.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k --mesh single            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # every cell

The JAX package's ``launch/dryrun.py`` lowers and compiles each step
against ``ShapeDtypeStruct``s on 512 forced host devices and reads the
compiled program. The port has no compiler to ask, so it runs the REAL
step functions (``make_train_step``, ``prefill``, ``decode_step``) on
fake tensors (``FakeTensorMode``: shapes and dtypes, no memory), as rank 0
of a world of 256 or 512 ranks that exists in this process only
(``distributed/countgroup.py``: collectives are counted, nothing is
sent). The state, parameters and batch are fake DTensors placed on the
production mesh by the ported rules, each holding rank 0's shard; DTensor
plans every redistribution as it would in the real job. The step runs
under the activation hints (``distributed/api.py``) and inside
``launch.op_analysis``, which counts what rank 0 executes.

Each cell's record keeps the JAX record's keys (``arch``, ``shape``,
``mesh``, ``kind``, ``chips``, ``tokens_per_step``, ``status``,
``memory``, ``cost``, ``error``, ``traceback``, ``total_s``) with three
changes: ``ops`` (``op_analysis.analyze``'s dict, the keys of
``hlo_analysis.analyze`` and more) takes the place of ``hlo``;
``trace_s`` takes the place of ``lower_s`` and ``compile_s``; and
``traced_on`` names the fake device whose code path was traced: ``cuda``
where torch has a card, else ``cpu``. The two paths differ (on the CPU,
``layers.bmm_f32`` casts its operands to f32 first; on the card it sums
bf16 operands in f32), so every number is a prediction for the path it
names. ``cost.flops`` is ``ops.dot_flops`` and ``cost.bytes_accessed`` is
``ops.traffic_bytes_naive``: the same count, under JAX's names. A cell
that raises (a DTensor rule missing, a host read of a fake value) is
recorded with its error and the sweep goes on; the exit code is 1 if any
cell erred. Records go to ``--out`` (``artifacts/dryrun_torch``), never
to the JAX dry run's directory, whose reader would take them for its own.

The JAX dry run's build options are the port's too, with its defaults:
``run_cell(..., optimizer=, grad_compression=, microbatches=, remat=)``
(no CLI flag, as in JAX) passes them to :func:`build_cell_fn` and names
the record ``arch__shape__mesh__k-v_k-v`` (:func:`cell_tag`), the JAX
record's name letter for letter.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.configs.base import applicable_shapes
from repro_torch.distributed import countgroup
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.api import activation_specs
from repro_torch.launch import op_analysis
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import decode_step, prefill
from repro_torch.train.train_step import TrainConfig, make_train_step

P = shd.P
DEFAULT_OUT = os.path.join("artifacts", "dryrun_torch")


def traced_on() -> str:
    """The device type whose code path the dry run traces: the card's
    where torch has one, else the CPU's."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _act_specs(cfg, mesh, rules, global_batch, seq_len=None) -> dict:
    """The activation hints of a cell, as the JAX dry run sets them:
    logits over the batch axes and tp on the vocab; the hidden state over
    the batch axes and, for the dense, vlm and audio families, tp on the
    sequence (Megatron sequence parallelism; the Mamba convs and scans
    and the MoE's row-local dispatch need the whole sequence); the MoE
    staging buffer over the batch axes."""
    ba = shd.batch_axes(mesh, rules, global_batch)
    tp = shd._fit(mesh, rules.tp, cfg.vocab)
    seq_tp = (shd._fit(mesh, rules.tp, seq_len)
              if seq_len and cfg.family in ("dense", "vlm", "audio")
              else None)
    specs = {"logits": P(ba, None, tp), "hidden": P(ba, seq_tp, None)}
    if cfg.moe is not None:
        specs["moe_buf"] = P(ba, None, None, None)
    return specs


def _with_hints(fn, specs):
    def wrapped(*a, **k):
        with activation_specs(specs):
            return fn(*a, **k)
    return wrapped


def tokens_of(cell) -> int:
    if cell.kind == "decode":
        return cell.global_batch
    return cell.global_batch * cell.seq_len


def _placed(shapes, specs, mesh):
    """A DTensor of each stand-in's shape and dtype, placed on ``mesh`` as
    its spec says; this rank allocates its own shard only (inside a
    ``FakeTensorMode``, nothing)."""
    from torch.distributed.tensor import empty

    return T.tree_map(lambda m, s: empty(
        tuple(m.shape), dtype=m.dtype, device_mesh=mesh.device_mesh,
        placements=shd.placements(s, mesh)), shapes, specs)


def decode_rules(cfg, mesh) -> shd.Rules:
    """Weight-stationary serving rules (the JAX dry run's): weight columns
    shard over the COMBINED (data x model) axes so no weight is ever
    gathered; the KV cache keeps batch on "pod" (if any) and seq/heads on
    tp. Where the combined axes do not divide the query heads, the JAX
    rules raise (``sharding._head_aligned``'s mesh/head mismatch: every
    KV-cache model of the registry at 256 ranks); the port then takes
    the largest trailing group of them that does (``model`` alone for 32
    heads on 16 x 16), so that the decode step runs."""
    tp = shd._fit(mesh, ("data", "model"), cfg.n_heads) or ("data", "model")
    return shd.Rules(tp=tp, fsdp=(),
                     dp=("pod",) if "pod" in mesh.axis_names else ())


def train_config(cfg, mesh, *, optimizer=None, grad_compression=None,
                 microbatches=1) -> TrainConfig:
    """The train config of a dry-run cell, as the JAX dry run builds it:
    the optimizer by default 8-bit AdamW for llama3-405b and AdamW for the
    others; under gradient compression one error-feedback slice for each
    ``pod`` of the mesh (1 without a ``pod`` axis)."""
    opt = optimizer or ("adamw8bit" if cfg.arch_id.startswith("llama3-405b")
                        else "adamw")
    n_pods = mesh.shape.get("pod", 1)
    return TrainConfig(optimizer=opt, microbatches=microbatches,
                       grad_compression=grad_compression,
                       n_pods=n_pods if grad_compression else 1)


def build_step(cfg, cell, mesh, rules, *, optimizer=None,
               grad_compression=None, microbatches=1):
    """Returns (step under the hints, (state, batch) placed on ``mesh``),
    with the JAX dry run's options and defaults (:func:`train_config`)."""
    if cell.kind != "train":
        raise ValueError(f"build_step builds train cells, not {cell.kind}")
    tcfg = train_config(cfg, mesh, optimizer=optimizer,
                        grad_compression=grad_compression,
                        microbatches=microbatches)
    step = _with_hints(make_train_step(cfg, tcfg),
                       _act_specs(cfg, mesh, rules, cell.global_batch,
                                  seq_len=cell.seq_len))
    return step, train_args(cfg, tcfg, cell, mesh, rules)


def train_args(cfg, tcfg, cell, mesh, rules) -> tuple:
    """(train state, batch) of a train cell placed on ``mesh`` by
    ``train_state_pspecs`` and ``batch_specs``: the placements
    ``launch.train.build_on_mesh`` gives them."""
    state_shapes = SP.train_state_shapes(cfg, tcfg)
    state_specs = SP.train_state_pspecs(cfg, mesh, rules, state_shapes)
    bspecs = shd.batch_specs(cfg, mesh, rules, global_batch=cell.global_batch)
    return (_placed(state_shapes, state_specs, mesh),
            _placed(SP.input_specs(cfg, cell), bspecs, mesh))


def build_cell_fn(cfg, cell, mesh, rules, *, optimizer=None,
                  grad_compression=None, microbatches=1, remat=None):
    """Unified builder: returns (fn, args placed on ``mesh``). Call it, and
    the fn, inside one ``FakeTensorMode`` for a shape-only run. ``remat``
    replaces ``cfg.remat`` for every kind of cell; the other options are
    :func:`build_step`'s."""
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if cell.kind == "train":
        return build_step(cfg, cell, mesh, rules, optimizer=optimizer,
                          grad_compression=grad_compression,
                          microbatches=microbatches)

    if cell.kind == "decode":
        rules = decode_rules(cfg, mesh)
    params = SP.params_shapes(cfg)
    pspecs = shd.param_pspecs(params, mesh, rules, cfg=cfg)
    state_shapes = SP.decode_state_shapes(cfg, cell.global_batch,
                                          cell.seq_len)
    state_specs = shd.decode_state_pspecs(cfg, mesh, rules, state_shapes,
                                          batch=cell.global_batch)
    batch = SP.input_specs(cfg, cell)
    ba = shd.batch_axes(mesh, rules, cell.global_batch)
    acts = _act_specs(cfg, mesh, rules, cell.global_batch,
                      seq_len=cell.seq_len if cell.kind == "prefill"
                      else None)
    if cell.kind == "prefill":
        fn = _with_hints(lambda p, s, b: prefill(p, cfg, s, b), acts)
        bspecs = shd.batch_specs(cfg, mesh, rules,
                                 global_batch=cell.global_batch)
        bspecs.pop("labels")
        batch = {k: v for k, v in batch.items() if k != "labels"}
    else:
        acts = {"logits": P(ba, None, shd._fit(mesh, rules.tp, cfg.vocab)),
                "hidden": P(ba, None, None)}
        fn = _with_hints(lambda p, s, b: decode_step(p, cfg, s, b), acts)
        if cfg.input_mode == "tokens":
            bspecs = {"inputs": P(ba, None)}
        else:
            bspecs = {"inputs": P(ba, None, None)}
    return fn, (_placed(params, pspecs, mesh),
                _placed(state_shapes, state_specs, mesh),
                _placed(batch, bspecs, mesh))


def trace_cell(cfg, cell, mesh, rules, **build_kw) -> dict:
    """``build_cell_fn`` (with ``build_kw``, its options) and one call of
    its fn on fake tensors inside ``op_analysis.analyze``: the analysis
    dict, with ``trace_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = build_cell_fn(cfg, cell, mesh, rules, **build_kw)
    t0 = time.time()
    _, ops = op_analysis.analyze(fn, *args)
    return dict(ops, trace_s=time.time() - t0)


def cell_tag(arch_id: str, shape_name: str, mesh_kind: str,
             **build_kw) -> str:
    """A record's name, the JAX dry run's letter for letter:
    ``arch__shape__mesh``, then ``__k-v_k-v`` of the options by name."""
    tag = f"{arch_id}__{shape_name}__{mesh_kind}"
    if build_kw:
        tag += "__" + "_".join(f"{k}-{v}" for k, v in sorted(build_kw.items()))
    return tag


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, force: bool = False, **build_kw) -> dict:
    """Trace one cell (``build_kw``: :func:`build_cell_fn`'s options) and
    write its record to ``out_dir``, under :func:`cell_tag`'s name; a
    record already there is read back unless ``force``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        cell_tag(arch_id, shape_name, mesh_kind, **build_kw)
                        + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = registry.get(arch_id)
    cell = next(c for c in applicable_shapes(cfg) if c.name == shape_name)
    multi = mesh_kind == "multi"
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
           "kind": cell.kind, "chips": 512 if multi else 256,
           "tokens_per_step": tokens_of(cell), "status": "error",
           "traced_on": traced_on()}
    t0 = time.time()
    try:
        with countgroup.world(rec["chips"]):
            mesh = make_production_mesh(multi_pod=multi,
                                        devices=rec["traced_on"])
            rules = shd.Rules.for_mesh(
                mesh, fsdp_over_pod=arch_id.startswith("llama3-405b"))
            ops = trace_cell(cfg, cell, mesh, rules, **build_kw)
        rec["trace_s"] = ops.pop("trace_s")
        rec["memory"] = {k: ops[k] for k in (
            "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes")}
        rec["cost"] = {"flops": ops["dot_flops"],
                       "bytes_accessed": ops["traffic_bytes_naive"]}
        rec["ops"] = ops
        rec["status"] = "ok"
    except Exception as e:  # recorded, not raised: the sweep continues
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = time.time() - t0
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summary(rec: dict) -> str:
    """One line for a record, as the JAX dry run prints it, with the
    traced device."""
    if rec["status"] != "ok":
        return rec.get("error", "?")
    m = rec["memory"]
    return (f"mem={m['argument_bytes'] / 2**30:.2f}GiB "
            f"temp={m['temp_bytes'] / 2**30:.2f}GiB "
            f"flops={rec['cost']['flops']:.3g} "
            f"(traced on {rec['traced_on']})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = (registry.ARCH_IDS if (args.all or args.arch is None)
             else [args.arch])
    meshes = (["single", "multi"] if args.mesh == "both" or args.all
              else [args.mesh])
    n_ok = n_err = 0
    for arch in archs:
        cells = applicable_shapes(registry.get(arch))
        names = [c.name for c in cells]
        shapes = names if (args.all or args.shape is None) else [args.shape]
        for shape in shapes:
            if shape not in names:
                print(f"[skip] {arch} x {shape} (inapplicable)")
                continue
            for mk in meshes:
                rec = run_cell(arch, shape, mk, args.out, force=args.force)
                ok = rec["status"] == "ok"
                n_ok += ok
                n_err += (not ok)
                print(f"[{'ok' if ok else 'ERR'}] {arch} x {shape} x {mk}: "
                      f"{summary(rec)}", flush=True)
    print(f"done: {n_ok} ok, {n_err} errors")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
