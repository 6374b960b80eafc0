"""Rank bodies of tests/test_torch_multidevice.py,
tests/test_torch_mesh_families.py and of the on-card mesh tests in
tests/test_torch_cuda.py: each runs in every process of a local
job (``repro_torch.launch.local_ranks``), imports no JAX, and returns a
JSON-able result; rank 0 writes tensors to ``.npz`` files for the test.

Params arrive as an ``.npz`` of the JAX package's initial parameters
(keys: leaf paths joined by "/"), so every world starts from the same
model as the JAX reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch import tree as T
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.distributed import hoststaged
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.elastic import reshard_tree, replicate_tree
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import params_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

BATCH, SEQ = 8, 16
# the JAX multidevice test's train configs
PLAIN = TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50)
COMPRESSED = TrainConfig(peak_lr=3e-3, warmup_steps=3, total_steps=60,
                         adamw=AdamWConfig(weight_decay=0.0),
                         grad_compression="int8_ef", n_pods=2)


def _cfg(arch: str = "tinyllama-1.1b", edit: dict | None = None):
    """The reduced config of ``arch`` with the fields of ``edit`` replaced
    (a dict value replaces fields of that sub-config, e.g. ``{"rwkv":
    {"head_dim": 32}}``)."""
    cfg = registry.get(arch, reduced=True)
    for field, value in (edit or {}).items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, field), **value)
        cfg = dataclasses.replace(cfg, **{field: value})
    return cfg


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *head, last = key.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _setup(mesh, params_npz: str, tcfg: TrainConfig, seed: int, device: str,
           arch: str = "tinyllama-1.1b", edit: dict | None = None):
    """(cfg, state placed by the JAX rules, loader placing batches, step,
    state specs)."""
    cfg = _cfg(arch, edit)
    with np.load(params_npz) as f:
        params = params_from_numpy(_nest(dict(f)), cfg, device)
    rules = shd.Rules.for_mesh(mesh)
    specs = SP.train_state_pspecs(cfg, mesh, rules,
                                  SP.train_state_shapes(cfg, tcfg))
    placed = T.tree_map(lambda x, s: shd.place(x, mesh, s), params,
                        specs["params"])
    loader = ShardedLoader(cfg, DataConfig(seed=seed), batch=BATCH, seq=SEQ,
                           device=device, shardings=shd.named(
                               mesh, shd.batch_specs(cfg, mesh, rules,
                                                     global_batch=BATCH)))
    return (cfg, init_train_state(placed, tcfg), loader,
            make_train_step(cfg, tcfg), specs)


def _save_rank0(path: str, **arrays) -> None:
    if dist.get_rank() == 0:
        np.savez(path, **{k: v.detach().cpu().numpy()
                          for k, v in arrays.items()})


def _placed_as(state, specs) -> bool:
    return all(shd.spec_of(x) == s for x, s in
               zip(T.leaves(state), T.leaves_up_to(state, specs)))


def debug_mesh_steps(params_npz: str, out_npz: str, ckpt_dir: str,
                     device: str = "cpu") -> dict:
    """On ``make_debug_mesh((2, 4))``: the state placed by
    ``train_state_pspecs`` (init included), one step (ce, ``lm_head/w``),
    a checkpoint of its state, a second step (the elastic reference), and
    ``reshard_tree`` to (4, 2) and back / ``replicate_tree`` bit for bit."""
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh((2, 4), devices=device)
    cfg, state, loader, step, specs = _setup(mesh, params_npz, PLAIN, 1,
                                             device)
    out = {"placed": _placed_as(state, specs)}
    s1, m1 = step(state, loader.get(0))
    out["ce"] = float(m1["ce"])
    out["placed_after"] = _placed_as(s1, specs)
    _save_rank0(out_npz, lm_head=s1["params"]["lm_head"]["w"].full_tensor())
    ckpt.save(ckpt_dir, 0, s1)
    _, m2 = step(s1, loader.get(1))
    out["ce_next"] = float(m2["ce"])
    # elastic, live: to (4, 2) and back, and replicated
    other = make_mesh((4, 2), ("data", "model"), devices=device)
    specs42 = SP.train_state_pspecs(cfg, other, shd.Rules.for_mesh(other),
                                    SP.train_state_shapes(cfg, PLAIN))
    moved = reshard_tree(s1, other, specs42)
    back = reshard_tree(moved, mesh, specs)
    out["round_trip"] = _placed_as(moved, specs42) and all(
        torch.equal(a.to_local(), b.to_local())
        for a, b in zip(T.leaves(s1), T.leaves(back)))
    rep = replicate_tree(s1, mesh)
    out["replicated"] = all(
        torch.equal(r.to_local(), a.full_tensor())
        for r, a in zip(T.leaves(rep), T.leaves(s1)))
    return out


def elastic_restore(ckpt_dir: str, device: str = "cpu") -> dict:
    """The checkpoint of :func:`debug_mesh_steps` restored onto (2, 2) by
    the JAX rules, and the next step's ce."""
    mesh = make_mesh((2, 2), ("data", "model"), devices=device)
    cfg = _cfg()
    rules = shd.Rules.for_mesh(mesh)
    shapes = SP.train_state_shapes(cfg, PLAIN)
    specs = SP.train_state_pspecs(cfg, mesh, rules, shapes)
    state, manifest = ckpt.restore(ckpt_dir, shapes,
                                   shardings=shd.named(mesh, specs))
    loader = ShardedLoader(cfg, DataConfig(seed=1), batch=BATCH, seq=SEQ,
                           device=device, shardings=shd.named(
                               mesh, shd.batch_specs(cfg, mesh, rules,
                                                     global_batch=BATCH)))
    _, m = make_train_step(cfg, PLAIN)(state, loader.get(1))
    return {"ce": float(m["ce"]), "step": manifest["step"],
            "placed": _placed_as(state, specs)}


def compressed_steps(params_npz: str, out_npz: str, steps: int,
                     device: str = "cpu", shape: list = (2, 2, 2),
                     head_after: int = 0) -> dict:
    """int8_ef over 2 pods on ``shape`` (pod 2, data, model): ``steps``
    steps' ce and grad_norm, ``lm_head/w`` after step ``head_after`` (from
    0), and the collectives staged in the first step (the pods' int8
    all-reduce among them)."""
    mesh = make_mesh(tuple(shape), ("pod", "data", "model"), devices=device)
    _, state, loader, step, specs = _setup(mesh, params_npz, COMPRESSED, 2,
                                           device)
    out = {"placed": _placed_as(state, specs), "ce": [], "grad_norm": []}
    for i in range(steps):
        hoststaged.reset_stats()
        state, m = step(state, loader.get(i))
        out["ce"].append(float(m["ce"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            out["staged"] = dict(hoststaged.STATS)
        if i == head_after:
            _save_rank0(out_npz,
                        lm_head=state["params"]["lm_head"]["w"].full_tensor())
    out["placed_after"] = _placed_as(state, specs)
    return out


def mesh_step(params_npz: str, out_npz: str, shape: list, steps: int,
              device: str = "cpu") -> dict:
    """``steps`` steps on ``shape`` (data, model) from the JAX initial
    parameters: the process group's backend, each step's ce, grad_norm and
    the collectives counted in it, and a digest of every replicated leaf's
    bits after the last (equal on every rank when each all-reduce gives
    every rank the same bits); rank 0 writes ``lm_head/w`` after the last
    step to ``out_npz``."""
    import hashlib
    mesh = make_mesh(tuple(shape), ("data", "model"), devices=device)
    _, state, loader, step, _ = _setup(mesh, params_npz, PLAIN, 1, device)
    out = {"backend": dist.get_backend(), "ce": [], "grad_norm": [],
           "staged": []}
    for i in range(steps):
        hoststaged.reset_stats()
        state, m = step(state, loader.get(i))
        out["ce"].append(float(m["ce"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["staged"].append(dict(hoststaged.STATS))
    digest = hashlib.sha256()
    for x in T.leaves(state):
        if all(isinstance(p, Replicate) for p in x.placements):
            digest.update(x.to_local().detach().cpu().numpy().tobytes())
    _save_rank0(out_npz, lm_head=state["params"]["lm_head"]["w"].full_tensor())
    out["replicated"] = digest.hexdigest()
    return out


def chunked_collectives(slot_bytes: int, device: str = "cpu") -> dict:
    """Collectives of operands larger than the slot on a peer-memory group
    made with a slot of ``slot_bytes``, against the same collectives on a
    gloo group and against the rank-order result computed here from every
    rank's input (each rank draws them all from seeds). Returns
    {check: passed} and the all-reduce's digest (equal on every rank)."""
    import hashlib

    from repro_torch.distributed import peermem
    r, n = dist.get_rank(), dist.get_world_size()
    ranks = list(range(n))
    peermem.register()
    pm = dist.new_group(ranks, backend="peermem",
                        pg_options=peermem.Options(device=device,
                                                   slot_bytes=slot_bytes))
    gloo = dist.new_group(ranks, backend="gloo")
    dev = torch.device(device)
    elems = 7 * slot_bytes // 8          # 3.5 slots of f32

    def normal(rank):
        g = torch.Generator().manual_seed(100 + rank)
        return torch.randn(elems, generator=g).to(dev)

    def ints(rank, dtype):
        # integers: any order of the sum gives the same bits; int8 wraps
        g = torch.Generator().manual_seed(200 + rank)
        return torch.randint(-100, 100, (elems,), generator=g).to(dev, dtype)

    def both(fn, make):
        a, b = make(), make()
        fn(a, group=pm)
        fn(b, group=gloo)
        return a, b

    ok = {}
    peermem.reset_stats()
    x = normal(r)
    dist.all_reduce(x, group=pm)
    rounds = peermem.MOVED["rounds"]
    want = normal(0)
    for i in range(1, n):
        want += normal(i)
    ok["all_reduce f32 == rank-order sum"] = torch.equal(x, want)
    ok["all_reduce in 4 rounds"] = rounds == 4
    for dt in (torch.float32, torch.int8):
        a, b = both(dist.all_reduce, lambda: ints(r, dt))
        ok[f"all_reduce {dt} == gloo"] = torch.equal(a, b)
    a, b = both(lambda t, group: dist.all_reduce(
        t, op=dist.ReduceOp.MAX, group=group), lambda: normal(r))
    ok["all_reduce max == gloo"] = torch.equal(a, b)
    outs = [torch.empty(elems * n, device=dev) for _ in range(2)]
    dist.all_gather_into_tensor(outs[0], normal(r), group=pm)
    dist.all_gather_into_tensor(outs[1], normal(r), group=gloo)
    ok["all_gather == gloo"] = torch.equal(outs[0], outs[1]) and \
        torch.equal(outs[0], torch.cat([normal(i) for i in ranks]))
    outs = [torch.empty(elems // n, device=dev) for _ in range(2)]
    for o, g in zip(outs, (pm, gloo)):
        dist.reduce_scatter_tensor(o, ints(r, torch.float32)[:o.numel() * n],
                                   group=g)
    ok["reduce_scatter == gloo"] = torch.equal(*outs)
    # uneven splits: rank r sends (i + r + 1) x 1000 rows of 3 to rank i
    sends = [[(i + q + 1) * 1000 for i in ranks] for q in ranks]
    rows = torch.arange(sum(sends[r]) * 3, device=dev,
                        dtype=torch.float32).reshape(-1, 3) + 1e6 * r
    got = []
    for g in (pm, gloo):
        o = torch.empty(sum(sends[q][r] for q in ranks), 3, device=dev)
        dist.all_to_all_single(o, rows, [s[r] for s in sends], sends[r],
                               group=g)
        got.append(o)
    ok["all_to_all uneven == gloo"] = torch.equal(*got)
    a, b = both(lambda t, group: dist.broadcast(t, src=1, group=group),
                lambda: normal(r))
    ok["broadcast == gloo"] = torch.equal(a, b) and torch.equal(a, normal(1))
    outs = [torch.empty(elems, device=dev) for _ in range(2)]
    for o, g in zip(outs, (pm, gloo)):
        dist.scatter(o, [normal(i) for i in ranks] if r == 0 else None,
                     src=0, group=g)
    ok["scatter == gloo"] = torch.equal(*outs) and torch.equal(outs[0],
                                                               normal(r))
    # a group of one (a mesh axis of size 1): the root scatters to itself
    solo = [dist.new_group([i], backend="peermem", pg_options=peermem.Options(
        device=device, slot_bytes=slot_bytes)) for i in ranks][r]
    o = torch.empty(elems, device=dev)
    dist.scatter(o, [normal(r)], src=r, group=solo)
    ok["scatter on a group of one"] = torch.equal(o, normal(r))
    a, b = both(lambda t, group: dist.all_reduce(
        t, op=dist.ReduceOp.AVG, group=group), lambda: ints(r, torch.float32))
    ok["all_reduce avg == gloo"] = torch.equal(a, b)
    try:
        dist.all_reduce(normal(r), op=dist._make_nccl_premul_sum(2.0),
                        group=pm)
        ok["premul_sum raises"] = False
    except ValueError:
        ok["premul_sum raises"] = True
    return {"ok": ok, "digest": hashlib.sha256(
        x.cpu().numpy().tobytes()).hexdigest()}


def host_traffic(device: str = "cuda") -> dict:
    """Collectives of CUDA tensors under ``torch.profiler``: the backend
    joined, the memcpy events between host and device, and the pinned
    host allocator's counters that grew."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed import hoststaged as hs
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    x = torch.arange(4096 * n, device=dev, dtype=torch.float32) + r
    out = torch.empty(4096 * n * n, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.host_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dist.all_reduce(x)
        dist.all_gather_into_tensor(out, x)
        dist.reduce_scatter_tensor(x[:4096], x.clone())
        dist.all_to_all_single(x.clone(), x)
        torch.cuda.synchronize()
    after = torch.cuda.host_memory_stats()
    copies = [e.name for e in prof.events()
              if "Memcpy" in e.name and ("DtoH" in e.name or "HtoD" in e.name)]
    grew = {k: v - before.get(k, 0) for k, v in after.items()
            if (k.endswith(".allocated") or k == "num_host_alloc")
            and v != before.get(k, 0)}
    return {"backend": dist.get_backend(), "copies": len(copies),
            "pinned": grew, "probe": hs.probe(device)}


def spec_round_trip(device: str = "cpu") -> list:
    """``spec_of(place(x, mesh, spec)) == spec`` for specs of one axis, two
    axes on one dim, and none, on (pod 2, data 2, model 2)."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=device)
    x = torch.arange(8 * 8 * 4, dtype=torch.float32).reshape(8, 8, 4)
    out = []
    for spec in (shd.P(("pod", "data"), "model", None),
                 shd.P(None, ("data", "model"), None), shd.P("pod", None),
                 shd.P(None, None, "model"), shd.P()):
        y = shd.place(x, mesh, spec)
        out.append(shd.spec_of(y) == shd.P(*spec, *(None,) * (3 - len(spec)))
                   and torch.equal(y.full_tensor(), x))
    return out


def launcher_on_mesh(argv: list, shape: list, device: str = "cpu") -> dict:
    """``launch.train.train_on_mesh`` over ``make_debug_mesh(shape)`` (the
    body of ``--mesh production`` once the mesh is built): each step's ce,
    rank 0's two report lines, and a second call on the same checkpoint
    directory, which resumes at its last step and takes none."""
    import contextlib
    import io

    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(tuple(shape), devices=device)
    args = train.parse_args(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        first = train.train_on_mesh(args, mesh)
        again = train.train_on_mesh(args, mesh)
    return {"ce": [h["ce"] for h in first.history],
            "resumed": len(again.history), "lines": out.getvalue()}


def optimizer_state_placements(optimizer: str, device: str = "cpu") -> dict:
    """Two steps of ``optimizer`` on (data 2, model 2) from the launcher's
    build: whether the state is placed by ``train_state_pspecs`` before
    the steps, the leaves that are not after them, and each step's ce."""
    from repro_torch.launch import train
    mesh = make_mesh((2, 2), ("data", "model"), devices=device)
    args = train.parse_args(["--arch", "tinyllama-1.1b", "--reduced",
                             "--device", device, "--batch", str(BATCH),
                             "--seq", str(SEQ), "--optimizer", optimizer])
    s = train.build_on_mesh(args, mesh)
    specs = SP.train_state_pspecs(s.cfg, mesh, shd.Rules.for_mesh(mesh),
                                  SP.train_state_shapes(s.cfg, s.tcfg))
    state, ces = s.state, []
    for i in range(2):
        state, m = s.step(state, s.loader.get(i))
        ces.append(float(m["ce"]))
    bad = [shd.path_str(p) for (p, x), spec in zip(
        T.leaves_with_path(state), T.leaves_up_to(state, specs))
        if any(not isinstance(pl, (Replicate, Shard)) for pl in x.placements)
        or shd.spec_of(x) != spec]
    return {"before": _placed_as(s.state, specs), "after_bad": bad,
            "ce": ces}


def staged_steps(device: str = "cpu") -> dict:
    """On (data 2, model 2), ranks on the host-staged backend: the
    launcher's build (``build_on_mesh``, reduced tinyllama, batch 8 x 16)
    and one step from its state, without hints and under the dry run's
    activation hints; each step's loss, ce and the collectives this rank
    staged in it."""
    from repro_torch.launch import dryrun, train
    mesh = make_mesh((2, 2), ("data", "model"), devices=device)
    args = train.parse_args(["--arch", "tinyllama-1.1b", "--reduced",
                             "--device", device, "--batch", str(BATCH),
                             "--seq", str(SEQ)])
    s = train.build_on_mesh(args, mesh)
    batch = s.loader.get(0)
    hints = dryrun._act_specs(s.cfg, mesh, shd.Rules.for_mesh(mesh), BATCH,
                              seq_len=SEQ)
    out = {}
    for what, step in (("plain", s.step),
                       ("hinted", dryrun._with_hints(s.step, hints))):
        hoststaged.reset_stats()
        _, m = step(s.state, batch)
        staged = dict(hoststaged.STATS)
        out[what] = {"loss": float(m["loss"]), "ce": float(m["ce"]),
                     "staged": staged}
    return out


def family_steps(cases: list, out_npz: str, steps: int, checks: list = (),
                 device: str = "cpu") -> dict:
    """``steps`` sharded steps of each case (a dict: ``name``, ``arch``,
    ``edit`` of its reduced config, mesh ``shape`` over ("data", "model")
    and the ``params`` ``.npz`` of its JAX initial parameters), every case
    in this one world: each step's ce and grad_norm, and whether the state
    is placed by ``train_state_pspecs`` before and after them. Rank 0
    writes each case's ``lm_head/w`` after the last step to ``out_npz``
    under the case's name. Then each of ``checks`` (a dict: ``name``,
    ``fn``, the name of a rank body here, and its keyword arguments), under
    its name."""
    out, heads = {}, {}
    for check in checks:
        kw = {k: v for k, v in check.items() if k not in ("name", "fn")}
        out[check["name"]] = globals()[check["fn"]](device=device, **kw)
    for case in cases:
        mesh = make_mesh(tuple(case["shape"]), ("data", "model"),
                         devices=device)
        _, state, loader, step, specs = _setup(
            mesh, case["params"], PLAIN, 1, device, case["arch"],
            case.get("edit"))
        row = {"ce": [], "grad_norm": [], "placed": _placed_as(state, specs)}
        for i in range(steps):
            state, m = step(state, loader.get(i))
            row["ce"].append(float(m["ce"]))
            row["grad_norm"].append(float(m["grad_norm"]))
        row["placed"] = row["placed"] and _placed_as(state, specs)
        out[case["name"]] = row
        heads[case["name"]] = state["params"]["lm_head"]["w"].full_tensor()
    _save_rank0(out_npz, **heads)
    return out


def moe_ffn_on_mesh(shape: list, seed: int, capacity_factor: float,
                    device: str = "cpu") -> dict:
    """``mlp.moe_ffn`` of reduced deepseek-moe-16b's first layer (the
    port's own seeded init, 2 shared experts, ``capacity_factor``) on
    DTensors placed by the JAX rules over ``shape``
    (data, model), against the same call on plain tensors: the largest
    |diff| of the output, the aux loss and every gradient (of x and each
    parameter, through ``moe_aux`` and a seeded cotangent), each over the
    plain value's largest |value|."""
    from repro_torch.models import init_params
    from repro_torch.models import mlp
    cfg = _cfg("deepseek-moe-16b",
               {"moe": {"capacity_factor": capacity_factor}})
    mesh = make_mesh(tuple(shape), ("data", "model"), devices=device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device)
    specs = shd.param_pspecs(params, mesh, shd.Rules.for_mesh(mesh), cfg=cfg)
    layer = T.tree_map(lambda x: x[0], params["layers"]["moe"])
    lspecs = T.tree_map(lambda s: shd.P(*tuple(s)[1:]),
                        specs["layers"]["moe"])
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((BATCH, SEQ, cfg.d_model),
                                             dtype=np.float32)).to(device)
    cot = torch.from_numpy(rng.standard_normal((BATCH, SEQ, cfg.d_model),
                                               dtype=np.float32)).to(device)
    xspec = shd.P(shd.batch_axes(mesh, shd.Rules.for_mesh(mesh), BATCH),
                  None, None)

    def run(p, xx, g):
        leaves = [t.detach().requires_grad_() for t in T.leaves(p)]
        xx = xx.detach().requires_grad_()
        with shd.plain_is_replicated(xx):
            out, probs, gate_e = mlp.moe_ffn(T.unflatten(p, leaves), xx,
                                             cfg.moe)
            aux = mlp.moe_aux(probs, gate_e, cfg.moe)
            grads = torch.autograd.grad((out * g).sum() + aux, [xx, *leaves])
        return [out, aux, *grads]

    plain = run(layer, x, cot)
    sharded = run(T.tree_map(lambda t, s: shd.place(t, mesh, s), layer,
                             lspecs),
                  shd.place(x, mesh, xspec), shd.place(cot, mesh, xspec))
    names = ["out", "aux", "x", *(shd.path_str(p) for p, _ in
                                  T.leaves_with_path(layer))]
    return _rel_diffs(names, sharded, plain)


def _rel_diffs(names, sharded, plain) -> dict:
    """Each DTensor's largest |diff| to its plain counterpart, over the
    plain value's largest |value|."""
    return {n: float((s.full_tensor().float() - p.float()).abs().max()
                     / max(float(p.float().abs().max()), 1e-30))
            for n, s, p in zip(names, sharded, plain)}


def scan_on_mesh(shape: list, seed: int, dtype: str,
                 device: str = "cpu") -> dict:
    """``linear_scan``'s chunked form (the per-channel decay with the RWKV
    bonus, and the scalar decay) and its step form on DTensors, rows over
    ``data`` and heads over ``model`` of ``shape`` (the bonus replicated,
    as the rules place RWKV's ``u``), with a carried state, against the
    same calls on plain tensors: the largest |diff| of each output and
    each gradient (seeded cotangents) over the plain value's largest
    |value|. T = 40 over chunks of 16 takes the padded path."""
    from repro_torch.models.linear_scan import (chunked_linear_attention,
                                                linear_attention_step)
    dt = getattr(torch, dtype)
    mesh = make_mesh(tuple(shape), ("data", "model"), devices=device)
    rng = np.random.default_rng(seed)
    b, t, h, k = 4, 40, 4, 8

    def draw(*dims, scale=1.0, f32=False):
        x = torch.from_numpy(scale * rng.standard_normal(dims)
                             .astype(np.float32)).to(device)
        return x if f32 else x.to(dt)
    x4, st, rows = shd.P("data", None, "model", None), \
        shd.P("data", "model", None, None), shd.P("data", "model", None)
    cases = {
        "rwkv": (chunked_linear_attention, dict(chunk=16),
                 [draw(b, t, h, k), draw(b, t, h, k), draw(b, t, h, k),
                  -torch.exp(draw(b, t, h, k, f32=True)).to(dt),
                  draw(b, h, k, k, f32=True), draw(h, k, scale=0.1)],
                 [x4, x4, x4, x4, st, shd.P(None, None)], True),
        "mamba": (chunked_linear_attention, dict(chunk=16, scalar_decay=True),
                  [draw(b, t, h, k), draw(b, t, h, k), draw(b, t, h, k),
                   -torch.exp(draw(b, t, h, f32=True)),
                   draw(b, h, k, k, f32=True)],
                  [x4, x4, x4, shd.P("data", None, "model"), st], False),
        "step": (linear_attention_step, {},
                 [draw(b, h, k), draw(b, h, k), draw(b, h, k),
                  -torch.exp(draw(b, h, k, f32=True)),
                  draw(b, h, k, k, f32=True), draw(h, k, scale=0.1)],
                 [rows, rows, rows, rows, st, shd.P(None, None)], True),
    }
    out = {}
    for name, (fn, kw, args, specs, bonus) in cases.items():
        def run(xs, on_mesh):
            xs = [x.detach().requires_grad_() for x in xs]
            *main, state = xs[:5]
            u = xs[5] if bonus else None
            if fn is linear_attention_step:
                y, s1 = fn(*main, state, bonus_u=u, **kw)
            else:
                y, s1 = fn(*main, initial_state=state, bonus_u=u, **kw)
            gy = draw(*y.shape, f32=True)
            gs = draw(*s1.shape, f32=True)
            if on_mesh:
                gy = shd.place(gy, mesh, shd.spec_of(y), from_rank=None)
                gs = shd.place(gs, mesh, shd.spec_of(s1), from_rank=None)
            loss = (y.float() * gy).sum() + (s1 * gs).sum()
            return [y, s1, *torch.autograd.grad(loss, xs)]
        state = rng.bit_generator.state
        plain = run(args, False)
        rng.bit_generator.state = state      # the same cotangents
        sharded = run([shd.place(x, mesh, s) for x, s in zip(args, specs)],
                      True)
        names = ["y", "state", "q", "k", "v", "log_w", "state0", "u"]
        out.update({f"{name} {k_}": v_ for k_, v_ in _rel_diffs(
            names, sharded, plain).items()})
    return out


SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 8, 4


def serving_ids(vocab: int) -> np.ndarray:
    """The token ids of ``sharded_serving``: a prompt, then one id for each
    decode step."""
    return np.random.default_rng(1).integers(
        0, vocab, (SERVE_BATCH, SERVE_PROMPT + SERVE_STEPS)).astype(np.int32)


def sharded_serving(params_npz: str, out_npz: str,
                    device: str = "cpu") -> dict:
    """Reduced tinyllama's ``prefill`` of ``SERVE_PROMPT`` tokens and
    ``SERVE_STEPS`` ``decode_step``s on (data 2, model 2) under the dry
    run's decode rules (the caches' positions split over ``data``, their
    kv heads over ``model``), against the same on one device, both from
    the JAX package's initial parameters: each logits' largest |diff|.
    Rank 0 writes the sharded logits to ``out_npz`` (``logits0`` the
    prefill's, then one for each step)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import decode_step, init_decode_state, prefill
    cfg = _cfg()
    mesh = make_mesh((2, 2), ("data", "model"), devices=device)
    rules = dryrun.decode_rules(cfg, mesh)
    with np.load(params_npz) as f:
        params = params_from_numpy(_nest(dict(f)), cfg, device)
    b, prompt, steps = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS
    ids = torch.from_numpy(serving_ids(cfg.vocab)).to(device)
    state = init_decode_state(cfg, b, prompt + steps, device)
    pspecs = shd.param_pspecs(params, mesh, rules, cfg=cfg)
    sspecs = shd.decode_state_pspecs(cfg, mesh, rules, state, batch=b)

    def on_mesh(tree, specs):
        return T.tree_map(lambda x, s: shd.place(x, mesh, s, from_rank=None),
                          tree, specs)

    def run(p, st):
        st, lg = prefill(p, cfg, st, {"inputs": ids[:, :prompt]})
        out = [lg]
        for t in range(prompt, prompt + steps):
            st, lg = decode_step(p, cfg, st, {"inputs": ids[:, t:t + 1]})
            out.append(lg)
        return out, st

    sharded, st = run(on_mesh(params, pspecs), on_mesh(state, sspecs))
    sharded = [a.full_tensor() for a in sharded]
    plain, _ = run(params, state)
    _save_rank0(out_npz, **{f"logits{i}": a for i, a in enumerate(sharded)})
    return {"diff": [float((a - b_).abs().max())
                     for a, b_ in zip(sharded, plain)],
            "cache": str(st["cache_k"].placements)}
