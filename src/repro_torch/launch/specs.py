"""Shape-only stand-ins for every model input and state (the dry run's
no-allocation input builders), and the sharding trees of a train state.

The JAX package builds its stand-ins as ``ShapeDtypeStruct``s and with
``jax.eval_shape``; the port builds the same shapes and trees on the meta
device (:func:`sds`), which allocates nothing, so a spec of llama3-405b
costs no memory. The spec functions take any leaf with a ``.shape``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.models import init_decode_state, init_params
from repro_torch.train.train_step import TrainConfig, init_train_state

PyTree = Any


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (JAX's ``ShapeDtypeStruct``): a tensor
    on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """Batch stand-ins for one shape cell."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        if cfg.input_mode == "tokens":
            return {"inputs": sds((b, 1), torch.int32)}
        return {"inputs": sds((b, 1, cfg.d_model), cfg.cdtype)}
    batch = {"labels": sds((b, s), torch.int32)}
    if cfg.input_mode == "tokens":
        batch["inputs"] = sds((b, s), torch.int32)
    else:
        batch["inputs"] = sds((b, s, cfg.d_model), cfg.cdtype)
    if cfg.pos_embed == "mrope":
        batch["positions"] = sds((b, s, 3), torch.int32)
    return batch


def prefill_chunk_specs(cfg: ArchConfig, batch: int, chunk: int) -> dict:
    """Batch stand-ins for one chunked-prefill step, the serving engine's
    admission compute: ``batch`` sequences each contribute one
    ``chunk``-token slice of their prompt plus its valid row count (see
    ``models.prefill_chunk``)."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError("chunked prefill serves token models")
    return {"inputs": sds((batch, chunk), torch.int32),
            "chunk_len": sds((batch,), torch.int32)}


def kv_pool_specs(mesh, *, n_pages: int, page_tokens: int, word_width: int,
                  axis: str = "kv") -> tuple[torch.Tensor, shd.KVShardPlan]:
    """No-allocation stand-in for the serving engine's paged KV pool over
    a ``kv`` mesh (``launch.mesh.make_kv_mesh``): the whole storage
    ``[num_words, word_width]`` f32 and its page-aligned shard plan (each
    mesh device holds ``plan.words_per_shard`` of the words). Mirrors
    ``PagedPool.create(mesh=...)``: the pages round up to whole pages per
    shard and ``sharding.kv_pool_spec``'s checks apply. The word is not
    padded: the port drops the JAX package's lane padding."""
    plan = shd.kv_shard_plan(int(mesh.shape[axis]), n_pages=n_pages,
                             page_tokens=page_tokens)
    plan = shd.kv_pool_spec(mesh, num_words=plan.num_words,
                            page_tokens=page_tokens, axis=axis)
    return sds((plan.num_words, word_width), torch.float32), plan


def kv_split_partial_specs(cfg: ArchConfig, batch: int,
                           num_kv_splits: int) -> dict:
    """No-allocation stand-ins for the split-KV decode intermediates of one
    attention layer: stage 1's partial accumulators ``acc_partial`` [B,
    splits, H, D] and its (running max, denominator) stats
    ``lse_partial`` [B, splits, H, 2], both f32, which stage 2 combines.
    The shapes are read off ``kernels.kv_multiport.split_partial_shapes``,
    where the kernel's wrapper reads them, so a drift there shows here."""
    from repro_torch.kernels.kv_multiport import split_partial_shapes

    acc, stats = split_partial_shapes(batch, cfg.n_heads, cfg.head_dim_,
                                      num_kv_splits)
    return {"acc_partial": sds(acc, torch.float32),
            "lse_partial": sds(stats, torch.float32)}


def params_shapes(cfg: ArchConfig) -> PyTree:
    return init_params(cfg, torch.Generator(), "meta")


def train_state_shapes(cfg: ArchConfig, tcfg: TrainConfig) -> PyTree:
    return init_train_state(params_shapes(cfg), tcfg)


def decode_state_shapes(cfg: ArchConfig, batch: int, max_len: int) -> PyTree:
    return init_decode_state(cfg, batch, max_len, "meta")


def opt_state_pspecs(opt_shapes: PyTree, param_specs: PyTree, mesh,
                     rules: shd.Rules) -> PyTree:
    """Specs for optimizer state: moments mirror params; quantized blocks
    shard their block axis on fsdp; adafactor factors drop the reduced dim;
    error-feedback residuals put ``pod`` on their lead axis."""
    flat_params = {shd.path_str(p): s for p, s in
                   T.leaves_with_path(param_specs)}

    def assign(path, leaf):
        parts = [str(k) for k in path]
        if parts == ["step"]:
            return shd.P()
        head, rest = parts[0], parts[1:]
        nd = len(leaf.shape)
        if head == "ef":                       # [n_pods, *param_shape]
            base = flat_params.get("/".join(rest))
            return shd.ef_spec(base if base else (None,) * (nd - 1), mesh)
        tail = rest[-1] if rest else ""
        owner = flat_params.get("/".join(rest[:-1]))
        base = flat_params.get("/".join(rest))
        if base is not None:                   # moments mirror the param spec
            return shd.P(*base)
        if tail in ("q", "scale") and owner is not None:
            nb = leaf.shape[-2] if nd >= 2 else 1
            return shd.quant_spec(owner, nb, mesh)
        if tail == "vr":
            return (shd.row_factor_spec(owner) if owner
                    else shd.P(*(None,) * nd))
        if tail == "vc":
            return (shd.col_factor_spec(owner) if owner and len(owner) >= 2
                    else shd.P(*(None,) * nd))
        if tail == "v" and owner is not None:
            return shd.P(*owner)
        return shd.P(*(None,) * nd)

    return T.unflatten(opt_shapes, [assign(p, x) for p, x in
                                    T.leaves_with_path(opt_shapes)])


def train_state_pspecs(cfg: ArchConfig, mesh, rules: shd.Rules,
                       state_shapes: PyTree) -> PyTree:
    pspecs = shd.param_pspecs(state_shapes["params"], mesh, rules, cfg=cfg)
    out = {"params": pspecs,
           "opt": opt_state_pspecs(state_shapes["opt"], pspecs, mesh, rules)}
    if "ef" in state_shapes:
        out["ef"] = opt_state_pspecs({"ef": state_shapes["ef"]}, pspecs,
                                     mesh, rules)["ef"]
    return out


def named_tree(mesh, spec_tree: PyTree) -> PyTree:
    """The DTensor placements of every spec in ``spec_tree`` on ``mesh``."""
    return shd.named(mesh, spec_tree)
