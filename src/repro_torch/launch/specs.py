"""Shape-only stand-ins for the parameters, the train state and the decode
state, and the sharding trees of a train state.

The JAX package builds its stand-ins with ``jax.eval_shape``; the port
builds the same trees on the meta device, which allocates nothing, so a
spec of llama3-405b costs no memory. The spec functions take any leaf
with a ``.shape``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import init_decode_state, init_params
from repro_torch.train.train_step import TrainConfig, init_train_state

PyTree = Any


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
