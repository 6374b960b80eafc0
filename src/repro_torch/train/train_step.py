"""Train step factory: loss -> grads -> (compress) -> clip -> optimizer.

Features wired here, as in the JAX package's ``train/train_step.py``:
  * gradient accumulation (``microbatches``): f32 grads summed over the
    microbatches in order and divided by their count (JAX's ``lax.scan``);
  * optional cross-pod int8 error-feedback gradient compression
    (distributed/compression.py): one backward per pod slice of the batch,
    in pod order, stacked on a leading pod axis (JAX's ``vmap(grad)``);
  * optimizer selection (adamw / adamw8bit / adafactor).

The step is functional: it returns a new state and leaves the one it was
given untouched, so two runs may start from one state.

Sharded training (the JAX package's ``jit`` with ``in_shardings``): the
same step runs on a state and batch of DTensors placed by
``launch.specs.train_state_pspecs`` and ``sharding.batch_specs``, one
process per mesh position. Each gradient is brought to its parameter's
placements before the update (a reduce-scatter where the parameter is
split), and under ``int8_ef`` on a mesh with a ``pod`` axis each pod
takes the grads of its own shard of the batch (``sharding.per_pod``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import compression as C
from repro_torch.distributed import sharding as S
from repro_torch.models import loss_fn
from repro_torch.optim import AdamWConfig, make_optimizer, warmup_cosine

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    adamw: AdamWConfig = AdamWConfig()
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    microbatches: int = 1
    grad_compression: Optional[str] = None      # None | "int8_ef"
    n_pods: int = 1


def init_train_state(params: PyTree, tcfg: TrainConfig) -> dict:
    opt_init, _, _ = make_optimizer(tcfg.optimizer, tcfg.adamw)
    state = {"params": params, "opt": opt_init(params)}
    if tcfg.grad_compression == "int8_ef":
        state["ef"] = C.init_ef_state(params, tcfg.n_pods)
    return state


def _split_micro(batch: dict, m: int) -> list[dict]:
    """``m`` equal slices of the batch along its leading axis, in order
    (JAX's rows). A DTensor slice is placed as the whole batch is: slicing
    rows split over ``data`` gathers them, and each data rank then keeps
    its share of the microbatch's rows, so no row is computed twice."""
    return [{k: S.like(v[i * (v.shape[0] // m):(i + 1) * (v.shape[0] // m)],
                       v)
             for k, v in batch.items()} for i in range(m)]


def _value_and_grad(params: PyTree, cfg: ArchConfig, batch: dict
                    ) -> tuple[dict, PyTree]:
    """(the loss's metrics, grads in each parameter's dtype) of one batch.
    The parameters are taken as fresh autograd leaves, so the state's own
    tensors need no ``requires_grad`` and gain no ``.grad``. DTensor
    grads come back placed as their parameters, and DTensor metrics
    reduced onto every rank."""
    leaves = [p.detach().requires_grad_() for p in T.leaves(params)]
    with torch.enable_grad(), S.plain_is_replicated(leaves[0]):
        loss, metrics = loss_fn(T.unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    return ({k: S.reduced(v.detach()) for k, v in metrics.items()},
            T.unflatten(params, [S.like(g, p)
                                 for g, p in zip(grads, leaves)]))


def _mean_metrics(ms: list[dict]) -> dict:
    return {k: torch.stack([m[k].to(torch.float32) for m in ms]).mean(0)
            for k in ms[0]}


def compute_grads(params: PyTree, cfg: ArchConfig, tcfg: TrainConfig,
                  batch: dict) -> tuple[PyTree, dict]:
    """(grads, metrics) of one step's batch: per-pod grads [n_pods, ...]
    under ``int8_ef``, f32 grads averaged over the microbatches when
    ``microbatches > 1``, else the grads of the whole batch."""
    if tcfg.grad_compression == "int8_ef":
        if S.has_axis(params, "pod"):
            return S.per_pod(lambda p, b: _value_and_grad(p, cfg, b),
                             params, batch)
        outs = [_value_and_grad(params, cfg, b)
                for b in _split_micro(batch, tcfg.n_pods)]
        grads = T.unflatten(params, [
            torch.stack(gs) for gs in zip(*(T.leaves(g) for _, g in outs))])
        return grads, _mean_metrics([m for m, _ in outs])
    if tcfg.microbatches > 1:
        acc, ms = None, []
        for b in _split_micro(batch, tcfg.microbatches):
            metrics, g = _value_and_grad(params, cfg, b)
            ms.append(metrics)
            acc = (T.tree_map(lambda x: x.to(torch.float32), g) if acc is None
                   else T.tree_map(torch.add, acc, g))
        grads = T.tree_map(lambda x: x / tcfg.microbatches, acc)
        return grads, _mean_metrics(ms)
    metrics, grads = _value_and_grad(params, cfg, batch)
    return grads, metrics


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    """Returns step(state, batch) -> (state', metrics)."""
    _, opt_update, _ = make_optimizer(tcfg.optimizer, tcfg.adamw)

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        grads, metrics = compute_grads(params, cfg, tcfg, batch)
        new_state = dict(state)
        if tcfg.grad_compression == "int8_ef":
            grads, new_ef = C.compressed_mean_tree(grads, state["ef"])
            grads = T.tree_map(S.like, grads, params)
            new_state["ef"] = T.tree_map(S.like, new_ef, state["ef"])
        lr = warmup_cosine(state["opt"]["step"], peak_lr=tcfg.peak_lr,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        new_params, new_opt, opt_stats = opt_update(grads, state["opt"],
                                                    params, lr)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        return new_state, dict(metrics, lr=lr, **opt_stats)

    return step
