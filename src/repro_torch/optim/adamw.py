"""AdamW with global-norm clipping over a tree of tensors.

States are kept in f32 regardless of parameter dtype (mixed-precision
training: bf16 params, f32 master states is available via
``master_weights``). On DTensor parameters (sharded training) each state
is placed as its parameter is (``launch.specs.opt_state_pspecs``).
Updates are functional, as in the JAX package: they return new tensors
and leave their inputs untouched, so a state can be stepped twice from
the same start.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.distributed import sharding as S

PyTree = Any
f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_weights: bool = False  # keep an f32 copy of bf16 params


def global_norm(tree: PyTree) -> torch.Tensor:
    """The f32 norm of every leaf together, summed leaf by leaf in leaf
    order as the JAX package's ``tree_reduce`` sums."""
    sq = None
    for x in T.leaves(tree):
        s = torch.sum(torch.square(x.to(f32)))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> tuple[PyTree, torch.Tensor]:
    """f32 grads scaled to a global norm of at most ``max_norm`` (the
    optimizers see f32 grads whatever the parameter dtype)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return T.tree_map(lambda g: g.to(f32) * scale, grads), norm


def step_zero(params: PyTree) -> torch.Tensor:
    """The optimizer's int32 step counter, on the parameters' device
    (replicated over their mesh for DTensor parameters)."""
    return S.zeros((), torch.int32, T.leaves(params)[0], S.P())


def adamw_init(params: PyTree, cfg: AdamWConfig) -> dict:
    def zeros(p):
        return S.zeros(p.shape, f32, p, S.spec_of(p))
    state = {"step": step_zero(params),
             "m": T.tree_map(zeros, params),
             "v": T.tree_map(zeros, params)}
    if cfg.master_weights:
        state["master"] = T.tree_map(lambda p: p.detach().to(f32, copy=True),
                                     params)
    return state


def bias_corrections(step: torch.Tensor, cfg: AdamWConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    t = step.to(f32)
    return 1 - cfg.b1 ** t, 1 - cfg.b2 ** t


@torch.no_grad()
def adamw_update(grads: PyTree, state: dict, params: PyTree, lr,
                 cfg: AdamWConfig) -> tuple[PyTree, dict, dict]:
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    c1, c2 = bias_corrections(step, cfg)
    src = state.get("master", params)

    def upd(g, m, v, p):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh, vh = m / c1, v / c2
        pf = p.to(f32)
        pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                        + cfg.weight_decay * pf)
        return m, v, pf

    outs = [upd(g, m, v, p) for g, m, v, p in zip(
        T.leaves(grads), T.leaves_up_to(grads, state["m"]),
        T.leaves_up_to(grads, state["v"]), T.leaves_up_to(grads, src))]
    new_f32 = T.unflatten(grads, [o[2] for o in outs])
    new_params = T.tree_map(lambda pf, p: pf.to(p.dtype), new_f32, params)
    new_state = dict(state, step=step,
                     m=T.unflatten(grads, [o[0] for o in outs]),
                     v=T.unflatten(grads, [o[1] for o in outs]))
    if "master" in state:
        new_state["master"] = new_f32
    return new_params, new_state, {"grad_norm": gnorm}
