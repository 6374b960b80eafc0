"""Adafactor (factored second moments) — the sub-linear-memory alternative.

Matrices store row/column second-moment factors only (O(n+m) instead of
O(nm)); a stacked [L, a, b] leaf is factored over its last two axes, and
vectors fall back to full second moments. No first moment (momentum-free,
per the paper's recommended configuration), relative step sizes off — the
external schedule drives lr.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.distributed import sharding as S
from repro_torch.optim.adamw import (AdamWConfig, clip_by_global_norm,
                                     step_zero)

PyTree = Any
f32 = torch.float32


def adafactor_init(params: PyTree, cfg: AdamWConfig) -> dict:
    def factors(p):
        spec = S.spec_of(p)
        if p.ndim >= 2:
            return {"vr": S.zeros(p.shape[:-1], f32, p,
                                  S.row_factor_spec(spec)),
                    "vc": S.zeros(p.shape[:-2] + p.shape[-1:], f32, p,
                                  S.col_factor_spec(spec))}
        return {"v": S.zeros(p.shape, f32, p, spec)}
    return {"step": step_zero(params),
            "v": T.tree_map(factors, params)}


@torch.no_grad()
def adafactor_update(grads: PyTree, state: dict, params: PyTree, lr,
                     cfg: AdamWConfig) -> tuple[PyTree, dict, dict]:
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    t = step.to(f32)
    beta2 = 1.0 - t ** -0.8                     # adafactor beta2 schedule
    eps = 1e-30

    def upd(g, v, p):
        g2 = torch.square(g) + eps
        if p.ndim >= 2:
            vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2)
            denom = (vr[..., None] / torch.clamp(
                vr.mean(dim=-1, keepdim=True)[..., None], min=eps)) \
                * vc[..., None, :]
            u = g * torch.rsqrt(torch.clamp(denom, min=eps))
            nv = {"vr": vr, "vc": vc}
        else:
            nv = {"v": beta2 * v["v"] + (1 - beta2) * g2}
            u = g * torch.rsqrt(torch.clamp(nv["v"], min=eps))
        # update clipping (adafactor d=1.0)
        rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
        u = u / torch.clamp(rms, min=1.0)
        pf = p.to(f32)
        pf = pf - lr * (u + cfg.weight_decay * pf)
        # on DTensors the factors keep their placements (a mean over a
        # split dim would otherwise stay a pending sum)
        return T.tree_map(S.like, nv, v), S.like(pf.to(p.dtype), p)

    outs = [upd(g, v, p) for g, v, p in zip(
        T.leaves(grads), T.leaves_up_to(grads, state["v"]),
        T.leaves_up_to(grads, params))]
    new_state = dict(state, step=step,
                     v=T.unflatten(grads, [o[0] for o in outs]))
    return (T.unflatten(grads, [o[1] for o in outs]), new_state,
            {"grad_norm": gnorm})
