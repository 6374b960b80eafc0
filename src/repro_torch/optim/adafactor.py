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
from repro_torch.optim.adamw import AdamWConfig, clip_by_global_norm

PyTree = Any
f32 = torch.float32


def adafactor_init(params: PyTree, cfg: AdamWConfig) -> dict:
    def factors(p):
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=f32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32,
                                      device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=f32, device=p.device)}
    return {"step": torch.zeros((), dtype=torch.int32,
                                device=T.leaves(params)[0].device),
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
        return nv, pf.to(p.dtype)

    outs = [upd(g, v, p) for g, v, p in zip(
        T.leaves(grads), T.leaves_up_to(grads, state["v"]),
        T.leaves_up_to(grads, params))]
    new_state = dict(state, step=step,
                     v=T.unflatten(grads, [o[0] for o in outs]))
    return (T.unflatten(grads, [o[1] for o in outs]), new_state,
            {"grad_norm": gnorm})
