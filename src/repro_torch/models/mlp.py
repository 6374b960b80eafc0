"""Feed-forward blocks: SwiGLU (llama family) and the MoE layer.

MoE uses sort-based token dispatch (Megablocks-style): tokens are sorted by
destination expert, scattered into per-expert capacity slots, run through a
batched expert matmul, and combined back with router weights. The
[tokens, experts, capacity] one-hot dispatch tensor of GShard never
materializes. The expert products are plain ``torch.einsum``, as the JAX
package computes them outside any kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as _device
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.api import hint
from repro_torch.models import layers as L


def swiglu_init(gen, d_model: int, d_ff: int, dtype=torch.float32,
                device="cuda", lead: tuple = ()) -> dict:
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "w_gate": L.linear_init(gen, d_model, d_ff, **kw),
        "w_up": L.linear_init(gen, d_model, d_ff, **kw),
        "w_down": L.linear_init(gen, d_ff, d_model, **kw),
    }


def swiglu_apply(p: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    g = L.linear(p["w_gate"], x, compute_dtype)
    u = L.linear(p["w_up"], x, compute_dtype)
    return L.linear(p["w_down"], L.swiglu(g, u), compute_dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def moe_init(gen, d_model: int, cfg: MoEConfig, dtype=torch.float32,
             device="cuda", lead: tuple = ()) -> dict:
    """Router N(0, 0.02), experts N(0, 1/fan_in) as in the JAX package. The
    expert stacks are drawn one [d_in, d_out] matrix at a time."""
    device = _device.resolve(device)
    e, f = cfg.n_experts, cfg.d_expert

    def experts(d_in, d_out):
        return L.stacked_normal_init(gen, (*lead, e), (d_in, d_out), dtype,
                                     1.0 / math.sqrt(d_in), device)
    p = {
        "router": {"w": L.normal_init(gen, (*lead, d_model, e), dtype, 0.02,
                                      device)},
        "w_gate": experts(d_model, f),
        "w_up": experts(d_model, f),
        "w_down": experts(f, d_model),
    }
    if cfg.n_shared:
        p["shared"] = swiglu_init(gen, d_model, cfg.n_shared * f, dtype=dtype,
                                  device=device, lead=lead)
    return p


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig, compute_dtype=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, d], router aux loss scalar)."""
    out, probs, gate_e = moe_ffn(p, x, cfg, compute_dtype)
    return out, moe_aux(probs, gate_e, cfg)


def moe_aux(probs: torch.Tensor, gate_e: torch.Tensor, cfg: MoEConfig
            ) -> torch.Tensor:
    """Switch-style load-balancing loss from the router's probabilities
    [B, S, E] and its top-k experts [B, S, k]."""
    b, s, k = gate_e.shape
    me = probs.mean(dim=(0, 1))                                # [E]
    onehot_counts = torch.nn.functional.one_hot(gate_e, cfg.n_experts).float(
        ).sum(dim=(0, 1, 2))
    ce = onehot_counts / (b * s * k)
    return cfg.router_aux_weight * cfg.n_experts * torch.sum(me * ce)


def capacity(n_slots: int, cfg: MoEConfig) -> int:
    """Slots each expert takes from a row of ``n_slots`` routed slots."""
    return int(max(1, round(n_slots / cfg.n_experts * cfg.capacity_factor)))


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig, compute_dtype=None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The MoE layer without its aux loss, as the serving steps run it.
    Returns (output [B, S, d], router probabilities [B, S, E] f32, top-k
    experts [B, S, k]).

    Dispatch is row-local: sorting, ranking and the staging scatter all
    happen within each batch row. Ties in the router's top k go to the
    lower expert index, as the JAX package's ``lax.top_k`` breaks them (a
    stable descending sort); a tie is real (a zero row routes every expert
    equally) and moves which slots win capacity.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = s * k                                                  # slots per row
    xf = x if compute_dtype is None else x.to(compute_dtype)
    dev = x.device

    # --- routing (row-local) -------------------------------------------------
    logits = L.linear(p["router"], xf, torch.float32)          # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    ranked, ranked_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = ranked[..., :k], ranked_e[..., :k]        # [B, S, k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # --- row-local sort-based dispatch ----------------------------------------
    cap = capacity(n, cfg)
    fe = gate_e.reshape(b, n)                                  # expert per slot
    ft = torch.arange(s, device=dev)[:, None].expand(s, k).reshape(n)
    fw = gate_w.reshape(b, n)

    order = torch.argsort(fe, dim=-1, stable=True)             # per-row sort
    se = torch.gather(fe, 1, order)                            # [B, n]
    st = ft[order]                                             # [B, n]
    sw = torch.gather(fw, 1, order)
    # rank within the row's expert group via exclusive running counts
    counts = torch.nn.functional.one_hot(se, e).sum(dim=1)     # [B, E]
    start = torch.cumsum(counts, dim=-1) - counts              # [B, E]
    pos = torch.arange(n, device=dev)[None, :] - torch.gather(start, 1, se)
    keep = pos < cap

    rows = torch.arange(b, device=dev)[:, None]
    e_idx = torch.where(keep, se, e)         # dropped slots land in row e
    p_idx = torch.where(keep, pos, 0)
    tok = xf[rows, st]                                         # [B, n, d]

    buf = torch.zeros((b, e + 1, cap, d), dtype=xf.dtype, device=dev)
    buf[rows, e_idx, p_idx] = tok
    buf = hint(buf[:, :e], "moe_buf")                          # [B, E, C, d]

    # --- batched expert FFN ----------------------------------------------------
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if compute_dtype is not None:
        wg, wu, wd = (w.to(compute_dtype) for w in (wg, wu, wd))
    hg = torch.einsum("becd,edf->becf", buf, wg)
    hu = torch.einsum("becd,edf->becf", buf, wu)
    h = L.swiglu(hg, hu)
    out_buf = hint(torch.einsum("becf,efd->becd", h, wd), "moe_buf")

    # --- combine (the MoE "read port", row-local) -----------------------------
    y_sorted = out_buf[rows, torch.clamp(e_idx, max=e - 1), p_idx]  # [B, n, d]
    y_sorted = torch.where(keep[..., None], y_sorted,
                           torch.zeros((), dtype=y_sorted.dtype, device=dev))
    y_sorted = y_sorted * sw[..., None].to(y_sorted.dtype)
    inv = torch.argsort(order, dim=-1, stable=True)            # undo the sort
    y = torch.gather(y_sorted, 1, inv[..., None].expand(b, n, d))
    out = y.reshape(b, s, k, d).sum(dim=2)                     # k experts/token

    if "shared" in p:
        out = out + swiglu_apply(p["shared"], xf, compute_dtype)
    return out.to(x.dtype), probs, gate_e
