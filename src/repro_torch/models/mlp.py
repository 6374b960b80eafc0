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
from repro_torch.distributed import sharding as S
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
    [B, S, E] and its top-k experts [B, S, k]. On DTensors each rank
    counts its own rows' experts and the counts are summed over the ranks
    that split the rows."""
    b, s, k = gate_e.shape
    me = probs.mean(dim=(0, 1))                                # [E]
    if S.is_dtensor(gate_e):
        onehot_counts = S.local_row_sum(
            lambda ge: _expert_counts(ge, cfg.n_experts), gate_e)
    else:
        onehot_counts = _expert_counts(gate_e, cfg.n_experts)
    ce = onehot_counts / (b * s * k)
    return cfg.router_aux_weight * cfg.n_experts * torch.sum(me * ce)


def _expert_counts(gate_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """How many of the top-k slots [B, S, k] chose each expert, [E] f32."""
    return torch.nn.functional.one_hot(gate_e, n_experts).float(
        ).sum(dim=(0, 1, 2))


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

    On DTensors (sharded training and the dry run) the three stages run on
    each rank's own share (``_moe_ffn_sharded``); plain tensors take the
    stages in turn.
    """
    xf = x if compute_dtype is None else x.to(compute_dtype)
    ws = [p[n] for n in ("w_gate", "w_up", "w_down")]
    if compute_dtype is not None:
        ws = [w.to(compute_dtype) for w in ws]
    if S.is_dtensor(xf):
        out, probs, gate_e = _moe_ffn_sharded(p["router"], xf, ws, cfg)
    else:
        probs, gate_e, buf, *slots = _dispatch(p["router"], xf, cfg)
        out_buf = hint(_experts(hint(buf, "moe_buf"), *ws), "moe_buf")
        out = _combine(out_buf, *slots, k=cfg.top_k)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], xf, compute_dtype)
    return out.to(x.dtype), probs, gate_e


def _dispatch(router: dict, xf: torch.Tensor, cfg: MoEConfig) -> tuple:
    """Routing and the row-local sort-based dispatch of xf [B, S, d].
    Returns (probs [B, S, E] f32, gate_e [B, S, k], the staging buffer
    [B, E, C, d], and the combine's slots: e_idx, p_idx, keep, sw, order,
    each [B, n])."""
    b, s, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    n = s * k                                                  # slots per row
    dev = xf.device

    # --- routing (row-local) -------------------------------------------------
    logits = L.linear(router, xf, torch.float32)               # [B, S, E]
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
    return probs, gate_e, buf[:, :e], e_idx, p_idx, keep, sw, order


def _experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor) -> torch.Tensor:
    """The batched expert FFN of buf [B, E, C, d]: [B, E, C, d]."""
    hg = torch.einsum("becd,edf->becf", buf, wg)
    hu = torch.einsum("becd,edf->becf", buf, wu)
    h = L.swiglu(hg, hu)
    return torch.einsum("becf,efd->becd", h, wd)


def _combine(out_buf: torch.Tensor, e_idx, p_idx, keep, sw, order, *,
             k: int) -> torch.Tensor:
    """The combine (the MoE "read port", row-local): each slot's expert
    output, weighted, back in token order and summed over the k experts of
    a token. Returns [B, S, d]."""
    b, e, _, d = out_buf.shape
    n = e_idx.shape[1]
    rows = torch.arange(b, device=out_buf.device)[:, None]
    y_sorted = out_buf[rows, torch.clamp(e_idx, max=e - 1), p_idx]  # [B, n, d]
    y_sorted = torch.where(keep[..., None], y_sorted,
                           torch.zeros((), dtype=y_sorted.dtype,
                                       device=out_buf.device))
    y_sorted = y_sorted * sw[..., None].to(y_sorted.dtype)
    inv = torch.argsort(order, dim=-1, stable=True)            # undo the sort
    y = torch.gather(y_sorted, 1, inv[..., None].expand(b, n, d))
    return y.reshape(b, n // k, k, d).sum(dim=2)               # k experts/token


def _moe_ffn_sharded(router: dict, xf, ws: list, cfg: MoEConfig) -> tuple:
    """``moe_ffn``'s routed experts on DTensors, as GSPMD partitions the
    JAX package's: (1) routing and dispatch on each rank's own rows
    (the rows of xf's batch shards, whole over every other mesh dim), so
    the staging buffer comes out placed as the dry run's ``moe_buf`` hint
    (rows over the batch axes, replicated over ``model``); (2) each rank's
    expert products on its own experts' slice of that buffer (the expert
    weights split E over tp), no collective; (3) the expert outputs
    gathered over the expert-split dims (JAX's comment: a gather from a
    model-split dim would differentiate into a dense scatter-add), then the
    combine's gather and its backward on each rank's own rows. Returns
    (out [B, S, d], probs, gate_e)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rows = S.row_placements(xf)
    router = {k: S.on_mesh_of(v, xf) for k, v in router.items()}
    whole = [Replicate()] * len(rows)
    # a rank's share of the router's gradient is its rows' part of it
    rgrad = [Partial() if pl == Shard(0) else pl for pl in rows]
    probs, gate_e, buf, *slots = local_map(
        lambda x_, *r: _dispatch(dict(zip(router, r)), x_, cfg),
        out_placements=(rows,) * 8,                 # _dispatch's 8 outputs
        in_placements=(rows, *(whole,) * len(router)),
        in_grad_placements=(rows, *(rgrad,) * len(router)),
        redistribute_inputs=True)(xf, *router.values())
    buf = hint(buf, "moe_buf")

    bpl, wpl, wgrad = [], [], []
    for pl, pw in zip(rows, ws[0].placements):
        if pl == Shard(0):                      # the rows are split here
            bpl.append(pl), wpl.append(Replicate()), wgrad.append(Partial())
        elif pw == Shard(0):                    # the experts are split here
            bpl.append(Shard(1)), wpl.append(pw), wgrad.append(pw)
        else:
            bpl.append(Replicate()), wpl.append(Replicate())
            wgrad.append(Replicate())
    out_buf = local_map(_experts, out_placements=bpl,
                        in_placements=(bpl, wpl, wpl, wpl),
                        in_grad_placements=(bpl, wgrad, wgrad, wgrad),
                        redistribute_inputs=True)(buf, *ws)
    out_buf = hint(out_buf.redistribute(out_buf.device_mesh, rows), "moe_buf")
    out = local_map(lambda o, *sl: _combine(o, *sl, k=cfg.top_k),
                    out_placements=rows, in_placements=(rows,) * 6,
                    in_grad_placements=(rows,) * 6,
                    redistribute_inputs=True)(out_buf, *slots)
    return out, probs, gate_e
