"""Per-family layer blocks: the transformer block (dense, moe, vlm and
audio, and the hybrid family's shared block) with its whole-sequence body
(forward and prefill) and serving steps (chunked prefill and decode); the
Mamba2 block (hybrid) and the RWKV6 block (ssm), each with its
whole-sequence body and decode step.
Block params are plain dicts; a stacked init gives every leaf leading
stack axes (``lead``), and the model indexes one layer at a time."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S


def transformer_block_init(gen, cfg: ArchConfig, *, d_ff: int | None = None,
                           device="cuda", lead: tuple = ()) -> dict:
    """A ``"moe"`` subtree when the config has one and ``d_ff`` is not
    given, else a SwiGLU ``"ffn"`` of width ``d_ff`` (default
    ``cfg.d_ff``): the hybrid family's shared block passes its own."""
    kw = dict(dtype=cfg.pdtype, device=device, lead=lead)
    p = {
        "ln1": L.rmsnorm_init(cfg.d_model, **kw),
        "attn": A.attention_init(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim_,
                                 qkv_bias=cfg.qkv_bias, **kw),
        "ln2": L.rmsnorm_init(cfg.d_model, **kw),
    }
    if cfg.moe is not None and d_ff is None:
        p["moe"] = M.moe_init(gen, cfg.d_model, cfg.moe, **kw)
    else:
        p["ffn"] = M.swiglu_init(gen, cfg.d_model, d_ff or cfg.d_ff, **kw)
    return p


def _ffn(p: dict, x, cfg: ArchConfig) -> tuple[torch.Tensor, tuple | None]:
    """The residual FFN half: (x', the router's (probabilities, top-k
    experts) for the MoE aux loss; None for a SwiGLU block). The serving
    steps drop the routing, so they never compute the aux loss."""
    y = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        h, probs, gate_e = M.moe_ffn(p["moe"], y, cfg.moe,
                                     compute_dtype=cfg.cdtype)
        return x + h, (probs, gate_e)
    return x + M.swiglu_apply(p["ffn"], y, compute_dtype=cfg.cdtype), None


def transformer_block_apply(p: dict, x, positions, cfg: ArchConfig
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill-compute body. Returns (x', aux); aux is the MoE
    load-balancing loss, 0 without experts."""
    h = A.attention_train(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), positions,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
        pos_embed=cfg.pos_embed, rope_theta=cfg.rope_theta,
        mrope_sections=tuple(cfg.mrope_sections), q_chunk=cfg.q_chunk,
        compute_dtype=cfg.cdtype)
    x, routing = _ffn(p, x + h, cfg)
    if routing is None:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, M.moe_aux(*routing, cfg.moe)


def transformer_block_prefill(p: dict, x, positions, cache_k, cache_v,
                              cfg: ArchConfig):
    h, ck, cv = A.attention_prefill(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), positions,
        cache_k, cache_v,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
        pos_embed=cfg.pos_embed, rope_theta=cfg.rope_theta,
        mrope_sections=tuple(cfg.mrope_sections), q_chunk=cfg.q_chunk,
        compute_dtype=cfg.cdtype)
    return _ffn(p, x + h, cfg)[0], ck, cv


def transformer_block_prefill_chunk(p: dict, x, offset, chunk_len, cache_k,
                                    cache_v, cfg: ArchConfig,
                                    kernel_mode: str = "reference",
                                    seq_tile: int = 128,
                                    dynamic_grid: bool = False,
                                    port_mix: str = "wr"):
    h, ck, cv = A.attention_prefill_chunk(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), offset, chunk_len,
        cache_k, cache_v,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
        pos_embed=cfg.pos_embed, rope_theta=cfg.rope_theta,
        mrope_sections=tuple(cfg.mrope_sections), kernel_mode=kernel_mode,
        seq_tile=seq_tile, dynamic_grid=dynamic_grid, port_mix=port_mix,
        compute_dtype=cfg.cdtype)
    return _ffn(p, x + h, cfg)[0], ck, cv


def transformer_block_decode(p: dict, x, cache_k, cache_v, cache_len,
                             cfg: ArchConfig, kernel_mode: str = "reference",
                             seq_tile: int = 128, length_mask: bool = True,
                             dynamic_grid: bool = False,
                             num_kv_splits: int = 1, port_mix: str = "wr"):
    h, ck, cv = A.attention_decode(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cache_k, cache_v,
        cache_len,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
        pos_embed=cfg.pos_embed, rope_theta=cfg.rope_theta,
        mrope_sections=tuple(cfg.mrope_sections), kernel_mode=kernel_mode,
        seq_tile=seq_tile, length_mask=length_mask, dynamic_grid=dynamic_grid,
        num_kv_splits=num_kv_splits, port_mix=port_mix,
        compute_dtype=cfg.cdtype)
    return _ffn(p, x + h, cfg)[0], ck, cv


# --------------------------------------------------------------------------
# mamba2 block (hybrid)
# --------------------------------------------------------------------------

def mamba_block_init(gen, cfg: ArchConfig, *, device="cuda",
                     lead: tuple = ()) -> dict:
    kw = dict(dtype=cfg.pdtype, device=device, lead=lead)
    return {"ln": L.rmsnorm_init(cfg.d_model, **kw),
            "mamba": S.mamba2_init(gen, cfg.d_model, cfg.ssm, **kw)}


def mamba_block_apply(p: dict, x, cfg: ArchConfig, conv_state=None,
                      ssm_state=None, return_state: bool = False):
    """x + Mamba2(norm(x)); with ``return_state`` also the conv and SSM
    states at the end of the sequence."""
    out = S.mamba2_apply(p["mamba"], L.rmsnorm(p["ln"], x, cfg.norm_eps),
                         cfg.d_model, cfg.ssm, la_chunk=cfg.la_chunk,
                         compute_dtype=cfg.cdtype, conv_state=conv_state,
                         ssm_state=ssm_state, return_state=return_state)
    if return_state:
        h, cs, ss = out
        return x + h, cs, ss
    return x + out


def mamba_block_decode(p: dict, x, cfg: ArchConfig, conv_state, ssm_state):
    h, cs, ss = S.mamba2_decode_step(
        p["mamba"], L.rmsnorm(p["ln"], x, cfg.norm_eps), cfg.d_model,
        cfg.ssm, conv_state=conv_state, ssm_state=ssm_state,
        compute_dtype=cfg.cdtype)
    return x + h, cs, ss


# --------------------------------------------------------------------------
# rwkv block (ssm)
# --------------------------------------------------------------------------

def rwkv_block_init(gen, cfg: ArchConfig, *, device="cuda",
                    lead: tuple = ()) -> dict:
    kw = dict(dtype=cfg.pdtype, device=device, lead=lead)
    return {"ln1": L.rmsnorm_init(cfg.d_model, **kw),
            "tm": R.time_mix_init(gen, cfg.d_model, cfg.rwkv, **kw),
            "ln2": L.rmsnorm_init(cfg.d_model, **kw),
            "cm": R.channel_mix_init(gen, cfg.d_model, cfg.d_ff, **kw)}


def rwkv_block_apply(p: dict, x, cfg: ArchConfig, states=None,
                     return_state: bool = False):
    """states: (tm_shift, tm_state, cm_shift) or None; any of them may be
    None (zeros). With ``return_state`` returns (x', (tm_shift', tm_state',
    cm_shift'))."""
    tm_shift, tm_state, cm_shift = states if states is not None else         (None, None, None)
    y = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    tm = R.time_mix_apply(p["tm"], y, cfg.rwkv, la_chunk=cfg.la_chunk,
                          compute_dtype=cfg.cdtype, shift_state=tm_shift,
                          ssm_state=tm_state, return_state=return_state)
    h = tm[0] if return_state else tm
    x = x + h
    y = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    cm = R.channel_mix_apply(p["cm"], y, compute_dtype=cfg.cdtype,
                             shift_state=cm_shift, return_state=return_state)
    if return_state:
        return x + cm[0], (tm[1], tm[2], cm[1])
    return x + cm


def rwkv_block_decode(p: dict, x, cfg: ArchConfig, states):
    tm_shift, tm_state, cm_shift = states
    h, new_tm_shift, new_tm_state = R.time_mix_step(
        p["tm"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg.rwkv,
        shift_state=tm_shift, ssm_state=tm_state, compute_dtype=cfg.cdtype)
    x = x + h
    h, new_cm_shift = R.channel_mix_step(
        p["cm"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), shift_state=cm_shift,
        compute_dtype=cfg.cdtype)
    return x + h, (new_tm_shift, new_tm_state, new_cm_shift)
