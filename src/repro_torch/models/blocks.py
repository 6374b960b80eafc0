"""Transformer block (dense, moe, vlm and audio families): init, the
whole-sequence body (forward and prefill) and the serving steps (chunked
prefill and decode).
Block params are plain dicts; a stacked init gives every leaf a leading
[n_layers] axis, and the model indexes one layer at a time."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M


def transformer_block_init(gen, cfg: ArchConfig, *, device="cuda",
                           lead: tuple = ()) -> dict:
    """A ``"moe"`` subtree when the config has one, else a SwiGLU
    ``"ffn"``."""
    kw = dict(dtype=cfg.pdtype, device=device, lead=lead)
    p = {
        "ln1": L.rmsnorm_init(cfg.d_model, **kw),
        "attn": A.attention_init(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim_,
                                 qkv_bias=cfg.qkv_bias, **kw),
        "ln2": L.rmsnorm_init(cfg.d_model, **kw),
    }
    if cfg.moe is not None:
        p["moe"] = M.moe_init(gen, cfg.d_model, cfg.moe, **kw)
    else:
        p["ffn"] = M.swiglu_init(gen, cfg.d_model, cfg.d_ff, **kw)
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
