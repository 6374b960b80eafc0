"""Transformer block (dense family): init + chunked-prefill and decode
steps. Block params are plain dicts; a stacked init gives every leaf a
leading [n_layers] axis, and the model indexes one layer at a time."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M


def transformer_block_init(gen, cfg: ArchConfig, *, device="cpu",
                           lead: tuple = ()) -> dict:
    kw = dict(dtype=cfg.pdtype, device=device, lead=lead)
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, **kw),
        "attn": A.attention_init(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim_,
                                 qkv_bias=cfg.qkv_bias, **kw),
        "ln2": L.rmsnorm_init(cfg.d_model, **kw),
        "ffn": M.swiglu_init(gen, cfg.d_model, cfg.d_ff, **kw),
    }


def _ffn(p: dict, x, cfg: ArchConfig):
    y = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + M.swiglu_apply(p["ffn"], y, compute_dtype=cfg.cdtype)


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
        kernel_mode=kernel_mode, seq_tile=seq_tile, dynamic_grid=dynamic_grid,
        port_mix=port_mix, compute_dtype=cfg.cdtype)
    return _ffn(p, x + h, cfg), ck, cv


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
        kernel_mode=kernel_mode, seq_tile=seq_tile, length_mask=length_mask,
        dynamic_grid=dynamic_grid, num_kv_splits=num_kv_splits,
        port_mix=port_mix, compute_dtype=cfg.cdtype)
    return _ffn(p, x + h, cfg), ck, cv
