"""Model assembly for serving: init, decode state, decode step and chunked
prefill for the dense family, plus the bridge that carries the JAX
package's parameters across.

Parameters are a nested dict of tensors shaped exactly like the JAX
package's pytree: block leaves are stacked on a leading [n_layers] axis,
and the layer loop (``lax.scan`` there) is a Python loop over that axis
here. ``cache_k[l]`` of a ``[L, B, S, Hkv, D]`` cache is a contiguous view,
so the fused kernels' in-place update lands in the caller's state; the
two-pass reference path returns new per-layer caches, which are copied
back into the same state, so both modes update ``state["cache_k"]`` and
``state["cache_v"]`` in place.

Decode state is a dict ``{"len": [B] int32, "cache_k", "cache_v"}``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

PyTree = Any


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (dense only; "
            f"MoE/VLM/audio/ssm/hybrid come with ROADMAP item A9)")
    if cfg.input_mode != "tokens":
        raise NotImplementedError("embedding-input frontends are not ported")


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> PyTree:
    """Random parameters with the JAX package's shapes and distributions
    (``models/layers.py`` there): embeddings N(0, 1), linear weights
    N(0, 1/fan_in), norm scales 1. ``generator`` lives on ``device``."""
    _check_family(cfg)
    kw = dict(dtype=cfg.pdtype, device=device)
    return {
        "embed": L.embedding_init(generator, cfg.vocab, cfg.d_model, **kw),
        "final_norm": L.rmsnorm_init(cfg.d_model, **kw),
        "lm_head": L.linear_init(generator, cfg.d_model, cfg.vocab, **kw),
        "layers": B.transformer_block_init(generator, cfg, device=device,
                                           lead=(cfg.n_layers,)),
    }


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 has no torch counterpart in from_numpy:
        # reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: PyTree, cfg: ArchConfig, device="cuda") -> PyTree:
    """The port's parameters from the JAX ``init_params`` pytree converted
    leaf by leaf to numpy (``jax.tree.map(np.asarray, params)``)."""
    _check_family(cfg)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _to_tensor(np.asarray(x)).to(device)
    return conv(tree)


def _layer(tree: PyTree, i: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _head(params: PyTree, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.linear(params["lm_head"], x, cfg.cdtype)


def init_decode_state(cfg: ArchConfig, batch_size: int, max_len: int,
                      device="cuda") -> PyTree:
    _check_family(cfg)
    kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"len": torch.zeros((batch_size,), dtype=torch.int32,
                               device=device),
            "cache_k": torch.zeros(kv, dtype=cfg.cdtype, device=device),
            "cache_v": torch.zeros(kv, dtype=cfg.cdtype, device=device)}


def _store(cache: torch.Tensor, layer: int, got: torch.Tensor) -> None:
    """Land a layer's returned cache in the state (a no-op for the fused
    kernels, which updated ``cache[layer]`` in place)."""
    if got.data_ptr() != cache[layer].data_ptr():
        cache[layer].copy_(got)


def decode_step(params: PyTree, cfg: ArchConfig, state: PyTree, batch: dict,
                *, kernel_mode: str = "reference", seq_tile: int = 128,
                length_mask: bool = True, dynamic_grid: bool = False,
                num_kv_splits: int = 1, port_mix: str = "wr"
                ) -> tuple[PyTree, torch.Tensor]:
    """One new token per sequence. Returns (state', logits [B, V]); the
    caches of ``state`` are updated in place (see the module docstring).

    ``seq_tile``/``length_mask`` bound the fused kernel's traversal to live
    cache tiles."""
    _check_family(cfg)
    x = L.embedding_lookup(params["embed"], batch["inputs"], cfg.cdtype)
    ck, cv, lens = state["cache_k"], state["cache_v"], state["len"]
    for i in range(cfg.n_layers):
        x, k_i, v_i = B.transformer_block_decode(
            _layer(params["layers"], i), x, ck[i], cv[i], lens, cfg,
            kernel_mode=kernel_mode, seq_tile=seq_tile,
            length_mask=length_mask, dynamic_grid=dynamic_grid,
            num_kv_splits=num_kv_splits, port_mix=port_mix)
        _store(ck, i, k_i)
        _store(cv, i, v_i)
    logits = _head(params, cfg, x)[:, 0]
    return dict(state, len=lens + 1), logits


def prefill_chunk(params: PyTree, cfg: ArchConfig, state: PyTree, batch: dict,
                  *, kernel_mode: str = "reference", seq_tile: int = 128,
                  dynamic_grid: bool = False, port_mix: str = "wr"
                  ) -> tuple[PyTree, torch.Tensor]:
    """Process ONE fixed-size prompt chunk for a batch of sequences.

    batch: {"inputs": ids [B, C], "chunk_len": [B] valid rows per sequence}.
    Every chunk's K,V is written at [len, len+chunk_len) while attention
    reads back over everything cached so far. Returns (state', logits
    [B, V]) with each row's logits taken at its LAST VALID chunk position;
    the caches of ``state`` are updated in place.
    """
    _check_family(cfg)
    inputs = batch["inputs"]
    c = inputs.shape[1]
    chunk_len = torch.as_tensor(batch["chunk_len"], dtype=torch.int32,
                                device=inputs.device)
    offset = state["len"]
    x = L.embedding_lookup(params["embed"], inputs, cfg.cdtype)
    ck, cv = state["cache_k"], state["cache_v"]
    for i in range(cfg.n_layers):
        x, k_i, v_i = B.transformer_block_prefill_chunk(
            _layer(params["layers"], i), x, offset, chunk_len, ck[i], cv[i],
            cfg, kernel_mode=kernel_mode, seq_tile=seq_tile,
            dynamic_grid=dynamic_grid, port_mix=port_mix)
        _store(ck, i, k_i)
        _store(cv, i, v_i)
    last = torch.clamp(chunk_len.long() - 1, 0, c - 1)
    xl = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    logits = _head(params, cfg, xl)[:, 0]
    return dict(state, len=offset + chunk_len), logits
