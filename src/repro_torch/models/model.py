"""Model assembly for the KV-cache families (dense, moe, vlm, audio): init,
the whole-prompt forward and prefill, decode state, decode step and chunked
prefill, the training loss, plus the bridge that carries the JAX package's
parameters across. The ssm and hybrid families come with ROADMAP item A9b.

Batch dict convention, as in the JAX package: ``"inputs"`` holds token ids
[B, S] (``input_mode="tokens"``) or embeddings [B, S, d]
(``"embeddings"``, the VLM and audio stubs' frontend output);
``"positions"`` is optional, [B, S] for rope and [B, S, 3] (t, h, w) for
mrope.

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
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

PyTree = Any


KV_FAMILIES = ("dense", "moe", "vlm", "audio")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in KV_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (the port has "
            f"{'/'.join(KV_FAMILIES)}; ssm and hybrid come with ROADMAP "
            f"item A9b)")


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> PyTree:
    """Random parameters with the JAX package's shapes and distributions
    (``models/layers.py`` there): embeddings N(0, 1), linear weights
    N(0, 1/fan_in), MoE routers N(0, 0.02), norm scales 1; no ``embed``
    for an embedding-input model. ``generator`` lives on ``device``."""
    _check_family(cfg)
    kw = dict(dtype=cfg.pdtype, device=device)
    p = {}
    if cfg.input_mode == "tokens":
        p["embed"] = L.embedding_init(generator, cfg.vocab, cfg.d_model, **kw)
    p["final_norm"] = L.rmsnorm_init(cfg.d_model, **kw)
    p["lm_head"] = L.linear_init(generator, cfg.d_model, cfg.vocab, **kw)
    p["layers"] = B.transformer_block_init(generator, cfg, device=device,
                                           lead=(cfg.n_layers,))
    return p


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
    leaf by leaf to numpy (the JAX ``tree.map(np.asarray, params)``)."""
    _check_family(cfg)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _to_tensor(np.asarray(x)).to(device)
    return conv(tree)


def _unbind_layers(tree: PyTree, n: int) -> list[PyTree]:
    """The n per-layer trees of a stacked [n, ...] tree, each leaf unbound
    once: views equal to ``tree[i]``. Under autograd the backward of one
    ``unbind`` is one ``stack``, where n separate ``tree[i]`` would each
    add a zero tensor of the whole stack."""
    if isinstance(tree, dict):
        per_key = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _head(params: PyTree, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.linear(params["lm_head"], x, cfg.cdtype)


def _stem(params: PyTree, cfg: ArchConfig, inputs: torch.Tensor,
          offset: torch.Tensor | int = 0) -> torch.Tensor:
    """Token lookup or embedding input, plus the sinusoidal positions of
    an audio model at ``offset`` (an int, or per-row offsets [B])."""
    if cfg.input_mode == "tokens":
        x = L.embedding_lookup(params["embed"], inputs, cfg.cdtype)
    else:
        x = inputs.to(cfg.cdtype)
    if cfg.pos_embed == "sinusoidal":
        pe = L.sinusoidal_positions(x.shape[1], cfg.d_model, offset, x.device)
        x = x + pe.to(x.dtype)
    return x


def _default_positions(cfg: ArchConfig, batch: dict, b: int, s: int,
                       device) -> torch.Tensor:
    pos = batch.get("positions")
    if pos is not None:
        return pos
    base = torch.arange(s, device=device)[None]
    if cfg.pos_embed == "mrope":
        return base[..., None].expand(b, s, 3)
    return base.expand(b, s)


def forward(params: PyTree, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole sequence at once. batch: {"inputs": ids [B, S] or
    embeddings [B, S, d], optional "positions"}. Returns (logits [B, S, V],
    the MoE aux loss summed over layers; 0 without experts).

    Under autograd with ``cfg.remat == "block"`` each block is
    recomputed in the backward instead of keeping its activations, as the
    JAX package's ``jax.checkpoint`` of the scanned block."""
    _check_family(cfg)
    inputs = batch["inputs"]
    b, s = inputs.shape[:2]
    positions = _default_positions(cfg, batch, b, s, inputs.device)
    x = _stem(params, cfg, inputs)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = (cfg.remat == "block" and torch.is_grad_enabled()
             and any(x.requires_grad for x in T.leaves(params["layers"])))
    for p in _unbind_layers(params["layers"], cfg.n_layers):
        if remat:
            x, a = checkpoint(B.transformer_block_apply, p, x, positions, cfg,
                              use_reentrant=False)
        else:
            x, a = B.transformer_block_apply(p, x, positions, cfg)
        aux = aux + a
    return _head(params, cfg, x), aux


def loss_fn(params: PyTree, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy + z-loss + the MoE aux loss. batch: the
    ``forward`` batch plus "labels" [B, S]; labels < 0 are masked. Returns
    (loss, {"loss", "ce", "z_loss", "moe_aux", "accuracy", "tokens"}).

    The max logit is held constant under differentiation (the JAX
    package's ``stop_gradient``). The gold logit is gathered where the JAX
    package sums a one-hot ``where``: both pick the one f32 value exactly,
    and the gather builds no [B, S, V] mask."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"].long()
    mask = labels >= 0
    labels = torch.clamp(labels, min=0)
    lf = logits.to(torch.float32)
    m = lf.amax(dim=-1).detach()
    lse = m + torch.log(torch.sum(torch.exp(lf - m[..., None]), dim=-1))
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    count = torch.clamp(mask.sum(), min=1).to(torch.int32)
    ce = nll.sum() / count
    zl = cfg.z_loss * ((lse * mask) ** 2).sum() / count
    loss = ce + zl + aux
    acc = ((lf.argmax(-1) == labels) * mask).sum() / count
    return loss, {"loss": loss, "ce": ce, "z_loss": zl, "moe_aux": aux,
                  "accuracy": acc, "tokens": count}


def prefill(params: PyTree, cfg: ArchConfig, state: PyTree, batch: dict
            ) -> tuple[PyTree, torch.Tensor]:
    """Process a prompt of length S, writing its K,V at [0, S) of the
    caches of ``state`` in place. Returns (state' with ``len`` + S, logits
    of the last position [B, V])."""
    _check_family(cfg)
    inputs = batch["inputs"]
    b, s = inputs.shape[:2]
    positions = _default_positions(cfg, batch, b, s, inputs.device)
    x = _stem(params, cfg, inputs)
    ck, cv = state["cache_k"], state["cache_v"]
    # each layer writes ck[i], cv[i] in place
    for i, p in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
        x, _, _ = B.transformer_block_prefill(
            p, x, positions, ck[i], cv[i], cfg)
    logits = _head(params, cfg, x[:, -1:])[:, 0]
    return dict(state, len=state["len"] + s), logits


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
    ck, cv, lens = state["cache_k"], state["cache_v"], state["len"]
    x = _stem(params, cfg, batch["inputs"], offset=lens)
    for i, p in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
        x, k_i, v_i = B.transformer_block_decode(
            p, x, ck[i], cv[i], lens, cfg,
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

    batch: {"inputs": ids [B, C] or embeddings [B, C, d], "chunk_len": [B]
    valid rows per sequence}.
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
    x = _stem(params, cfg, inputs, offset=offset)
    ck, cv = state["cache_k"], state["cache_v"]
    for i, p in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
        x, k_i, v_i = B.transformer_block_prefill_chunk(
            p, x, offset, chunk_len, ck[i], cv[i],
            cfg, kernel_mode=kernel_mode, seq_tile=seq_tile,
            dynamic_grid=dynamic_grid, port_mix=port_mix)
        _store(ck, i, k_i)
        _store(cv, i, v_i)
    last = torch.clamp(chunk_len.long() - 1, 0, c - 1)
    xl = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    logits = _head(params, cfg, xl)[:, 0]
    return dict(state, len=offset + chunk_len), logits
