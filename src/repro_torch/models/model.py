"""Model assembly for all six families: init, the whole-prompt forward
and prefill, decode state, decode step and chunked prefill, the training
loss, plus the bridge that carries the JAX package's parameters across.

Families: the KV-cache families (dense, moe, vlm, audio) stack one
transformer block per layer; ``"ssm"`` (rwkv6) stacks RWKV6 blocks;
``"hybrid"`` (zamba2) runs one SHARED transformer block before every group
of ``hybrid.group_size`` Mamba2 blocks, then the leftover Mamba2 blocks
(the tail).

Batch dict convention, as in the JAX package: ``"inputs"`` holds token ids
[B, S] (``input_mode="tokens"``) or embeddings [B, S, d]
(``"embeddings"``, the VLM and audio stubs' frontend output);
``"positions"`` is optional, [B, S] for rope and [B, S, 3] (t, h, w) for
mrope.

Parameters are a nested dict of tensors shaped exactly like the JAX
package's pytree: block leaves are stacked on leading axes ([n_layers];
for the hybrid family ``groups`` [g, m, ...] and ``tail`` [tail, ...]),
and each layer loop (``lax.scan`` there) is a Python loop over those axes
here. A stacked decode-state tensor indexed at a layer is a contiguous
view, so the fused kernels' in-place update lands in the caller's state;
what a layer returns instead (the two-pass reference path's caches, the
recurrent states) is copied back into the same view, so every entry point
updates the decode state it is given in place.

Decode state is a dict with a shared ``"len"`` [B] int32 field and, as in
the JAX package: ``cache_k``/``cache_v`` [L, B, S, Hkv, D] (KV-cache
families); ``tm_shift``/``cm_shift`` [L, B, d] and ``tm_state``
[L, B, H, K, K] f32 (ssm); ``attn_k``/``attn_v`` [g, B, S, Hkv, D],
``conv`` {x, B, C} [g, m, B, K-1, C], ``ssm`` [g, m, B, H, N, P] f32 and
``tail_conv``/``tail_ssm`` (hybrid).
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


def _hybrid_counts(cfg: ArchConfig) -> tuple[int, int, int]:
    """(groups, Mamba2 blocks a group, tail blocks) of a hybrid model."""
    g = cfg.n_layers // cfg.hybrid.group_size
    m = cfg.hybrid.group_size
    return g, m, cfg.n_layers - g * m


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> PyTree:
    """Random parameters with the JAX package's shapes and distributions
    (``models/layers.py``, ``rwkv.py`` and ``ssm.py`` there): embeddings
    N(0, 1), linear weights N(0, 1/fan_in), MoE routers N(0, 0.02), norm
    scales 1; no ``embed`` for an embedding-input model. ``generator``
    lives on ``device``."""
    kw = dict(dtype=cfg.pdtype, device=device)
    p = {}
    if cfg.input_mode == "tokens":
        p["embed"] = L.embedding_init(generator, cfg.vocab, cfg.d_model, **kw)
    p["final_norm"] = L.rmsnorm_init(cfg.d_model, **kw)
    p["lm_head"] = L.linear_init(generator, cfg.d_model, cfg.vocab, **kw)
    if cfg.family in KV_FAMILIES:
        p["layers"] = B.transformer_block_init(generator, cfg, device=device,
                                               lead=(cfg.n_layers,))
    elif cfg.family == "ssm":
        p["layers"] = B.rwkv_block_init(generator, cfg, device=device,
                                        lead=(cfg.n_layers,))
    elif cfg.family == "hybrid":
        g, m, tail = _hybrid_counts(cfg)
        p["shared_attn"] = B.transformer_block_init(
            generator, cfg, d_ff=cfg.hybrid.attn_d_ff, device=device)
        p["groups"] = B.mamba_block_init(generator, cfg, device=device,
                                         lead=(g, m))
        if tail:
            p["tail"] = B.mamba_block_init(generator, cfg, device=device,
                                           lead=(tail,))
    else:
        raise ValueError(cfg.family)
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


def _remat(cfg: ArchConfig, params: PyTree) -> bool:
    """Recompute each block in the backward (``cfg.remat == "block"``)
    when a backward will run: grads on and a parameter that wants one."""
    return (cfg.remat == "block" and torch.is_grad_enabled()
            and any(x.requires_grad for x in T.leaves(params)))


def _run(remat: bool, fn, *args):
    """``fn(*args)``, checkpointed under remat (the JAX package's
    ``jax.checkpoint`` of the scanned body)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _hybrid_group(shared: dict, pg: PyTree, x, positions, cfg: ArchConfig,
                  m: int):
    """One group of the hybrid forward: the shared block, then the
    group's m Mamba2 blocks (the JAX package's ``group_body``)."""
    x, _ = B.transformer_block_apply(shared, x, positions, cfg)
    for p in _unbind_layers(pg, m):
        x = B.mamba_block_apply(p, x, cfg)
    return x


def forward(params: PyTree, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole sequence at once. batch: {"inputs": ids [B, S] or
    embeddings [B, S, d], optional "positions"}. Returns (logits [B, S, V],
    the MoE aux loss summed over layers; 0 without experts).

    Under autograd with ``cfg.remat == "block"`` each block (for the
    hybrid family each group, the shared block with its Mamba2 blocks,
    and each tail block) is recomputed in the backward instead of keeping
    its activations, as the JAX package's ``jax.checkpoint`` of the
    scanned body."""
    inputs = batch["inputs"]
    b, s = inputs.shape[:2]
    x = _stem(params, cfg, inputs)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _remat(cfg, params)
    if cfg.family == "ssm":
        for p in _unbind_layers(params["layers"], cfg.n_layers):
            x = _run(remat, B.rwkv_block_apply, p, x, cfg)
        return _head(params, cfg, x), aux
    positions = _default_positions(cfg, batch, b, s, inputs.device)
    if cfg.family == "hybrid":
        g, m, tail = _hybrid_counts(cfg)
        for pg in _unbind_layers(params["groups"], g):
            x = _run(remat, _hybrid_group, params["shared_attn"], pg, x,
                     positions, cfg, m)
        for p in _unbind_layers(params.get("tail", {}), tail):
            x = _run(remat, B.mamba_block_apply, p, x, cfg)
        return _head(params, cfg, x), aux
    for p in _unbind_layers(params["layers"], cfg.n_layers):
        x, a = _run(remat, B.transformer_block_apply, p, x, positions, cfg)
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


def _put(state: PyTree, at: tuple, got: PyTree) -> None:
    """Land a layer's returned state (a tensor or a dict of them) in the
    stacked state at index ``at`` (a no-op where ``got`` already is that
    slice, as the fused kernels' caches updated in place are)."""
    if isinstance(state, dict):
        for k in state:
            _put(state[k], at, got[k])
    elif got.data_ptr() != state[at].data_ptr():
        state[at].copy_(got)


def _mamba_prefill(p: dict, x, cfg: ArchConfig, conv: dict,
                   ssm: torch.Tensor, at: tuple):
    """A Mamba2 block over the prompt, its states landed at ``at``. As in
    the JAX package, the conv state starts from zero and the SSM state is
    carried in from the state given."""
    x, cs, ss = B.mamba_block_apply(p, x, cfg, conv_state=None,
                                    ssm_state=ssm[at], return_state=True)
    _put(conv, at, cs)
    _put(ssm, at, ss)
    return x


def prefill(params: PyTree, cfg: ArchConfig, state: PyTree, batch: dict
            ) -> tuple[PyTree, torch.Tensor]:
    """Process a prompt of length S, writing its K,V at [0, S) of the
    caches of ``state`` and the recurrent states, in place. Returns
    (state' with ``len`` + S, logits of the last position [B, V])."""
    inputs = batch["inputs"]
    b, s = inputs.shape[:2]
    x = _stem(params, cfg, inputs)
    if cfg.family == "ssm":
        tm_state = state["tm_state"]
        for i, p in enumerate(_unbind_layers(params["layers"],
                                             cfg.n_layers)):
            # as in the JAX package: the shift states start from zero,
            # the time-mix state is carried in
            x, st = B.rwkv_block_apply(p, x, cfg,
                                       states=(None, tm_state[i], None),
                                       return_state=True)
            for key, got in zip(("tm_shift", "tm_state", "cm_shift"), st):
                _put(state[key], (i,), got)
    elif cfg.family == "hybrid":
        positions = _default_positions(cfg, batch, b, s, inputs.device)
        g, m, tail = _hybrid_counts(cfg)
        ck, cv = state["attn_k"], state["attn_v"]
        for gi, pg in enumerate(_unbind_layers(params["groups"], g)):
            x, _, _ = B.transformer_block_prefill(
                params["shared_attn"], x, positions, ck[gi], cv[gi], cfg)
            for mi, p in enumerate(_unbind_layers(pg, m)):
                x = _mamba_prefill(p, x, cfg, state["conv"], state["ssm"],
                                   (gi, mi))
        for ti, p in enumerate(_unbind_layers(params.get("tail", {}), tail)):
            x = _mamba_prefill(p, x, cfg, state["tail_conv"],
                               state["tail_ssm"], (ti,))
    else:
        positions = _default_positions(cfg, batch, b, s, inputs.device)
        ck, cv = state["cache_k"], state["cache_v"]
        # each layer writes ck[i], cv[i] in place
        for i, p in enumerate(_unbind_layers(params["layers"],
                                             cfg.n_layers)):
            x, _, _ = B.transformer_block_prefill(
                p, x, positions, ck[i], cv[i], cfg)
    logits = _head(params, cfg, x[:, -1:])[:, 0]
    return dict(state, len=state["len"] + s), logits


def init_decode_state(cfg: ArchConfig, batch_size: int, max_len: int,
                      device="cuda") -> PyTree:
    """Zeros in the JAX package's decode-state tree (module docstring):
    caches and shift states in the compute dtype, recurrent states f32."""
    cdt, f32 = cfg.cdtype, torch.float32

    def zeros(shape, dtype=cdt):
        return torch.zeros(shape, dtype=dtype, device=device)
    state = {"len": zeros((batch_size,), torch.int32)}
    if cfg.family in KV_FAMILIES:
        kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
              cfg.head_dim_)
        state["cache_k"], state["cache_v"] = zeros(kv), zeros(kv)
    elif cfg.family == "ssm":
        h, k = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
        lead = (cfg.n_layers, batch_size)
        state["tm_shift"] = zeros(lead + (cfg.d_model,))
        state["tm_state"] = zeros(lead + (h, k, k), f32)
        state["cm_shift"] = zeros(lead + (cfg.d_model,))
    elif cfg.family == "hybrid":
        g, m, tail = _hybrid_counts(cfg)
        ssm = cfg.ssm
        d_in = ssm.expand * cfg.d_model
        nheads = d_in // ssm.head_dim
        kv = (g, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim_)
        state["attn_k"], state["attn_v"] = zeros(kv), zeros(kv)

        def conv_states(*lead):
            ck = ssm.conv_kernel - 1
            return {"x": zeros(lead + (batch_size, ck, d_in)),
                    "B": zeros(lead + (batch_size, ck, ssm.state_dim)),
                    "C": zeros(lead + (batch_size, ck, ssm.state_dim))}
        rec = (batch_size, nheads, ssm.state_dim, ssm.head_dim)
        state["conv"] = conv_states(g, m)
        state["ssm"] = zeros((g, m) + rec, f32)
        if tail:
            state["tail_conv"] = conv_states(tail)
            state["tail_ssm"] = zeros((tail,) + rec, f32)
    else:
        raise ValueError(cfg.family)
    return state


def decode_step(params: PyTree, cfg: ArchConfig, state: PyTree, batch: dict,
                *, kernel_mode: str = "reference", seq_tile: int = 128,
                length_mask: bool = True, dynamic_grid: bool = False,
                num_kv_splits: int = 1, mesh=None, mesh_axis: str = "kv",
                port_mix: str = "wr") -> tuple[PyTree, torch.Tensor]:
    """One new token per sequence. Returns (state', logits [B, V]); the
    decode state is updated in place (see the module docstring).

    ``seq_tile``/``length_mask`` bound the fused kernel's traversal to live
    cache tiles; ``mesh`` (data-parallel KV) runs it once per shard of the
    batch rows. The kernel modes and options reach the attention layers:
    every layer of a KV-cache family, the hybrid family's shared block
    once a group; the ssm family has none."""
    lens = state["len"]
    x = _stem(params, cfg, batch["inputs"], offset=lens)
    attn = dict(kernel_mode=kernel_mode, seq_tile=seq_tile,
                length_mask=length_mask, dynamic_grid=dynamic_grid,
                num_kv_splits=num_kv_splits, mesh=mesh,
                mesh_axis=mesh_axis, port_mix=port_mix)
    if cfg.family == "ssm":
        keys = ("tm_shift", "tm_state", "cm_shift")
        for i, p in enumerate(_unbind_layers(params["layers"],
                                             cfg.n_layers)):
            x, st = B.rwkv_block_decode(p, x, cfg,
                                        tuple(state[k][i] for k in keys))
            for key, got in zip(keys, st):
                _put(state[key], (i,), got)
    elif cfg.family == "hybrid":
        g, m, tail = _hybrid_counts(cfg)
        ck, cv = state["attn_k"], state["attn_v"]

        def mamba(p, x, conv, ssm, at):
            x, cs, ss = B.mamba_block_decode(
                p, x, cfg, {k: v[at] for k, v in conv.items()}, ssm[at])
            _put(conv, at, cs)
            _put(ssm, at, ss)
            return x
        for gi, pg in enumerate(_unbind_layers(params["groups"], g)):
            x, k_i, v_i = B.transformer_block_decode(
                params["shared_attn"], x, ck[gi], cv[gi], lens, cfg, **attn)
            _put(ck, (gi,), k_i)
            _put(cv, (gi,), v_i)
            for mi, p in enumerate(_unbind_layers(pg, m)):
                x = mamba(p, x, state["conv"], state["ssm"], (gi, mi))
        for ti, p in enumerate(_unbind_layers(params.get("tail", {}), tail)):
            x = mamba(p, x, state["tail_conv"], state["tail_ssm"], (ti,))
    else:
        ck, cv = state["cache_k"], state["cache_v"]
        for i, p in enumerate(_unbind_layers(params["layers"],
                                             cfg.n_layers)):
            x, k_i, v_i = B.transformer_block_decode(p, x, ck[i], cv[i],
                                                     lens, cfg, **attn)
            _put(ck, (i,), k_i)
            _put(cv, (i,), v_i)
    logits = _head(params, cfg, x)[:, 0]
    return dict(state, len=lens + 1), logits


def prefill_chunk(params: PyTree, cfg: ArchConfig, state: PyTree, batch: dict,
                  *, kernel_mode: str = "reference", seq_tile: int = 128,
                  dynamic_grid: bool = False, mesh=None,
                  mesh_axis: str = "kv", port_mix: str = "wr"
                  ) -> tuple[PyTree, torch.Tensor]:
    """Process ONE fixed-size prompt chunk for a batch of sequences of a
    KV-cache family (the ssm and hybrid families raise, as in the JAX
    package).

    batch: {"inputs": ids [B, C] or embeddings [B, C, d], "chunk_len": [B]
    valid rows per sequence}.
    Every chunk's K,V is written at [len, len+chunk_len) while attention
    reads back over everything cached so far. Returns (state', logits
    [B, V]) with each row's logits taken at its LAST VALID chunk position;
    the caches of ``state`` are updated in place.
    """
    if cfg.family not in KV_FAMILIES:
        raise NotImplementedError("chunked prefill serves KV-cache families")
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
            dynamic_grid=dynamic_grid, mesh=mesh, mesh_axis=mesh_axis,
            port_mix=port_mix)
        _put(ck, (i,), k_i)
        _put(cv, (i,), v_i)
    last = torch.clamp(chunk_len.long() - 1, 0, c - 1)
    xl = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    logits = _head(params, cfg, xl)[:, 0]
    return dict(state, len=offset + chunk_len), logits
