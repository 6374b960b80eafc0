"""Plain-torch oracles (ports of the JAX package's ``kernels/ref.py``).

These are the two-pass (single-port) baselines the engine's
``kernel_mode="reference"`` and the ``port_mix="w+r"`` degrade path use:
append first, then attend over the whole cache. They are functional (the
caches come back as new tensors) and are distinct from the plain versions
that sit beside each CUDA kernel, which mirror the kernel's own contract
(in-place update, dead rows, tile counts).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import multiport as mp
from repro_torch.core.ports import PortConfig, PortRequest


def multiport_step_ref(spec: mp.MemorySpec, config: PortConfig,
                       storage: torch.Tensor, requests: Sequence[PortRequest]
                       ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The executable semantic spec from core.multiport (sequential service)."""
    return mp.step(spec, config, storage, requests)


def decode_attention_ref(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, new_k: torch.Tensor,
                         new_v: torch.Tensor, cache_len: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-pass (single-port) decode: append, then attend. [B,H,D] out.

    The append indexes like the JAX oracle: a negative ``cache_len`` wraps
    to the end of the cache."""
    b, s, hkv, d = cache_k.shape
    h = q.shape[1]
    g = h // hkv
    bidx = torch.arange(b, device=q.device)
    pos = cache_len.long()
    cache_k = cache_k.clone()
    cache_v = cache_v.clone()
    cache_k[bidx, pos] = new_k.to(cache_k.dtype)
    cache_v[bidx, pos] = new_v.to(cache_v.dtype)

    f32 = torch.float32
    qg = q.reshape(b, hkv, g, d).to(f32)
    s_ = torch.einsum("bhgd,bshd->bhgs", qg, cache_k.to(f32)) / (d ** 0.5)
    kpos = torch.arange(s, device=q.device)
    valid = (kpos[None] <= pos[:, None])[:, None, None, :]
    s_ = s_.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s_, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(f32), cache_v.to(f32))
    return out.reshape(b, h, d).to(q.dtype), cache_k, cache_v


def prefill_chunk_attention_ref(q: torch.Tensor, cache_k: torch.Tensor,
                                cache_v: torch.Tensor, new_k: torch.Tensor,
                                new_v: torch.Tensor, offset: torch.Tensor,
                                chunk_len: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Two-pass chunked-prefill oracle: scatter the chunk's K,V at
    [offset, offset+chunk_len), then attend causally over the WHOLE cache.

    q: [B, C, H, D]; cache_k/v: [B, S, Hkv, D]; new_k/v: [B, C, Hkv, D];
    offset/chunk_len: [B]. Padded rows (>= chunk_len) replicate position
    ``offset`` so their softmax stays finite; outputs there are discarded by
    callers. Returns (out [B, C, H, D], cache_k', cache_v').
    """
    b, c, h, d = q.shape
    s_max = cache_k.shape[1]
    hkv = cache_k.shape[2]
    g = h // hkv
    dev = q.device
    rel = torch.arange(c, device=dev)
    offset = offset.long()
    positions = offset[:, None] + rel[None, :]                    # [B, C]
    valid = rel[None, :] < chunk_len.long()[:, None]              # [B, C]

    # W port: scatter valid chunk rows; rows outside the cache are dropped
    keep = valid & (positions >= 0) & (positions < s_max)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, c)
    cache_k = cache_k.clone()
    cache_v = cache_v.clone()
    cache_k[bidx[keep], positions[keep]] = new_k[keep].to(cache_k.dtype)
    cache_v[bidx[keep], positions[keep]] = new_v[keep].to(cache_v.dtype)

    # R port: dense causal attention over the updated cache
    f32 = torch.float32
    qg = q.reshape(b, c, hkv, g, d)
    scale = 1.0 / (d ** 0.5)
    sc = torch.einsum("bchgd,bshd->bchgs", qg.to(f32),
                      cache_k.to(q.dtype).to(f32)) * scale
    kpos = torch.arange(s_max, device=dev)
    qpos = torch.where(valid, positions, offset[:, None])
    mask = kpos[None, None, :] <= qpos[..., None]                 # [B, C, S]
    sc = sc.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    pr = torch.softmax(sc, dim=-1).to(cache_v.dtype)
    oc = torch.einsum("bchgs,bshd->bchgd", pr.to(f32), cache_v.to(f32))
    return oc.to(q.dtype).reshape(b, c, h, d), cache_k, cache_v
