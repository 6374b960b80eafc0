"""Public wrappers around the port's kernels.

Each wrapper owns the request preprocessing (packing, write dedup, range
masking) so the kernels stay pure data movement and arithmetic. On CUDA
tensors they launch the hand-written kernels; on CPU tensors the kernels'
plain torch versions run instead.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from repro_torch.core.multiport import MemorySpec, _dedup_last_wins
from repro_torch.core.ports import MAX_PORTS, READ, WRITE, PortConfig, PortRequest
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_multiport as kvmp
from repro_torch.kernels import kv_prefill_chunk as kvpc
from repro_torch.kernels import multiport_sram as mps


def multiport_step(spec: MemorySpec, config: PortConfig,
                   storage: torch.Tensor, requests: Sequence[PortRequest]
                   ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Kernel-backed macro-cycle with the same contract as
    ``core.multiport.step``, except that ``storage`` is updated IN PLACE
    (and returned), and that the result of a write or disabled port is a
    read-only zero view (one element expanded to [Q, W]).

    Only the ENABLED ports' queues are packed and shipped to the kernel (in
    service order), payloads only for the write ports: disabled ports and
    read ports' payloads cost no traffic. Nothing here waits on the card.
    """
    q = requests[0].queue_len
    for r in requests:
        if r.queue_len != q:
            raise ValueError("all port queues must share one queue length")

    order = config.service_order()                    # enabled, priority order
    addrs, masks, payloads = [], [], []
    for p in order:
        r = requests[p]
        m = r.mask
        if config.roles[p] == WRITE:
            m = _dedup_last_wins(r.addr, m)          # last-wins in queue order
            payloads.append(r.data.to(spec.dtype).contiguous())
        in_range = (r.addr >= 0) & (r.addr < spec.num_words)
        m = m & in_range                             # OOB lanes: dropped
        addrs.append(torch.where(m, r.addr, 0))
        masks.append(m)

    addr = torch.stack(addrs).to(torch.int32)         # [P_eff, Q]
    mask = torch.stack(masks)                         # [P_eff, Q]
    packed = mps.multiport_sram_step(
        storage, addr, payloads, mask,
        roles=tuple(config.roles[p] for p in order))  # [P_read, Q, W]
    zeros = torch.zeros((), dtype=spec.dtype,
                        device=storage.device).expand(q, spec.word_width)
    reads = [zeros] * MAX_PORTS
    read_ports = [p for p in order if config.roles[p] == READ]
    for slot, p in enumerate(read_ports):
        reads[p] = packed[slot]
    return storage, reads


def _kv_shard_wrap(kernel, mesh, mesh_axis: str, batch: int):
    """Run a fused KV kernel once per shard of ``mesh_axis`` over the batch
    axis of every operand (``distributed.sharding.shard_apply``, the port's
    ``shard_map``): each shard's launch takes its own rows' lengths, so its
    own live-tile bound and, for the split pair, its own key partition,
    and its caches are updated in place. Returns the kernel unchanged when
    the mesh is absent or trivial."""
    if mesh is None:
        return kernel
    from repro_torch.distributed.sharding import shard_apply
    n = int(mesh.shape[mesh_axis])
    if n == 1:
        return kernel
    if batch % n:
        raise ValueError(
            f"kv-sharded kernel launch needs the batch ({batch}) to divide "
            f"across the {n}-way {mesh_axis!r} axis — pad the staged batch "
            f"to a whole number of rows per device")
    return functools.partial(shard_apply, mesh, kernel, axis=mesh_axis)


def fused_decode_attention(q, cache_k, cache_v, new_k, new_v, cache_len, *,
                           seq_tile: int = 128, live_len: int | None = None,
                           length_mask: bool = True,
                           dynamic_grid: bool = False,
                           num_kv_splits: int = 1, mesh=None,
                           mesh_axis: str = "kv", port_mix: str = "wr"):
    """Scheduled-port-mix decode step (see kv_multiport.py).

    ``port_mix="wr"`` (a 1W+1R traversal is schedulable) runs the fused
    append+attend kernel, updating the caches in place — split over
    ``num_kv_splits`` parallel chains plus a combine when it is > 1;
    ``"w+r"`` (a port budget of 1) degrades to the two-pass oracle
    ``ref.decode_attention_ref``, which returns new caches and has no
    traversal to split (``num_kv_splits`` and ``mesh`` are ignored).
    ``mesh`` (with a ``mesh_axis`` axis) runs the kernel once per shard on
    the shard's contiguous block of rows (``_kv_shard_wrap``); both split
    stages run inside each shard's call."""
    if port_mix == "w+r":
        from repro_torch.kernels import ref
        return ref.decode_attention_ref(q, cache_k, cache_v, new_k, new_v,
                                        cache_len)
    if port_mix != "wr":
        raise ValueError(f"unknown port_mix: {port_mix!r}")
    kernel = functools.partial(kvmp.fused_append_attend, seq_tile=seq_tile,
                               live_len=live_len, length_mask=length_mask,
                               dynamic_grid=dynamic_grid,
                               num_kv_splits=num_kv_splits)
    kernel = _kv_shard_wrap(kernel, mesh, mesh_axis, q.shape[0])
    return kernel(q, cache_k, cache_v, new_k, new_v, cache_len)


def fused_prefill_chunk_attention(q, cache_k, cache_v, new_k, new_v, offset,
                                  chunk_len, *, seq_tile: int = 128,
                                  live_len: int | None = None,
                                  dynamic_grid: bool = False, mesh=None,
                                  mesh_axis: str = "kv",
                                  port_mix: str = "wr"):
    """Scheduled-port-mix chunked-prefill step (see kv_prefill_chunk.py);
    ``"w+r"`` degrades to ``ref.prefill_chunk_attention_ref``. ``mesh``
    shards the launch over the batch axis like the decode wrapper."""
    if port_mix == "w+r":
        from repro_torch.kernels import ref
        return ref.prefill_chunk_attention_ref(q, cache_k, cache_v, new_k,
                                               new_v, offset, chunk_len)
    if port_mix != "wr":
        raise ValueError(f"unknown port_mix: {port_mix!r}")
    kernel = functools.partial(kvpc.fused_chunk_append_attend,
                               seq_tile=seq_tile, live_len=live_len,
                               dynamic_grid=dynamic_grid)
    kernel = _kv_shard_wrap(kernel, mesh, mesh_axis, q.shape[0])
    return kernel(q, cache_k, cache_v, new_k, new_v, offset, chunk_len)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_tile: int = 128,
                    k_tile: int = 128) -> torch.Tensor:
    """Causal (or full) GQA flash attention (see flash_attention.py).
    q: [B, H, Sq, D]; k, v: [B, Hkv, Sk, D]. Returns [B, H, Sq, D]."""
    return fa.flash_attention(q, k, v, causal=causal, q_tile=q_tile,
                              k_tile=k_tile)
