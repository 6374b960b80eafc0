"""MultiPortMemory — the paper's wrapper + SRAM macro, on torch tensors.

Semantics (the contract all kernels are tested against):

* Storage is a word-addressable array ``[num_words, word_width]`` (the 6T SRAM
  macro). Banking is an implementation detail invisible to the semantics.
* One ``step`` is one macro-cycle (one external CLK period). Each of the up-to-4
  ports presents a queue of Q word transactions (addr, data, mask).
* Ports are serviced **strictly sequentially in priority order** (contention
  freedom, paper §II-A-3/4): a read port observes every write issued by
  higher-priority ports in the same macro-cycle, and none from lower-priority
  ports. Two write ports hitting the same word resolve to the lower-priority
  (later-serviced) port's value.
* Within one write port's queue, duplicate addresses resolve in queue order
  (last valid lane wins).
* Masked-off lanes issue no transaction; reads of masked lanes return 0.

``step`` below is the executable specification in plain torch (the oracle
for the CUDA kernel in ``repro_torch.kernels.multiport_sram``); it returns a
new storage tensor. ``step_banked`` is the performance path: it dispatches to
the kernel, which updates the storage IN PLACE and returns it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import fsm
from repro_torch.core.ports import MAX_PORTS, WRITE, PortConfig, PortRequest


@dataclasses.dataclass(frozen=True)
class MemorySpec:
    """Static geometry of the physical macro."""

    num_words: int
    word_width: int
    dtype: torch.dtype = torch.float32
    num_banks: int = 8

    def __post_init__(self):
        if self.num_words % self.num_banks:
            raise ValueError("num_words must divide evenly into banks")

    @property
    def words_per_bank(self) -> int:
        return self.num_words // self.num_banks

    def init_storage(self, value: float = 0.0, device="cuda") -> torch.Tensor:
        """The storage array, on the card unless ``device="cpu"``."""
        return torch.full((self.num_words, self.word_width), value,
                          dtype=self.dtype, device=_device.resolve(device))

    def nbytes(self) -> int:
        return (self.num_words * self.word_width
                * torch.empty((), dtype=self.dtype).element_size())


def _dedup_last_wins(addr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Keep only the last valid occurrence of each address (queue order).

    The same mask as ``mask[i] and not any(addr[j] == addr[i] and mask[j]
    for j > i)``, computed from a stable sort of the lanes by address
    instead of a ``[Q, Q]`` comparison (Q reaches the thousands at the
    engine's read-lane buckets): the last lane of each run of equal
    addresses wins. Masked-off lanes sort under keys of their own, above
    every int32 address. Every tensor has a size fixed by Q, so nothing
    here waits on the card."""
    q = addr.shape[0]
    if q == 0:
        return mask.clone()
    lane = torch.arange(q, device=addr.device)
    key = torch.where(mask, addr.long(), lane + (1 << 32))
    keys, order = torch.sort(key, stable=True)
    last = torch.ones_like(mask)
    last[:-1] = keys[1:] != keys[:-1]                 # last lane of its run
    return mask & torch.empty_like(mask).scatter_(0, order, last)


def _normalize(addr: torch.Tensor, num_words: int) -> torch.Tensor:
    """Python-style negative addressing (``-1`` is the last word), as the
    JAX package's indexed updates do; anything still outside
    ``[0, num_words)`` is a dropped transaction."""
    addr = addr.long()
    return torch.where(addr < 0, addr + num_words, addr)


def _service_write(storage: torch.Tensor, req: PortRequest,
                   num_words: int) -> torch.Tensor:
    addr = _normalize(req.addr, num_words)
    eff = _dedup_last_wins(addr, req.mask) & (addr >= 0) & (addr < num_words)
    storage[addr[eff]] = req.data[eff].to(storage.dtype)
    return storage


def _service_read(storage: torch.Tensor, req: PortRequest,
                  num_words: int) -> torch.Tensor:
    addr = _normalize(req.addr, num_words)
    ok = req.mask & (addr >= 0) & (addr < num_words)
    out = storage[torch.where(ok, addr, 0)]
    return torch.where(ok[:, None], out, torch.zeros_like(out))


def step(spec: MemorySpec, config: PortConfig, storage: torch.Tensor,
         requests: Sequence[PortRequest]
         ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """One macro-cycle: service all enabled ports in priority order.

    Args:
      spec: memory geometry.
      config: static port configuration.
      storage: ``[num_words, word_width]`` (not modified).
      requests: MAX_PORTS request bundles (disabled ports' entries ignored).

    Returns:
      (new_storage, reads) where reads[p] is ``[Q, word_width]`` for read
      ports and zeros for write/disabled ports.
    """
    if len(requests) != MAX_PORTS:
        raise ValueError(f"expected {MAX_PORTS} request bundles")
    q = requests[0].queue_len
    reads = [torch.zeros((q, spec.word_width), dtype=spec.dtype,
                         device=storage.device) for _ in range(MAX_PORTS)]

    def service(state, port):
        storage, reads = state
        req = requests[port]
        if config.roles[port] == WRITE:
            storage = _service_write(storage, req, spec.num_words)
        else:
            reads[port] = _service_read(storage, req, spec.num_words)
        return (storage, reads)

    storage, reads = fsm.walk_static(config, (storage.clone(), reads),
                                     service)
    return storage, reads


def step_banked(spec: MemorySpec, config: PortConfig, storage: torch.Tensor,
                requests: Sequence[PortRequest]
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Performance path: one physical traversal services all ports (the
    hand-written kernel on CUDA tensors). Updates ``storage`` in place."""
    from repro_torch.kernels import ops  # local import: kernels depend on core

    return ops.multiport_step(spec, config, storage, list(requests))


# ---------------------------------------------------------------------------
# Reference simulator (plain Python/numpy) — the ground truth for property
# tests. Deliberately scalar and boring: services ports in priority order,
# lanes in queue order, exactly like the hardware walks internal clock slots.
# ---------------------------------------------------------------------------

def reference_step(spec: MemorySpec, config: PortConfig, storage,
                   requests: Sequence[PortRequest]
                   ) -> tuple[np.ndarray, list[np.ndarray]]:
    storage = np.array(torch.as_tensor(storage).cpu().float(), copy=True)
    q = int(requests[0].addr.shape[0])
    reads = [np.zeros((q, spec.word_width), storage.dtype)
             for _ in range(MAX_PORTS)]
    for port in config.service_order():
        req = requests[port]
        addr = req.addr.cpu().numpy()
        data = req.data.cpu().float().numpy()
        mask = req.mask.cpu().numpy()
        if config.roles[port] == WRITE:
            for lane in range(q):                      # queue order: last wins
                if mask[lane] and 0 <= addr[lane] < spec.num_words:
                    storage[addr[lane]] = data[lane]
        else:
            for lane in range(q):
                if mask[lane] and 0 <= addr[lane] < spec.num_words:
                    reads[port][lane] = storage[addr[lane]]
    return storage, reads
