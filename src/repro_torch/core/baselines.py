"""Baseline multi-port memory designs the paper compares against.

Software analogues of the comparison rows in Tables I/II (transistor sharing
inside an 8T/12T bitcell has no software analogue, so footprints are reported
as measured, next to the paper's bitcell-area column):

* ``SinglePortNPass``  — the bare 6T macro without the wrapper: each enabled
  port is serviced by its own full storage traversal (N passes, 1x footprint).
  This is the *bandwidth* baseline for claim C1.
* ``ReplicatedReads``  — the classic bitcell-widening school ([4]-[9]): each
  extra read port is bought with a full storage replica kept coherent on every
  write (all replicas written). R read ports cost R x footprint; this is the
  *area* baseline for claim C2 (8T dual-port ~ 2 copies for 1R1W
  concurrency, 12T quad ~ 2x area in the paper's normalization).
* ``XorCoded``        — paper ref [11] (coding techniques): banks + one parity
  bank provide one extra effective read port at 1 + 1/num_banks footprint;
  writes must update data + parity (write amplification 2x).

All three implement the same ``step`` contract as ``multiport.step`` (a new
storage, and one ``[Q, W]`` result per port, zeros for write and disabled
ports) on the port's own ``_service_write``/``_service_read``, so they run on
whatever device their storage lies on; ``counters`` gives the traversals,
words and footprint the benchmark tables count.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch import device as _device
from repro_torch.core.multiport import (MemorySpec, _dedup_last_wins,
                                        _normalize, _service_read,
                                        _service_write)
from repro_torch.core.ports import MAX_PORTS, READ, WRITE, PortConfig, PortRequest


@dataclasses.dataclass(frozen=True)
class TrafficCounters:
    """Accounting used by benchmarks: physical traversals & words touched."""

    storage_traversals: int      # full passes over the storage
    words_read: int              # gather lanes issued
    words_written: int           # scatter lanes issued (incl. replication/parity)
    footprint_words: int         # physical words allocated for the logical capacity


def _zero_reads(spec: MemorySpec, q: int, device) -> list[torch.Tensor]:
    return [torch.zeros((q, spec.word_width), dtype=spec.dtype, device=device)
            for _ in range(MAX_PORTS)]


class SinglePortNPass:
    """Bare single-port macro: one traversal per enabled port (no wrapper)."""

    def __init__(self, spec: MemorySpec):
        self.spec = spec

    def init_storage(self, device="cuda") -> torch.Tensor:
        return self.spec.init_storage(device=device)

    def step(self, config: PortConfig, storage: torch.Tensor,
             requests: Sequence[PortRequest]
             ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        reads = _zero_reads(self.spec, requests[0].queue_len, storage.device)
        storage = storage.clone()
        for port in config.service_order():
            req = requests[port]
            if config.roles[port] == WRITE:
                storage = _service_write(storage, req, self.spec.num_words)
            else:
                reads[port] = _service_read(storage, req, self.spec.num_words)
        return storage, reads

    def counters(self, config: PortConfig, queue_len: int) -> TrafficCounters:
        return TrafficCounters(
            storage_traversals=config.enabled_count,
            words_read=len(config.read_ports()) * queue_len,
            words_written=len(config.write_ports()) * queue_len,
            footprint_words=self.spec.num_words)


class ReplicatedReads:
    """Bitcell-widening analogue: one replica per concurrent read port."""

    def __init__(self, spec: MemorySpec, n_read_ports: int):
        self.spec = spec
        self.n_replicas = max(1, n_read_ports)

    def init_storage(self, device="cuda") -> torch.Tensor:
        one = self.spec.init_storage(device=device)
        return one.unsqueeze(0).repeat(self.n_replicas, 1, 1)

    def step(self, config: PortConfig, storage: torch.Tensor,
             requests: Sequence[PortRequest]
             ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        reads = _zero_reads(self.spec, requests[0].queue_len, storage.device)
        read_ports = [p for p in config.service_order()
                      if config.roles[p] == READ]
        replica_of = {p: i % self.n_replicas for i, p in enumerate(read_ports)}
        storage = storage.clone()
        for port in config.service_order():
            req = requests[port]
            if config.roles[port] == WRITE:
                # coherence: every replica takes the write, as one indexed
                # store over the replica axis (the JAX package's vmap)
                addr = _normalize(req.addr, self.spec.num_words)
                eff = (_dedup_last_wins(addr, req.mask) & (addr >= 0)
                       & (addr < self.spec.num_words))
                storage[:, addr[eff]] = req.data[eff].to(storage.dtype)
            else:
                reads[port] = _service_read(storage[replica_of[port]], req,
                                            self.spec.num_words)
        return storage, reads

    def counters(self, config: PortConfig, queue_len: int) -> TrafficCounters:
        return TrafficCounters(
            storage_traversals=1,  # replicas are "concurrent" hardware ports
            words_read=len(config.read_ports()) * queue_len,
            words_written=(len(config.write_ports()) * queue_len
                           * self.n_replicas),
            footprint_words=self.spec.num_words * self.n_replicas)


class XorCoded:
    """Coding-based multi-port (paper ref [11], simplified XOR-bank scheme).

    Storage is split into ``num_banks`` data banks plus one parity bank. As
    in the JAX package, the parity is the float SUM of the data banks rather
    than the XOR of their bit patterns: the same traffic and footprint, and
    a second read of a busy bank b is reconstructed from the other banks and
    the parity.
    """

    def __init__(self, spec: MemorySpec):
        self.spec = spec
        self.num_banks = spec.num_banks

    def init_storage(self, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
        wpb, w = self.spec.words_per_bank, self.spec.word_width
        data = torch.zeros((self.num_banks, wpb, w), dtype=self.spec.dtype,
                           device=_device.resolve(device))
        parity = torch.zeros((wpb, w), dtype=self.spec.dtype,
                             device=data.device)
        return data, parity

    def _flat(self, data: torch.Tensor) -> torch.Tensor:
        return data.reshape(self.spec.num_words, self.spec.word_width)

    def step(self, config: PortConfig, storage, requests):
        data, parity = storage
        data, parity = data.clone(), parity.clone()
        reads = _zero_reads(self.spec, requests[0].queue_len, data.device)
        nw, wpb = self.spec.num_words, self.spec.words_per_bank
        flat = self._flat(data)                       # a view of ``data``
        for port in config.service_order():
            req = requests[port]
            if config.roles[port] == WRITE:
                # duplicate in-queue addresses: only the last lane lands, so
                # the parity delta must telescope to (v_last - old)
                addr = _normalize(req.addr, nw)
                eff = (_dedup_last_wins(addr, req.mask) & (addr >= 0)
                       & (addr < nw))
                at = torch.where(eff, addr, 0)
                old = torch.where(eff[:, None], flat[at], 0)
                _service_write(flat, req, nw)
                # parity update: remove old contribution, add new (2x writes)
                delta = torch.where(eff[:, None],
                                    req.data.to(self.spec.dtype) - old, 0)
                parity.index_add_(0, at[eff] % wpb, delta[eff])
            else:
                reads[port] = _service_read(flat, req, nw)
        return (data, parity), reads

    def counters(self, config: PortConfig, queue_len: int) -> TrafficCounters:
        return TrafficCounters(
            storage_traversals=2,  # banked: ~2 effective concurrent ports
            words_read=len(config.read_ports()) * queue_len,
            words_written=len(config.write_ports()) * queue_len * 2,
            footprint_words=self.spec.num_words + self.spec.words_per_bank)


def footprint_ratio(baseline_counters: TrafficCounters,
                    proposed_words: int) -> float:
    """Area-analogue ratio for Table II: baseline footprint / proposed."""
    return baseline_counters.footprint_words / proposed_words
