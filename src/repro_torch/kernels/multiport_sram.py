"""Pool step kernel: one macro-cycle of the N-port memory in one launch.

The CUDA kernel (``csrc/multiport_sram.cu``) replaces the JAX package's
Pallas kernel ``kernels/multiport_sram.py:_kernel``. The caller packs ONLY
the enabled ports, already in service order, with write masks deduplicated
last-wins and out-of-range lanes masked off (see ``ops.multiport_step``).
Payloads travel for the write slots only, and reads come back for the read
slots only: nothing is moved for a slot that has no use for it.

:func:`multiport_sram_step` launches the kernel for CUDA tensors and runs
:func:`multiport_sram_step_plain` — the same function in plain torch — for
CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.core.ports import MAX_PORTS, WRITE
from repro_torch.kernels import _build

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = _build.Launcher(
    "multiport_sram", "multiport_sram_step",
    [_vp] * 8 + [_i] * 5 + [_vp])


def multiport_sram_step_plain(storage: torch.Tensor, addr: torch.Tensor,
                              data: Sequence[torch.Tensor], mask: torch.Tensor,
                              *, roles: tuple) -> torch.Tensor:
    """The kernel's function in plain torch: services the packed ports in
    order, updating ``storage`` in place; ``data`` holds the write slots'
    payloads in slot order. Returns reads [P_read, Q, W], one [Q, W] block
    per read slot in slot order (zeros at masked lanes)."""
    q, width = addr.shape[1], storage.shape[1]
    n_reads = sum(1 for r in roles if r != WRITE)
    reads = torch.empty((n_reads, q, width), dtype=storage.dtype,
                        device=storage.device)
    payloads = iter(data)
    r_slot = 0
    for slot, role in enumerate(roles):
        m = mask[slot]
        a = addr[slot].long()
        if role == WRITE:
            storage[a[m]] = next(payloads)[m].to(storage.dtype)
        else:
            got = storage[a]
            reads[r_slot] = torch.where(m[:, None], got, torch.zeros_like(got))
            r_slot += 1
    return reads


def multiport_sram_step(storage: torch.Tensor, addr: torch.Tensor,
                        data: Sequence[torch.Tensor], mask: torch.Tensor, *,
                        roles: tuple) -> torch.Tensor:
    """One macro-cycle over the pool storage.

    Args:
      storage: [num_words, W]; updated IN PLACE.
      addr:    int32 [P, Q] word addresses of the ENABLED ports, stacked in
               service (priority) order; in range wherever ``mask`` is set.
      data:    the WRITE slots' payloads in slot order, one [Q, W]
               tensor (storage dtype) each.
      mask:    bool [P, Q]; write masks must already be deduplicated.
      roles:   READ/WRITE per packed slot, in service order.

    Returns reads [P_read, Q, W] for the READ slots in slot order, zeros at
    masked lanes.
    """
    p, q = addr.shape
    width = storage.shape[1]
    payloads = list(data)
    n_writes = sum(1 for r in roles if r == WRITE)
    if (p != len(roles) or p > MAX_PORTS or len(payloads) != n_writes
            or any(tuple(d.shape) != (q, width) for d in payloads)):
        raise ValueError(f"packed ports disagree: addr {tuple(addr.shape)}, "
                         f"payloads {[tuple(d.shape) for d in payloads]}, "
                         f"roles {roles}")
    if storage.device.type == "cpu":
        return multiport_sram_step_plain(storage, addr, payloads, mask,
                                         roles=roles)
    if addr.dtype != torch.int32 or mask.dtype != torch.bool \
            or any(d.dtype != storage.dtype for d in payloads):
        raise ValueError("multiport_sram_step: addr int32, mask bool, "
                         "payloads in the storage dtype")
    if storage.element_size() not in (2, 4):
        raise ValueError(f"multiport_sram_step: {storage.dtype} storage is "
                         f"not supported")
    _build.check_cuda("multiport_sram_step", storage, addr, mask, *payloads)
    reads = torch.empty((p - n_writes, q, width), dtype=storage.dtype,
                        device=storage.device)
    if q == 0:
        return reads
    write_bits = sum(1 << i for i, r in enumerate(roles) if r == WRITE)
    ptrs = [_build.ptr(d) for d in payloads]
    ptrs += [ctypes.c_void_p(None)] * (MAX_PORTS - len(ptrs))
    KERNEL(_build.ptr(storage), _build.ptr(addr), _build.ptr(mask), *ptrs,
           _build.ptr(reads), width, p, q, write_bits,
           storage.element_size(), _build.stream_of(storage))
    return reads
