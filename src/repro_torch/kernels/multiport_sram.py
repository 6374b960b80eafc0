"""Pool step kernel: one macro-cycle of the N-port memory in one launch.

The CUDA kernel (``csrc/multiport_sram.cu``) replaces the JAX package's
Pallas kernel ``kernels/multiport_sram.py:_kernel``. The caller packs ONLY
the enabled ports, already in service order, with write masks deduplicated
last-wins and out-of-range lanes masked off (see ``ops.multiport_step``).

:func:`multiport_sram_step` launches the kernel for CUDA tensors and runs
:func:`multiport_sram_step_plain` — the same function in plain torch — for
CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ports import WRITE
from repro_torch.kernels import _build

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = _build.Launcher(
    "multiport_sram", "multiport_sram_step",
    [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp])


def multiport_sram_step_plain(storage: torch.Tensor, addr: torch.Tensor,
                              data: torch.Tensor, mask: torch.Tensor, *,
                              roles: tuple) -> torch.Tensor:
    """The kernel's function in plain torch: services the packed ports in
    order, updating ``storage`` in place; returns reads [P, Q, W] (zeros
    for write slots and masked lanes)."""
    reads = torch.zeros(data.shape, dtype=storage.dtype, device=storage.device)
    for slot, role in enumerate(roles):
        m = mask[slot]
        a = addr[slot].long()
        if role == WRITE:
            storage[a[m]] = data[slot][m].to(storage.dtype)
        else:
            got = storage[a]
            reads[slot] = torch.where(m[:, None], got, torch.zeros_like(got))
    return reads


def multiport_sram_step(storage: torch.Tensor, addr: torch.Tensor,
                        data: torch.Tensor, mask: torch.Tensor, *,
                        roles: tuple) -> torch.Tensor:
    """One macro-cycle over the pool storage.

    Args:
      storage: [num_words, W]; updated IN PLACE.
      addr:    int32 [P, Q] word addresses of the ENABLED ports, stacked in
               service (priority) order; in range wherever ``mask`` is set.
      data:    [P, Q, W] write payloads (storage dtype).
      mask:    bool [P, Q]; write masks must already be deduplicated.
      roles:   READ/WRITE per packed slot, in service order.

    Returns reads [P, Q, W] — zeros for write slots and masked lanes.
    """
    p, q = addr.shape
    if p != len(roles) or data.shape != (p, q, storage.shape[1]):
        raise ValueError(f"packed ports disagree: addr {tuple(addr.shape)}, "
                         f"data {tuple(data.shape)}, roles {roles}")
    if storage.device.type == "cpu":
        return multiport_sram_step_plain(storage, addr, data, mask,
                                         roles=roles)
    if addr.dtype != torch.int32 or mask.dtype != torch.bool \
            or data.dtype != storage.dtype:
        raise ValueError("multiport_sram_step: addr int32, mask bool, data "
                         "in the storage dtype")
    if storage.element_size() not in (2, 4):
        raise ValueError(f"multiport_sram_step: {storage.dtype} storage is "
                         f"not supported")
    _build.check_cuda("multiport_sram_step", storage, addr, data, mask)
    reads = torch.empty_like(data)
    if q == 0:
        return reads
    write_bits = sum(1 << i for i, r in enumerate(roles) if r == WRITE)
    KERNEL(_build.ptr(storage), _build.ptr(addr), _build.ptr(mask),
           _build.ptr(data), _build.ptr(reads), storage.shape[1], p, q,
           write_bits, storage.element_size(), _build.stream_of(storage))
    return reads
