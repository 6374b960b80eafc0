"""Checkpointing: manifest-verified, atomic, async — the JAX package's
``checkpoint/ckpt.py`` layout, so a checkpoint crosses between the two
packages.

Layout (one directory per step):
    <root>/step_000000123/
        manifest.json    — step, extra, and shape, dtype and crc32 per leaf
        arrays.npz       — one entry per leaf, keyed by its path joined by
                           "/" in the JAX package's leaf order
    <root>/step_000000123.tmp/   — staging; atomic rename on completion

Fault-tolerance properties:
  * atomic: a crashed save never leaves a half-readable step directory;
  * verified: restore checks crc32 of every leaf against the manifest;
  * async: ``AsyncSaver`` snapshots to host memory on the caller's thread,
    then writes on a worker thread — training continues during the write.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bits with
``"dtype": "bfloat16"`` in the manifest (the crc is taken over those
bytes, which are the bf16 bytes), and ``restore`` views the bits back.
Every other dtype (f32, the 8-bit optimizer's int8/uint8 codes, int32
steps) is stored as itself.

Sharded states (DTensor leaves, one process per mesh position): ``save``
gathers each leaf whole on every rank (all ranks call it), rank 0 writes
and the others wait at a barrier until the step is published, so the
layout is the one-device layout. ``restore`` places each leaf as its
template leaf is placed, or as ``shardings`` says (JAX's
``restore(..., shardings=)``), onto any mesh: the elastic restart.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.distributed import sharding as S

PyTree = Any
_SEP = "/"
_BF16 = "bfloat16"


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` (of the whole of a DTensor) that nothing else
    holds (bf16 as uint16 bits)."""
    if S.is_dtensor(x):
        x = x.full_tensor()
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _flatten(tree: PyTree) -> dict[str, tuple[np.ndarray, str]]:
    """key -> (host array, dtype name)."""
    return {_SEP.join(str(k) for k in path):
            (_to_host(leaf), str(leaf.dtype).removeprefix("torch."))
            for path, leaf in T.leaves_with_path(tree)}


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _sharded(tree: PyTree) -> bool:
    return any(S.is_dtensor(x) for x in T.leaves(tree))


def save(root: str, step: int, tree: PyTree, *, extra: Optional[dict] = None,
         keep_last: int = 3) -> str:
    """Synchronous checkpoint write. Returns the step directory path. For a
    sharded tree every rank calls it, and it returns once rank 0 has
    published the step."""
    flat = _flatten(tree)
    if not _sharded(tree):
        return _write(root, step, flat, extra or {}, keep_last)
    import torch.distributed as dist

    final = os.path.join(root, f"step_{step:09d}")
    if dist.get_rank() == 0:
        _write(root, step, flat, extra or {}, keep_last)
    dist.barrier()
    return final


def _write(root: str, step: int, flat: dict[str, tuple[np.ndarray, str]],
           extra: dict, keep_last: int) -> str:
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra, "leaves": {}}
    for k, (v, dtype) in flat.items():
        manifest["leaves"][k] = {"shape": list(v.shape), "dtype": dtype,
                                 "crc32": _crc(v)}
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: v for k, (v, _) in flat.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _gc(root, keep_last)
    return final


def _gc(root: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(root)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(root, d))


class AsyncSaver:
    """Snapshot-then-write on a background thread (one in flight at a
    time). A sharded tree is saved synchronously (``save``): its ranks
    meet at a barrier once the step is written."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, root: str, step: int, tree: PyTree, *,
             extra: Optional[dict] = None, keep_last: int = 3) -> None:
        self.wait()
        if _sharded(tree):
            save(root, step, tree, extra=extra, keep_last=keep_last)
            return
        flat = _flatten(tree)                  # snapshot on caller thread

        def work():
            try:
                _write(root, step, flat, extra or {}, keep_last)
            except BaseException as e:         # surfaced on next wait()
                self._error = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(root: str, template: PyTree, *, step: Optional[int] = None,
            shardings: Optional[PyTree] = None) -> tuple[PyTree, dict]:
    """Restore into the structure of ``template``, each leaf with the
    checkpoint's dtype on its template leaf's device, placed as a DTensor
    template leaf is, or as ``shardings`` (a tree of
    ``sharding.NamedSharding`` mirroring ``template``) says; verify
    checksums and shapes. Placing a leaf distributes rank 0's copy, so
    every rank of the target mesh calls this."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    targets = (T.leaves_up_to(template, shardings) if shardings is not None
               else [None] * len(T.leaves(template)))
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for (path, leaf), target in zip(T.leaves_with_path(template),
                                        targets):
            key = _SEP.join(str(k) for k in path)
            if key not in manifest["leaves"]:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            meta = manifest["leaves"][key]
            if _crc(arr) != meta["crc32"]:
                raise IOError(f"checksum mismatch for {key}")
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            if meta["dtype"] == _BF16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if target is None and S.is_dtensor(leaf):
                target = S.NamedSharding(S.mesh_of(leaf), S.spec_of(leaf))
            out.append(t.to(leaf.device) if target is None else
                       S.place(t, target.mesh, target.spec))
    return T.unflatten(template, out), manifest
