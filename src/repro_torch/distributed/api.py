"""Activation-sharding hints: a context the dry run installs so that model
code can place key intermediates (logits, hidden states, MoE buffers)
without knowing the mesh where it is defined.

Model code calls ``hint(x, "logits")``. Outside a context, or on a plain
tensor, it returns ``x`` itself, so tests and one-device runs are
unaffected; the training launcher installs none (the JAX package's does
not either). Inside one, a DTensor is redistributed to the named spec's
placements on its own mesh, the port's counterpart of JAX's
``with_sharding_constraint``. Axes the tensor's mesh lacks are dropped
from the spec: inside ``sharding.per_pod`` each pod computes on a mesh
without ``pod``, whose batch rows are that pod's share already.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional

import torch

from repro_torch.distributed import sharding as S

_SPECS: ContextVar[Optional[dict]] = ContextVar("activation_specs",
                                                default=None)


@contextlib.contextmanager
def activation_specs(specs: dict):
    """specs: name -> PartitionSpec (e.g. {"logits": P("data", None,
    "model")})."""
    token = _SPECS.set(specs)
    try:
        yield
    finally:
        _SPECS.reset(token)


def hint(x: torch.Tensor, name: str) -> torch.Tensor:
    specs = _SPECS.get()
    if not specs or specs.get(name) is None or not S.is_dtensor(x):
        return x
    mesh = S.mesh_of(x)
    spec = tuple(_on(axes, mesh.axis_names) for axes in specs[name])
    # pad the spec to the tensor's rank (trailing dims unsharded)
    spec = S.P(*spec, *(None,) * (x.ndim - len(spec)))
    return x.redistribute(x.device_mesh, S.placements(spec, mesh))


def _on(axes, names: tuple):
    """``axes`` (a spec entry) without the mesh axes not in ``names``."""
    kept = tuple(a for a in S._flat_axes(axes) if a in names)
    return None if not kept else kept[0] if len(kept) == 1 else kept
