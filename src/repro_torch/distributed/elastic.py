"""Elastic scaling: move a training/serving state between meshes.

A checkpoint written on one mesh restores onto any other
(``checkpoint.ckpt.restore(..., shardings=)`` distributes each leaf under
its target placements); for live resizing without a filesystem round
trip, ``reshard_tree`` re-places every leaf under the new mesh's sharding
rules. Combined with step-addressable data (``data/pipeline.py``) this
gives the JAX package's elastic semantics: rebuild the mesh, reshard,
resume at the same step with the same results.

Each leaf is gathered whole first (a DTensor's all-gather on its own
mesh, a plain tensor as it is), then distributed under the new mesh's
placements from rank 0's copy, so the ranks of the new mesh must all
call these functions, and the whole leaf must fit on one rank.
"""
from __future__ import annotations

from typing import Any

from repro_torch import tree as T
from repro_torch.distributed import sharding as shd

PyTree = Any


def _whole(x):
    """The whole of ``x`` on this rank: a DTensor gathered, else ``x``."""
    return x.full_tensor() if shd.is_dtensor(x) else x


def reshard_tree(tree: PyTree, mesh, pspecs: PyTree) -> PyTree:
    """Every leaf of ``tree`` placed on ``mesh`` as its spec in ``pspecs``
    says."""
    return T.tree_map(lambda x, s: shd.place(_whole(x), mesh, s), tree,
                      pspecs)


def replicate_tree(tree: PyTree, mesh) -> PyTree:
    """Every leaf of ``tree`` whole on every rank of ``mesh``."""
    return T.tree_map(lambda x: shd.place(_whole(x), mesh,
                                          shd.P(*(None,) * x.ndim)), tree)
