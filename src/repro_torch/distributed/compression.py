"""Gradient compression for the cross-pod reduction: int8 + error feedback.

The pod-to-pod hop is the scarce bandwidth of a multi-pod job; the pod-axis
mean runs on an int8 wire format (the JAX package's
``distributed/compression.py``, whose codes this module reproduces):

  1. the train step computes PER-POD gradients: leaves of shape
     [n_pods, ...] (on one device the pod axis is the leading axis of the
     per-pod grads, as under JAX's ``vmap``);
  2. error feedback adds each pod's residual from the previous step;
  3. blocks of 256 values share one scale, taken as the MAX over pods;
  4. values quantize to int8 with ceil(log2(n_pods)) guard bits so the sum
     over pods cannot overflow int8;
  5. the residual (pre-quantization minus quantized) becomes the next step's
     error-feedback state (Seide et al. 2014; Karimireddy et al. 2019).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tree as T

PyTree = Any
BLOCK = 256


def _blockify(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """[P, ...] -> ([P, nblocks, BLOCK], n_elems_per_pod)."""
    p = x.shape[0]
    flat = x.reshape(p, -1).to(torch.float32)
    n = flat.shape[1]
    return F.pad(flat, (0, (-n) % BLOCK)).reshape(p, -1, BLOCK), n


def quantize_pods(g: torch.Tensor, ef: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The wire format of ``compressed_mean_pods``: (blocks of g + ef [P, nb,
    BLOCK] f32, their int8 codes, the per-block scale [1, nb, 1], the
    elements per pod)."""
    n_pods = g.shape[0]
    blocks, n = _blockify(g.to(torch.float32) + ef)
    guard = max(0, math.ceil(math.log2(max(n_pods, 1))))
    qmax = 127 >> guard
    local_max = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    scale = torch.clamp(torch.amax(local_max, dim=0, keepdim=True) / qmax,
                        min=1e-30)
    q = torch.clamp(torch.round(blocks / scale), -qmax, qmax).to(torch.int8)
    return blocks, q, scale, n


@torch.no_grad()
def compressed_mean_pods(g: torch.Tensor, ef: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean of per-pod gradients with int8 wire format + error feedback.

    Args:
      g:  [n_pods, *shape] per-pod gradients.
      ef: [n_pods, *shape] f32 residual state.

    Returns: (mean_grad [*shape] f32, new_ef [n_pods, *shape] f32).
    """
    n_pods = g.shape[0]
    blocks, q, scale, n = quantize_pods(g, ef)
    total = torch.sum(q, dim=0)             # the int8 sum over pods
    mean = (total.to(torch.float32) * scale[0]) / n_pods
    mean = mean.reshape(-1)[:n].reshape(g.shape[1:])
    deq_local = q.to(torch.float32) * scale
    resid = (blocks - deq_local).reshape(n_pods, -1)[:, :n].reshape(g.shape)
    return mean, resid


def compressed_mean_tree(grads: PyTree, ef: PyTree) -> tuple[PyTree, PyTree]:
    """Apply compressed_mean_pods leafwise. grads/ef leaves: [n_pods, ...]."""
    outs = [compressed_mean_pods(g, e) for g, e in
            zip(T.leaves(grads), T.leaves_up_to(grads, ef))]
    return (T.unflatten(grads, [o[0] for o in outs]),
            T.unflatten(grads, [o[1] for o in outs]))


def init_ef_state(params: PyTree, n_pods: int) -> PyTree:
    return T.tree_map(lambda p: torch.zeros((n_pods,) + tuple(p.shape),
                                            dtype=torch.float32,
                                            device=p.device), params)
