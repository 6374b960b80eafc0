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
from repro_torch.distributed import sharding as S

PyTree = Any
BLOCK = 256


def _blockify(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """[P, ...] -> ([P, nblocks, BLOCK], n_elems_per_pod)."""
    p = x.shape[0]
    flat = x.reshape(p, -1).to(torch.float32)
    n = flat.shape[1]
    return F.pad(flat, (0, (-n) % BLOCK)).reshape(p, -1, BLOCK), n


def _max_over_pods(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(x, dim=0, keepdim=True)


def _sum_over_pods(q: torch.Tensor) -> torch.Tensor:
    # exact in int8 by the guard bits, as the wire carries it
    return torch.sum(q, dim=0, dtype=torch.int8)


def quantize_pods(g: torch.Tensor, ef: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The wire format of ``compressed_mean_pods``: (blocks of g + ef [P, nb,
    BLOCK] f32, their int8 codes, the per-block scale [1, nb, 1], the
    elements per pod)."""
    return _quantize(g, ef, g.shape[0], _max_over_pods)


def _quantize(g, ef, n_pods: int, pod_max):
    """``quantize_pods`` of the pods in ``g`` out of ``n_pods``, the scale's
    max over the pods taken by ``pod_max`` (of the blocks' maxima [P_here,
    nb, 1])."""
    blocks, n = _blockify(g.to(torch.float32) + ef)
    guard = max(0, math.ceil(math.log2(max(n_pods, 1))))
    qmax = 127 >> guard
    local_max = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    scale = torch.clamp(pod_max(local_max) / qmax, min=1e-30)
    q = torch.clamp(torch.round(blocks / scale), -qmax, qmax).to(torch.int8)
    return blocks, q, scale, n


def _mean_and_resid(g, ef, n_pods: int, pod_max, pod_sum):
    """(mean [*shape] f32, residuals shaped as ``g``) of the pods in ``g``
    ([P_here, *shape]); ``pod_max`` / ``pod_sum`` reduce over all
    ``n_pods`` pods, which may lie in other processes."""
    blocks, q, scale, n = _quantize(g, ef, n_pods, pod_max)
    total = pod_sum(q)                       # [nb, BLOCK] int8
    mean = (total.to(torch.float32) * scale[0]) / n_pods
    mean = mean.reshape(-1)[:n].reshape(g.shape[1:])
    deq_local = q.to(torch.float32) * scale
    resid = (blocks - deq_local).reshape(g.shape[0], -1)[:, :n]
    return mean, resid.reshape(g.shape)


def _mean_over_pod_axis(g, ef, axis: str):
    """``compressed_mean_pods`` of DTensors whose lead (pod) dim is split
    over mesh axis ``axis``: each rank gathers its pod's whole gradient
    and residual within the pod, and only the blocks' max (f32, 1/256 of
    the values) and the int8 codes' sum cross the pods, as all-reduces on
    the ``axis`` group. The mean comes back replicated; the residuals
    split over ``axis`` as ``ef`` is."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = g.device_mesh
    group = mesh.get_group(axis)
    pod_pl = [Shard(0) if name == axis else Replicate()
              for name in mesh.mesh_dim_names]

    def pod_max(x):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
        return x

    def pod_sum(q):
        total = q[0].clone()
        dist.all_reduce(total, group=group)         # int8 on the wire
        return total

    mean, resid = _mean_and_resid(
        g.redistribute(mesh, pod_pl).to_local(),
        ef.redistribute(mesh, pod_pl).to_local(), g.shape[0], pod_max,
        pod_sum)
    return (DTensor.from_local(mean, mesh, [Replicate()] * mesh.ndim,
                               run_check=False),
            DTensor.from_local(resid, mesh, pod_pl, run_check=False))


@torch.no_grad()
def compressed_mean_pods(g: torch.Tensor, ef: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean of per-pod gradients with int8 wire format + error feedback.

    Args:
      g:  [n_pods, *shape] per-pod gradients.
      ef: [n_pods, *shape] f32 residual state.

    Returns: (mean_grad [*shape] f32, new_ef [n_pods, *shape] f32).

    DTensors on a mesh with a ``pod`` axis reduce across it with int8
    codes (``_mean_over_pod_axis``); other DTensors are gathered whole
    and reduced on every rank alike.
    """
    if S.is_dtensor(g):
        if "pod" in g.device_mesh.mesh_dim_names:
            return _mean_over_pod_axis(g, ef, "pod")
        whole = [S.gather_all(x) for x in (g, ef)]
        mean, resid = compressed_mean_pods(*(x.to_local() for x in whole))
        return S.on_mesh_of(mean, g), S.on_mesh_of(resid, g)
    return _mean_and_resid(g, ef, g.shape[0], _max_over_pods,
                           _sum_over_pods)


def compressed_mean_tree(grads: PyTree, ef: PyTree) -> tuple[PyTree, PyTree]:
    """Apply compressed_mean_pods leafwise. grads/ef leaves: [n_pods, ...]."""
    outs = [compressed_mean_pods(g, e) for g, e in
            zip(T.leaves(grads), T.leaves_up_to(grads, ef))]
    return (T.unflatten(grads, [o[0] for o in outs]),
            T.unflatten(grads, [o[1] for o in outs]))


def init_ef_state(params: PyTree, n_pods: int) -> PyTree:
    """Zero residuals [n_pods, *param_shape] f32; on DTensor parameters
    placed by ``sharding.ef_spec``."""
    def zero(p):
        spec = S.ef_spec(S.spec_of(p), S.mesh_of(p)) if S.is_dtensor(p) \
            else None
        return S.zeros((n_pods,) + tuple(p.shape), torch.float32, p, spec)
    return T.tree_map(zero, params)
