"""8-bit AdamW: block-wise DYNAMIC (log-scale) quantized moments.

fp32 m+v cost 8 bytes/param; 8-bit states cost 2 bytes/param + 1/16
block-scale overhead.

Linear absmax int8 is catastrophically wrong for Adam's second moment: an
element whose v is 100x below its block's max quantizes to 0 and the next
update divides by sqrt(0)+eps. Following Dettmers et al. (8-bit optimizers),
moments use a block-wise *dynamic* map — here a log-uniform code covering 7
decades, so every element keeps <= ~6.5% (m, signed, 127 levels) / ~3.2%
(v, unsigned, 255 levels) relative error regardless of its magnitude within
the block. Code 0 represents exact zero.

Layout per tensor: q (int8/uint8 [..., nblocks, 64], blocks along the last
axis) + scale (f32 [..., nblocks, 1]), the JAX package's layout, so the
states cross between the two packages' checkpoints.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.distributed import sharding as S
from repro_torch.optim.adamw import (AdamWConfig, bias_corrections,
                                     clip_by_global_norm, step_zero)

PyTree = Any
BLOCK = 64
_DECADES = 7.0
f32 = torch.float32


def _blockify(x: torch.Tensor) -> torch.Tensor:
    """Block along the LAST axis: [..., n] -> [..., ceil(n/B), B], zero
    padded. A DTensor whose ranks do not each hold whole blocks of the
    last axis gathers it first (its state's block dim then replicates:
    ``sharding.quant_spec``)."""
    x = S.whole_unless_even(x, -1, BLOCK)
    *lead, n = x.shape
    pad = (-n) % BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*lead, -1, BLOCK)


def _quantize(x: torch.Tensor, signed: bool) -> dict:
    """Log-dynamic block quantization. x: any shape, f32."""
    if x.ndim == 0:
        x = x[None]
    blocks = _blockify(x.to(f32))
    levels = 127.0 if signed else 255.0
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    a = torch.abs(blocks) / torch.clamp(scale, min=1e-30)     # in [0, 1]
    qmag = torch.round((torch.log10(torch.clamp(a, min=10.0 ** -_DECADES))
                        + _DECADES) / _DECADES * levels)
    qmag = torch.where(a < 10.0 ** -_DECADES, 0.0,
                       torch.clamp(qmag, min=1.0))
    if signed:
        q = (torch.sign(blocks) * qmag).to(torch.int8)
    else:
        q = qmag.to(torch.uint8)
    return {"q": q, "scale": scale.to(f32)}


def _dequantize(qd: dict, shape) -> torch.Tensor:
    q = qd["q"]
    signed = q.dtype == torch.int8
    levels = 127.0 if signed else 255.0
    qf = q.to(f32)
    mag = 10.0 ** (torch.abs(qf) / levels * _DECADES - _DECADES)
    val = torch.where(qf == 0, 0.0, mag)
    if signed:
        val = val * torch.sign(qf)
    val = (val * qd["scale"]).reshape(*q.shape[:-2], -1)
    n_last = shape[-1] if len(shape) else 1
    return val[..., :n_last].reshape(shape)


def adamw8bit_init(params: PyTree, cfg: AdamWConfig) -> dict:
    def qzero(p, signed):
        """``_quantize`` of zeros, made as zeros (code 0, scale 0), so that
        a DTensor state is placed by ``sharding.quant_spec``."""
        lead = tuple(p.shape[:-1]) if p.ndim else ()
        nb = -(-(p.shape[-1] if p.ndim else 1) // BLOCK)
        spec = S.quant_spec(S.spec_of(p), nb, S.mesh_of(p)) \
            if S.is_dtensor(p) else None
        return {"q": S.zeros((*lead, nb, BLOCK),
                             torch.int8 if signed else torch.uint8, p, spec),
                "scale": S.zeros((*lead, nb, 1), f32, p, spec)}
    return {"step": step_zero(params),
            "m": T.tree_map(lambda p: qzero(p, True), params),
            "v": T.tree_map(lambda p: qzero(p, False), params)}


@torch.no_grad()
def adamw8bit_update(grads: PyTree, state: dict, params: PyTree, lr,
                     cfg: AdamWConfig) -> tuple[PyTree, dict, dict]:
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    c1, c2 = bias_corrections(step, cfg)

    def upd(g, mq, vq, p):
        m = _dequantize(mq, p.shape)
        v = _dequantize(vq, p.shape)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh, vh = m / c1, v / c2
        pf = p.to(f32)
        pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                        + cfg.weight_decay * pf)
        # on DTensors the new codes keep the old ones' placements (a
        # block max over a split dim would otherwise stay a pending max)
        return (T.tree_map(S.like, _quantize(m, True), mq),
                T.tree_map(S.like, _quantize(v, False), vq),
                S.like(pf.to(p.dtype), p))

    outs = [upd(g, m, v, p) for g, m, v, p in zip(
        T.leaves(grads), T.leaves_up_to(grads, state["m"]),
        T.leaves_up_to(grads, state["v"]), T.leaves_up_to(grads, params))]
    new_state = dict(state, step=step,
                     m=T.unflatten(grads, [o[0] for o in outs]),
                     v=T.unflatten(grads, [o[1] for o in outs]))
    return (T.unflatten(grads, [o[2] for o in outs]), new_state,
            {"grad_norm": gnorm})
