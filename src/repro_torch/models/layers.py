"""Shared neural-net layers as plain functions on tensors.

Every layer is an (init, apply) pair: ``init`` returns a nested dict of
tensors on an explicit device, drawn from an explicit ``torch.Generator``;
``apply`` is a pure function. Parameter dtype and compute dtype are
decoupled, as in the JAX package (params f32 in CPU tests, bf16 in the
published configs).
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import torch

from repro_torch import device as _device
from repro_torch.distributed import sharding as S


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, dtype, stddev: float,
                device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(stddev).to(dtype)


def stacked_normal_init(gen: torch.Generator, lead: tuple, shape, dtype,
                        stddev: float, device) -> torch.Tensor:
    """``normal_init`` of a ``[*lead, *shape]`` stack, drawn one ``shape``
    slice at a time: the f32 draw held at once is one slice, not the stack
    (a stack of MoE expert weights is tens of GB in f32)."""
    out = torch.empty((*lead, *shape), dtype=dtype, device=device)
    for piece in out.view(-1, *shape):
        piece.copy_(normal_init(gen, shape, dtype, stddev, device))
    return out


def fan_in_init(gen, shape, dtype, device, fan_in: int | None = None):
    """Normal with std 1/sqrt(fan_in); ``fan_in`` defaults to the second to
    last dim (the input width of a [..., d_in, d_out] weight)."""
    fan = fan_in if fan_in is not None else shape[-2]
    return normal_init(gen, shape, dtype, 1.0 / math.sqrt(fan), device)


# --------------------------------------------------------------------------
# linear / embedding / norm
# --------------------------------------------------------------------------

def linear_init(gen, d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.float32, device="cuda", lead: tuple = ()) -> dict:
    """``lead`` prepends stacking dims (the layer axis of a stacked block).
    Like every init here, on the card unless ``device="cpu"``."""
    device = _device.resolve(device)
    p = {"w": fan_in_init(gen, (*lead, d_in, d_out), dtype, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = S.matmul(x, w)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


class _BmmF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=torch.float32)`` with a backward (the
    op has no derivative in torch 2.11): each gradient is the f32 product
    of the f32 cotangent with the other operand's f32 copy, rounded to its
    operand's dtype — what autograd gives the cast-then-multiply form."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` ([n, i, k] x [n, k, j]) summed and returned in
    f32: the JAX package's ``preferred_element_type=f32``. On CUDA, bf16 or
    f16 operands go into the product as they are (no f32 copies); elsewhere
    they are cast to f32 first (a product of two bf16 values is exact in
    f32, so only the summation order can differ)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) \
            and b.dtype == a.dtype:
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def embedding_init(gen, vocab: int, d: int, dtype=torch.float32,
                   device="cuda") -> dict:
    return {"w": normal_init(gen, (vocab, d), dtype, 1.0,
                             _device.resolve(device))}


def embedding_lookup(p: dict, ids: torch.Tensor,
                     compute_dtype=None) -> torch.Tensor:
    """``w[ids]``; on DTensors (sharded training) each rank looks up its
    own ids in the gathered rows of its columns
    (``distributed.sharding.local_lookup``)."""
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
    if S.is_dtensor(w):
        return S.local_lookup(w, ids)
    return w[ids.long()]


def rmsnorm_init(d: int, dtype=torch.float32, device="cuda",
                 lead: tuple = ()) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype,
                                device=_device.resolve(device))}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


# --------------------------------------------------------------------------
# rotary embeddings (RoPE and Qwen2-VL multimodal M-RoPE)
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device="cuda") -> torch.Tensor:
    """[head_dim//2] inverse frequencies."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=_device.resolve(device))
                            / half))


def rope_apply(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Apply rotary embedding.

    x: [..., S, n_heads, head_dim]; positions: broadcastable to [..., S].
    """
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)          # [half]
    ang = positions[..., None].float() * freqs                     # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                             # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_streams(sections: tuple, device: torch.device) -> torch.Tensor:
    """The position stream of each rotary pair, made once per sections and
    device, on the device (no host copy, no sync)."""
    return torch.cat([torch.full((n,), i, device=device)
                      for i, n in enumerate(sections)])


def mrope_apply(x: torch.Tensor, positions: torch.Tensor,
                sections: Sequence[int], theta: float = 10000.0
                ) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the rotary pairs are split into (t, h, w) sections,
    each driven by its own position stream.

    x: [..., S, n_heads, head_dim]; positions: [..., S, 3] (t, h, w indices);
    sections: pair counts per stream, sum == head_dim // 2.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {half}")
    freqs = rope_frequencies(x.shape[-1], theta, x.device)          # [half]
    sec_id = _mrope_streams(tuple(sections), x.device)              # [half]
    pos = positions.float()[..., sec_id]                            # [..., S, half]
    ang = pos * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int,
                         offset: torch.Tensor | int = 0,
                         device="cuda") -> torch.Tensor:
    """MusicGen-style absolute sinusoidal position embeddings, ``[sin |
    cos]``: [S, d] for an int ``offset``, [B, S, d] for per-row offsets
    [B]."""
    if torch.is_tensor(offset):
        device = offset.device
        offset = offset.long()[:, None]
    else:
        device = _device.resolve(device)
    pos = (torch.arange(seq_len, device=device) + offset)[..., None].float()
    half = d_model // 2
    div = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / half))
    ang = pos * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate) * up
