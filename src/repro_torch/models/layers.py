"""Shared neural-net layers as plain functions on tensors.

Every layer is an (init, apply) pair: ``init`` returns a nested dict of
tensors on an explicit device, drawn from an explicit ``torch.Generator``;
``apply`` is a pure function. Parameter dtype and compute dtype are
decoupled, as in the JAX package (params f32 in CPU tests, bf16 in the
published configs).
"""
from __future__ import annotations

import math

import torch


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, dtype, stddev: float,
                device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * stddev).to(dtype)


def fan_in_init(gen, shape, dtype, device, fan_in: int | None = None):
    """Normal with std 1/sqrt(fan_in); ``fan_in`` defaults to the second to
    last dim (the input width of a [..., d_in, d_out] weight)."""
    fan = fan_in if fan_in is not None else shape[-2]
    return normal_init(gen, shape, dtype, 1.0 / math.sqrt(fan), device)


# --------------------------------------------------------------------------
# linear / embedding / norm
# --------------------------------------------------------------------------

def linear_init(gen, d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.float32, device="cpu", lead: tuple = ()) -> dict:
    """``lead`` prepends stacking dims (the layer axis of a stacked block)."""
    p = {"w": fan_in_init(gen, (*lead, d_in, d_out), dtype, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def embedding_init(gen, vocab: int, d: int, dtype=torch.float32,
                   device="cpu") -> dict:
    return {"w": normal_init(gen, (vocab, d), dtype, 1.0, device)}


def embedding_lookup(p: dict, ids: torch.Tensor,
                     compute_dtype=None) -> torch.Tensor:
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
    return w[ids.long()]


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu",
                 lead: tuple = ()) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device="cpu") -> torch.Tensor:
    """[head_dim//2] inverse frequencies."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


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


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate) * up
