"""Mamba2 block (SSD form), used inside the Zamba2 hybrid.

Structure (Mamba2 with n_groups = 1), as in the JAX package:
  projections: d -> z (d_in), x (d_in), B (N), C (N), dt (nheads)
  depthwise causal conv (kernel 4) over the x, B and C channels
  SSD recurrence with scalar-per-head decay a_t = exp(-dt * exp(A_log)),
  executed by the shared chunked linear-attention engine (linear_scan.py)
  skip: y += D * x;  gate: y = rmsnorm(y * silu(z));  out_proj: d_in -> d

z, x, B, C and dt are separate parameters (the reference model fuses them
into one in_proj and one conv), as in the JAX package's tree.
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as _device
from repro_torch.configs.base import SSMConfig
from repro_torch.distributed import sharding as S
from repro_torch.models import layers as L
from repro_torch.models.linear_scan import (chunked_linear_attention,
                                            linear_attention_step)

F32 = torch.float32


def _dims(d_model: int, cfg: SSMConfig) -> tuple[int, int]:
    d_in = cfg.expand * d_model
    return d_in, d_in // cfg.head_dim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``, exact at every x; ``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba2_init(gen, d_model: int, cfg: SSMConfig, dtype=torch.float32,
                device="cuda", lead: tuple = ()) -> dict:
    """The JAX package's distributions: projections N(0, 1/fan_in), conv
    weights N(0, 1/kernel) with zero bias, dt_bias softplus^-1 of a
    log-uniform dt in [dt_min, dt_max], a_log 0 (A = -1), D 1, norm 1."""
    device = _device.resolve(device)
    d_in, nheads = _dims(d_model, cfg)
    kw = dict(dtype=dtype, device=device, lead=lead)
    u = torch.rand((*lead, nheads), generator=gen, device=device)
    dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                   + math.log(cfg.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))     # softplus^-1(dt)
    ck = cfg.conv_kernel

    def conv(width):
        return {"w": L.normal_init(gen, (*lead, ck, width), dtype,
                                   1.0 / math.sqrt(ck), device),
                "b": torch.zeros((*lead, width), dtype=dtype, device=device)}
    return {
        "in_z": L.linear_init(gen, d_model, d_in, **kw),
        "in_x": L.linear_init(gen, d_model, d_in, **kw),
        "in_B": L.linear_init(gen, d_model, cfg.state_dim, **kw),
        "in_C": L.linear_init(gen, d_model, cfg.state_dim, **kw),
        "in_dt": L.linear_init(gen, d_model, nheads, **kw),
        "conv_x": conv(d_in),
        "conv_B": conv(cfg.state_dim),
        "conv_C": conv(cfg.state_dim),
        "dt_bias": dt_bias.to(dtype),
        "a_log": torch.zeros((*lead, nheads), dtype=dtype, device=device),
        "d_skip": torch.ones((*lead, nheads), dtype=dtype, device=device),
        "norm": L.rmsnorm_init(d_in, **kw),
        "out_proj": L.linear_init(gen, d_in, d_model, **kw),
    }


def _conv(p: dict, x: torch.Tensor, state: torch.Tensor | None):
    """Depthwise causal conv. x: [B, T, C]; p['w']: [K, C]; the state is
    the last K-1 inputs. Returns (silu(conv(x)) [B, T, C], new state
    [B, K-1, C])."""
    x = S.reduced(x)            # a projection's pending sum, before the bias
    w = p["w"].to(x.dtype)
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                  # [B, T+K-1, C]
    t = x.shape[1]
    y = xp[:, :t] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + t] * w[i]
    y = y + p["b"].to(x.dtype)
    return L.silu(y), xp[:, -(k - 1):]


def _inputs(p: dict, x: torch.Tensor, conv_state: dict | None,
            compute_dtype):
    """The projections, x, B and C through their convs (with the carried
    states), and dt = softplus(dt + dt_bias) in f32. Returns (z, x, B, C,
    dt, new conv state)."""
    z = L.linear(p["in_z"], x, compute_dtype)
    cs = conv_state or {"x": None, "B": None, "C": None}
    xi, ncx = _conv(p["conv_x"], L.linear(p["in_x"], x, compute_dtype),
                    cs["x"])
    bi, ncb = _conv(p["conv_B"], L.linear(p["in_B"], x, compute_dtype),
                    cs["B"])
    ci, ncc = _conv(p["conv_C"], L.linear(p["in_C"], x, compute_dtype),
                    cs["C"])
    dt = softplus(S.reduced(L.linear(p["in_dt"], x, compute_dtype)).to(F32)
                  + p["dt_bias"].to(F32))
    return z, xi, bi, ci, dt, {"x": ncx, "B": ncb, "C": ncc}


def _out(p: dict, y, xh, z, shape, compute_dtype):
    """Skip, gate, norm and output projection."""
    y = y + xh * p["d_skip"].to(y.dtype)[..., :, None]
    y = L.rmsnorm(p["norm"], S.merge_heads(y, shape) * L.silu(z))
    return L.linear(p["out_proj"], y, compute_dtype)


def mamba2_apply(p: dict, x: torch.Tensor, d_model: int, cfg: SSMConfig, *,
                 la_chunk: int = 64, compute_dtype=None,
                 conv_state: dict | None = None,
                 ssm_state: torch.Tensor | None = None,
                 return_state: bool = False):
    """Full-sequence Mamba2. x: [B, T, d]. conv_state: {"x","B","C"} or
    None. With ``return_state`` returns (out, conv state, SSM state)."""
    b, t, _ = x.shape
    d_in, nheads = _dims(d_model, cfg)
    z, xi, bi, ci, dt, conv = _inputs(p, x, conv_state, compute_dtype)
    a = -torch.exp(p["a_log"].to(F32))                            # [H]
    log_w = dt * a                                                # [B,T,H]

    xh = S.split_heads(xi, nheads, cfg.head_dim)
    v = xh * dt[..., None].to(xh.dtype)
    k = bi[:, :, None, :].expand(b, t, nheads, cfg.state_dim)
    q = ci[:, :, None, :].expand(b, t, nheads, cfg.state_dim)
    y, final_state = chunked_linear_attention(
        q, k, v, log_w, chunk=la_chunk, initial_state=ssm_state,
        scalar_decay=True)
    out = _out(p, y, xh, z, (b, t, d_in), compute_dtype)
    if return_state:
        return out, conv, final_state
    return out


def mamba2_decode_step(p: dict, x: torch.Tensor, d_model: int,
                       cfg: SSMConfig, *, conv_state: dict,
                       ssm_state: torch.Tensor, compute_dtype=None):
    """One token. x: [B, 1, d]; conv_state: {"x","B","C"} each
    [B, K-1, C]; ssm_state: [B, H, N, P]. Returns (out [B, 1, d],
    conv_state', ssm_state')."""
    b = x.shape[0]
    d_in, nheads = _dims(d_model, cfg)
    z, xi, bi, ci, dt, conv = _inputs(p, x, conv_state, compute_dtype)
    xi, bi, ci, dt = xi[:, 0], bi[:, 0], ci[:, 0], dt[:, 0]
    a = -torch.exp(p["a_log"].to(F32))
    log_w = (dt * a)[..., None].expand(b, nheads, cfg.state_dim)

    xh = S.split_heads(xi, nheads, cfg.head_dim)
    v = xh * dt[..., None].to(xh.dtype)
    k = bi[:, None, :].expand(b, nheads, cfg.state_dim)
    q = ci[:, None, :].expand(b, nheads, cfg.state_dim)
    y, new_ssm = linear_attention_step(q, k, v, log_w, ssm_state)
    out = _out(p, y, xh, z, (b, 1, d_in), compute_dtype)
    return out, conv, new_ssm
