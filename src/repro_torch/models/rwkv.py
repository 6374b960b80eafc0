"""RWKV6 (Finch) block: time-mix with data-dependent decay + channel-mix.

The Finch recurrence (per-channel data-dependent decay w_t and
current-token bonus u), executed by the shared chunked linear-attention
engine (``linear_scan.py``). As in the JAX package, the token-shift
interpolation uses static per-channel mix coefficients (RWKV5-style lerp)
rather than the data-dependent ddlerp; the decay keeps the full
data-dependent LoRA, computed in f32.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.configs.base import RwkvConfig
from repro_torch.distributed import sharding as S
from repro_torch.models import layers as L
from repro_torch.models.linear_scan import (chunked_linear_attention,
                                            linear_attention_step)

F32 = torch.float32
NORM_EPS = 1e-5          # the per-head norm's


def time_mix_init(gen, d: int, cfg: RwkvConfig, dtype=torch.float32,
                  device="cuda", lead: tuple = ()) -> dict:
    """The JAX package's distributions: lerps N(0, 0.02), projections
    N(0, 1/d), decay bias N(-6, 0.5), LoRA in N(0, 1/d) and out N(0,
    0.02), bonus N(0, 0.02), norm scales 1."""
    device = _device.resolve(device)
    h = d // cfg.head_dim
    kw = dict(dtype=dtype, device=device, lead=lead)

    def normal(shape, std):
        return L.normal_init(gen, (*lead, *shape), dtype, std, device)
    return {
        "mix": normal((5, d), 0.02),                    # r,k,v,w,g lerps
        "wr": L.linear_init(gen, d, d, **kw),
        "wk": L.linear_init(gen, d, d, **kw),
        "wv": L.linear_init(gen, d, d, **kw),
        "wg": L.linear_init(gen, d, d, **kw),
        "wo": L.linear_init(gen, d, d, **kw),
        "w0": normal((d,), 0.5) - 6.0,                  # decay bias
        "w_lora_a": L.fan_in_init(gen, (*lead, d, cfg.lora_dim), dtype,
                                  device),
        "w_lora_b": normal((cfg.lora_dim, d), 0.02),
        "u": normal((h, cfg.head_dim), 0.02),
        "ln_scale": torch.ones((*lead, h, cfg.head_dim), dtype=dtype,
                               device=device),          # per-head norm
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: y_t = x_{t-1}; position 0 takes ``prev`` (or zeros)."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x, xx, m):
    return x + (xx - x) * m.to(x.dtype)


def _log_decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel log decay, <= 0 (Finch), in f32."""
    lora = torch.tanh(xw.to(F32) @ p["w_lora_a"].to(F32)) @ \
        p["w_lora_b"].to(F32)
    return -torch.exp(p["w0"].to(F32) + lora)            # [B,T,d] (or [B,d])


def _head_norm_gate(p: dict, y: torch.Tensor, g: torch.Tensor,
                    out_shape: tuple, dtype) -> torch.Tensor:
    """Per-head normalization (a GroupNorm analogue) in f32, then the
    SiLU gate; cast to ``dtype``."""
    yf = y.to(F32)
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + NORM_EPS) * p["ln_scale"].to(F32)
    return (S.merge_heads(yf, out_shape) * L.silu(g).to(F32)).to(dtype)


def _projections(p: dict, x: torch.Tensor, xx: torch.Tensor, heads: tuple,
                 compute_dtype):
    """r, k, v and the log decay split into ``heads`` (H, K), and the gate
    g."""
    xr, xk, xv, xw, xg = (_mix(x, xx, p["mix"][i]) for i in range(5))
    r = S.split_heads(L.linear(p["wr"], xr, compute_dtype), *heads)
    k = S.split_heads(L.linear(p["wk"], xk, compute_dtype), *heads)
    v = S.split_heads(L.linear(p["wv"], xv, compute_dtype), *heads)
    g = L.linear(p["wg"], xg, compute_dtype)
    return r, k, v, g, S.split_heads(_log_decay(p, xw), *heads)


def time_mix_apply(p: dict, x: torch.Tensor, cfg: RwkvConfig, *,
                   la_chunk: int = 64, compute_dtype=None, shift_state=None,
                   ssm_state=None, return_state: bool = False):
    """x: [B, T, d]. Optional decode-style carried states; with
    ``return_state`` returns (out, the last input row [B, d], the final
    state [B, H, K, K] f32)."""
    b, t, d = x.shape
    h, hd = d // cfg.head_dim, cfg.head_dim
    r, k, v, g, lw = _projections(p, x, _shift(x, shift_state), (h, hd),
                                  compute_dtype)
    y, final_state = chunked_linear_attention(
        r, k, v, lw, chunk=la_chunk, bonus_u=p["u"], initial_state=ssm_state)
    y = _head_norm_gate(p, y, g, (b, t, d), x.dtype)
    out = L.linear(p["wo"], y, compute_dtype)
    if return_state:
        return out, x[:, -1], final_state
    return out


def time_mix_step(p: dict, x: torch.Tensor, cfg: RwkvConfig, *, shift_state,
                  ssm_state, compute_dtype=None):
    """One token. x: [B, 1, d]; shift_state: [B, d]; ssm_state:
    [B, H, K, V]. Returns (out [B, 1, d], x's row [B, d], new state)."""
    b, _, d = x.shape
    h, hd = d // cfg.head_dim, cfg.head_dim
    x0 = x[:, 0]
    r, k, v, g, lw = _projections(p, x0, shift_state.to(x0.dtype), (h, hd),
                                  compute_dtype)
    y, new_state = linear_attention_step(r, k, v, lw, ssm_state,
                                         bonus_u=p["u"])
    y = _head_norm_gate(p, y, g, (b, d), x.dtype)
    out = L.linear(p["wo"], y, compute_dtype)[:, None]
    return out, x0, new_state


def channel_mix_init(gen, d: int, d_ff: int, dtype=torch.float32,
                     device="cuda", lead: tuple = ()) -> dict:
    device = _device.resolve(device)
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "mix": L.normal_init(gen, (*lead, 2, d), dtype, 0.02, device),
        "wk": L.linear_init(gen, d, d_ff, **kw),
        "wv": L.linear_init(gen, d_ff, d, **kw),
        "wr": L.linear_init(gen, d, d, **kw),
    }


def _channel_mix(p: dict, x, xx, compute_dtype):
    xk = _mix(x, xx, p["mix"][0])
    xr = _mix(x, xx, p["mix"][1])
    k = torch.square(torch.relu(L.linear(p["wk"], xk, compute_dtype)))
    return torch.sigmoid(L.linear(p["wr"], xr, compute_dtype)) * \
        L.linear(p["wv"], k, compute_dtype)


def channel_mix_apply(p: dict, x: torch.Tensor, *, compute_dtype=None,
                      shift_state=None, return_state: bool = False):
    out = _channel_mix(p, x, _shift(x, shift_state), compute_dtype)
    if return_state:
        return out, x[:, -1]
    return out


def channel_mix_step(p: dict, x: torch.Tensor, *, shift_state,
                     compute_dtype=None):
    x0 = x[:, 0]
    out = _channel_mix(p, x0, shift_state.to(x0.dtype), compute_dtype)
    return out[:, None], x0
