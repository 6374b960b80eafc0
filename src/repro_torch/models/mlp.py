"""Feed-forward block: SwiGLU (llama family). The MoE layer waits for a
later slice of the port."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L


def swiglu_init(gen, d_model: int, d_ff: int, dtype=torch.float32,
                device="cuda", lead: tuple = ()) -> dict:
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "w_gate": L.linear_init(gen, d_model, d_ff, **kw),
        "w_up": L.linear_init(gen, d_model, d_ff, **kw),
        "w_down": L.linear_init(gen, d_ff, d_model, **kw),
    }


def swiglu_apply(p: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    g = L.linear(p["w_gate"], x, compute_dtype)
    u = L.linear(p["w_up"], x, compute_dtype)
    return L.linear(p["w_down"], L.swiglu(g, u), compute_dtype)
