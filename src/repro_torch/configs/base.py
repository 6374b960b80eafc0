"""Architecture & shape configuration system.

``ArchConfig`` fully describes a model; ``ShapeCell`` describes one
(seq_len, global_batch, kind) workload cell. The 10 assigned architectures
live in sibling modules, registered in ``registry.py``; each provides both the
full published config and a ``reduced()`` variant for CPU smoke tests.
The dataclasses are the JAX package's, copied; only ``pdtype``/``cdtype``
return torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Sequence

import torch

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 geometry."""
    state_dim: int = 64           # N
    head_dim: int = 64            # P
    expand: int = 2
    conv_kernel: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class RwkvConfig:
    """RWKV6 (Finch) geometry."""
    head_dim: int = 64
    lora_dim: int = 64            # data-dependent decay LoRA rank


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: one SHARED attention block applied before every
    group of ``group_size`` Mamba2 layers (plus leftover Mamba2 layers)."""
    group_size: int = 6
    attn_d_ff: int = 14336        # the shared block's MLP width


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    head_dim: Optional[int] = None              # default d_model // n_heads
    pos_embed: Literal["rope", "mrope", "sinusoidal"] = "rope"
    rope_theta: float = 10000.0
    mrope_sections: Sequence[int] = (16, 24, 24)
    input_mode: Literal["tokens", "embeddings"] = "tokens"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RwkvConfig] = None
    hybrid: Optional[HybridConfig] = None
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    q_chunk: int = 1024                          # attention query chunking
    la_chunk: int = 64                           # linear-attention chunk
    remat: Literal["none", "block"] = "block"
    z_loss: float = 1e-4
    notes: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode (SSM/hybrid/linear-attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline terms)."""
        d, v = self.d_model, self.vocab
        total = v * d                                     # lm_head
        if self.input_mode == "tokens":
            total += v * d                                # embed table
        hd = self.head_dim_
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.family == "ssm":                          # rwkv6
            tm = 5 * d * d                                # r,k,v,g,o
            lora = 2 * self.rwkv.lora_dim * d + d         # decay lora + w0
            cm = 2 * d * self.d_ff + d * d                # wk, wv, wr
            total += self.n_layers * (tm + lora + cm + 4 * d)
            return total
        if self.family == "hybrid":
            ssm = self.ssm
            d_in = ssm.expand * d
            conv_dim = d_in + 2 * ssm.state_dim
            nheads = d_in // ssm.head_dim
            in_proj = d * (2 * d_in + 2 * ssm.state_dim + nheads)
            mamba = in_proj + conv_dim * ssm.conv_kernel + d_in * d + 2 * nheads + d_in
            total += self.n_layers * (mamba + 2 * d)
            shared = attn + 3 * d * self.hybrid.attn_d_ff + 2 * d
            total += shared                               # shared block counted once
            return total
        ffn = 3 * d * self.d_ff
        if self.moe is not None:
            m = self.moe
            ffn = (m.n_experts * 3 * d * m.d_expert + d * m.n_experts
                   + (3 * d * m.n_shared * m.d_expert if m.n_shared else 0))
        total += self.n_layers * (attn + ffn + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE top-k); == param_count for dense."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        full_ffn = m.n_experts * 3 * d * m.d_expert
        active_ffn = m.top_k * 3 * d * m.d_expert
        return (self.param_count()
                - self.n_layers * (full_ffn - active_ffn))


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


LM_SHAPES: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def applicable_shapes(cfg: ArchConfig) -> list[ShapeCell]:
    """Shape cells this arch actually runs (long_500k needs sub-quadratic)."""
    out = []
    for cell in LM_SHAPES:
        if cell.name == "long_500k" and not cfg.sub_quadratic:
            continue  # skip noted in DESIGN.md §5
        out.append(cell)
    return out
