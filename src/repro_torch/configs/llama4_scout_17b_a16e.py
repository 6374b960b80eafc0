"""llama4-scout-17b-a16e — MoE, 16 routed experts top-1 + 1 shared.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
Early-fusion multimodality is a frontend concern; the text backbone below is
what trains/serves (DESIGN.md §5)."""
from repro_torch.configs.base import ArchConfig, MoEConfig

ARCH_ID = "llama4-scout-17b-a16e"


def full() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID, family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048, rope_theta=500000.0,
        moe=MoEConfig(n_experts=16, top_k=1, d_expert=8192, n_shared=1,
                      capacity_factor=1.25),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        notes="MoE every layer; 1 shared + top-1 of 16 routed (HF config).",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID + "-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=1, d_expert=32, n_shared=1,
                      capacity_factor=2.0),
        q_chunk=16, la_chunk=8,
    )
