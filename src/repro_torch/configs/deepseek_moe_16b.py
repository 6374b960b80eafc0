"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

ARCH_ID = "deepseek-moe-16b"


def full() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID, family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=102400, rope_theta=10000.0,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                      capacity_factor=1.25),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        notes="Fine-grained experts (d_expert = d_ff = 1408).",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID + "-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=2,
                      capacity_factor=2.0),
        q_chunk=16, la_chunk=8,
    )
