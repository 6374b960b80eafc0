"""zamba2-7b — hybrid: Mamba2 backbone + one SHARED attention block applied
before every group of 6 Mamba2 layers. [arXiv:2411.15242; unverified]

81 layer slots = 13 groups x 6 Mamba2 + 3 tail Mamba2; the shared
transformer block (attn + MLP) is applied 13 times with one parameter set
(see DESIGN.md §5 for deviations from the released checkpoint)."""
from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig

ARCH_ID = "zamba2-7b"


def full() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID, family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab=32000, rope_theta=10000.0,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4),
        hybrid=HybridConfig(group_size=6, attn_d_ff=14336),
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID + "-reduced", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        ssm=SSMConfig(state_dim=16, head_dim=16),
        hybrid=HybridConfig(group_size=2, attn_d_ff=128),
        q_chunk=16, la_chunk=8,
    )
