"""tinyllama-1.1b — llama2-architecture small model. [arXiv:2401.02385; hf]"""
from repro_torch.configs.base import ArchConfig

ARCH_ID = "tinyllama-1.1b"


def full() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID, family="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=5632, vocab=32000, rope_theta=10000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID + "-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab=256,
        q_chunk=16, la_chunk=8,
    )
