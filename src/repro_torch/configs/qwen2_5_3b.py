"""qwen2.5-3b — dense GQA with QKV bias. [hf:Qwen/Qwen2.5-3B; hf]"""
from repro_torch.configs.base import ArchConfig

ARCH_ID = "qwen2.5-3b"


def full() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID, family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        d_ff=11008, vocab=151936, qkv_bias=True, rope_theta=1000000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID + "-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, qkv_bias=True,
        q_chunk=16, la_chunk=8,
    )
