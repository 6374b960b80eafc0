"""qwen2-0.5b — dense GQA with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig

ARCH_ID = "qwen2-0.5b"


def full() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID, family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151936, qkv_bias=True, head_dim=64,
        rope_theta=1000000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID + "-reduced", family="dense",
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
        d_ff=128, vocab=256, qkv_bias=True, head_dim=8,
        q_chunk=16, la_chunk=8,
    )
