"""qwen2-vl-7b — VLM backbone with M-RoPE; the vision frontend is a stub
(input_specs supplies precomputed patch embeddings). [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig

ARCH_ID = "qwen2-vl-7b"


def full() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID, family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab=152064, qkv_bias=True, head_dim=128,
        pos_embed="mrope", mrope_sections=(16, 24, 24),
        rope_theta=1000000.0, input_mode="embeddings",
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID + "-reduced", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, qkv_bias=True, head_dim=16,
        pos_embed="mrope", mrope_sections=(4, 2, 2),
        input_mode="embeddings",
        q_chunk=16, la_chunk=8,
    )
