"""llama3-405b — dense GQA frontier model. [arXiv:2407.21783; unverified]

Memory note (EXPERIMENTS.md §Dry-run): AdamW fp32 states alone are 3.24 TB;
the training config therefore defaults to the int8 quantized optimizer
(optim.quantized) and FSDP over ("pod", "data")."""
from repro_torch.configs.base import ArchConfig

ARCH_ID = "llama3-405b"


def full() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID, family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab=128256, rope_theta=500000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID + "-reduced", family="dense",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=192, vocab=256,
        q_chunk=16, la_chunk=8,
    )
