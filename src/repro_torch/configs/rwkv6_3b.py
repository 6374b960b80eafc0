"""rwkv6-3b (Finch) — attention-free RNN with data-dependent decay.
[arXiv:2404.05892; hf]

n_heads/n_kv_heads are nominal (d_model / rwkv.head_dim); there is no
attention. The paper's KV-cache technique is inapplicable here (O(1) state,
one reader + one writer) — see DESIGN.md §5."""
from repro_torch.configs.base import ArchConfig, RwkvConfig

ARCH_ID = "rwkv6-3b"


def full() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID, family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=8960, vocab=65536,
        rwkv=RwkvConfig(head_dim=64, lora_dim=64),
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID + "-reduced", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        rwkv=RwkvConfig(head_dim=16, lora_dim=8),
        q_chunk=16, la_chunk=8,
    )
