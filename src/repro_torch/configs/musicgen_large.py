"""musicgen-large — decoder-only over EnCodec tokens; the audio frontend
(EnCodec + codebook interleaving) is a stub supplying frame embeddings.
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ArchConfig

ARCH_ID = "musicgen-large"


def full() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID, family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=2048, pos_embed="sinusoidal",
        input_mode="embeddings",
        param_dtype="bfloat16", compute_dtype="bfloat16",
        notes="MHA (kv == heads); sinusoidal absolute positions.",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        arch_id=ARCH_ID + "-reduced", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, pos_embed="sinusoidal",
        input_mode="embeddings",
        q_chunk=16, la_chunk=8,
    )
