"""Registry of the 10 assigned architectures: ``get(arch_id, reduced=...)``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str, *, reduced: bool = False) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.reduced() if reduced else mod.full()


def all_configs(*, reduced: bool = False) -> dict[str, ArchConfig]:
    return {a: get(a, reduced=reduced) for a in ARCH_IDS}
