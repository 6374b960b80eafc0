"""Small configurations, mixes and deployments of the benchmark's cells,
for runs of the serving driver on the CPU."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from portbench import serve  # noqa: E402
from portbench.traffic import generator  # noqa: E402

CELLS = {"qwen2.5-3b.long_decode": ("qwen2.5-3b", "long_decode")}


def config(name: str, dtype: str = "float32") -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    kv = 2 if cfg["num_key_value_heads"] < cfg["num_attention_heads"] else 4
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=kv, intermediate_size=128, vocab_size=256,
               torch_dtype=dtype)
    return cfg


def cell(name: str, dtype: str = "float32") -> tuple:
    """(config, workload, mix) of a cell at a CPU test's size."""
    cfg_name, mix_name = CELLS[name]
    mix = generator.load(mix_name)
    mix = dict(mix, prompt=dict(mix["prompt"], lo=8, hi=40),
               output=dict(mix["output"], lo=4, hi=16), clients=4, block=4)
    wl = json.loads((ROOT / "portbench" / "workloads" / f"{name}.json")
                    .read_text())
    wl["engine"].update(max_len=64, chunk_tokens=16, seq_tile=16, slots=4,
                        max_slots=4)
    wl["correct"] = dict(wl["correct"], requests=8, limit=1e-3)
    return config(cfg_name, dtype), wl, mix


def run(name: str, seconds: float = 1.5, seed: int = 2**31 + 11,
        dtype: str = "float32", trace: bool = False):
    cfg, wl, mix = cell(name, dtype)
    return serve.run_cell(cfg, wl, mix, seed, seconds, trace,
                          torch.device("cpu"), time.perf_counter())
