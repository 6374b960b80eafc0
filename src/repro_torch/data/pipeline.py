"""Deterministic synthetic data pipeline (the JAX package's
``data/pipeline.py``, copied: the numpy generator is the same, so both
packages draw byte-identical batches).

Design for fault tolerance: a batch is a PURE FUNCTION of (seed, step) — no
iterator state to checkpoint, and a restarted job regenerates exactly the
token stream it would have seen.

Two tasks:
  * "chain":  x_{t+1} = (a * x_t + b) mod V with per-sequence (a, b) —
              learnable structure (loss visibly decreases within ~100 steps).
  * "uniform": i.i.d. tokens — throughput benchmarking only.

For embeddings-mode architectures (vlm/audio) the stub frontend maps token
ids through a FIXED random projection table (not trained — it stands in for
the modality encoder).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as S


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    task: str = "chain"
    # stub-frontend projection table size (embeddings mode)
    frontend_vocab: int = 4096


def _chain_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    # small multiplier pool: keeps the chain structure inferable from a short
    # context, so loss drops within the convergence tests' 40-step budget
    a = rng.integers(1, min(vocab, 17), (batch, 1))
    b = rng.integers(0, vocab, (batch, 1))
    x0 = rng.integers(0, vocab, (batch, 1))
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, :1] = x0
    for t in range(seq):
        toks[:, t + 1] = (toks[:, t] * a[:, 0] + b[:, 0]) % vocab
    return toks


def make_batch(cfg: ArchConfig, data_cfg: DataConfig, step: int,
               batch: int, seq: int) -> dict:
    """Host-side numpy batch for (step); deterministic."""
    rng = np.random.default_rng(
        np.random.SeedSequence([data_cfg.seed, step, 0xC0FFEE]))
    if data_cfg.task == "chain":
        toks = _chain_batch(rng, batch, seq, cfg.vocab)
    else:
        toks = rng.integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    inputs_ids, labels = toks[:, :-1], toks[:, 1:].astype(np.int32)

    out = {"labels": labels}
    if cfg.input_mode == "tokens":
        out["inputs"] = inputs_ids
    else:
        # stub frontend: fixed random projection of ids -> embeddings
        table = _frontend_table(cfg, data_cfg)
        out["inputs"] = table[inputs_ids % table.shape[0]]
    if cfg.pos_embed == "mrope":
        pos = np.broadcast_to(np.arange(seq)[None, :, None],
                              (batch, seq, 3)).astype(np.int32)
        out["positions"] = np.ascontiguousarray(pos)
    return out


_FRONTEND_CACHE: dict = {}


def _frontend_table(cfg: ArchConfig, data_cfg: DataConfig) -> np.ndarray:
    key = (cfg.arch_id, cfg.d_model, data_cfg.frontend_vocab)
    if key not in _FRONTEND_CACHE:
        rng = np.random.default_rng(np.random.SeedSequence([data_cfg.seed, 7]))
        _FRONTEND_CACHE[key] = (rng.standard_normal(
            (data_cfg.frontend_vocab, cfg.d_model)) / np.sqrt(cfg.d_model)
        ).astype(np.float32)
    return _FRONTEND_CACHE[key]


class ShardedLoader:
    """Puts (seed, step)-addressable batches on one device (the card unless
    the caller passes ``device="cpu"``), or with ``shardings`` (a dict of
    ``sharding.NamedSharding`` per batch key) onto a mesh: every rank makes
    the same batch and keeps its own block of it, with no communication."""

    def __init__(self, cfg: ArchConfig, data_cfg: DataConfig, *, batch: int,
                 seq: int, device="cuda", shardings: Optional[dict] = None):
        self.cfg, self.data_cfg = cfg, data_cfg
        self.batch, self.seq = batch, seq
        self.device = _device.resolve(device)
        self.shardings = shardings

    def get(self, step: int) -> dict:
        host = make_batch(self.cfg, self.data_cfg, step, self.batch, self.seq)
        out = {k: torch.from_numpy(v).to(self.device)
               for k, v in host.items()}
        if self.shardings is None:
            return out
        return {k: S.place(v, self.shardings[k].mesh, self.shardings[k].spec,
                           from_rank=None) for k, v in out.items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.get(step)
            step += 1
