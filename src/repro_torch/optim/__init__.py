"""Optimizers: AdamW (f32 states), 8-bit AdamW (int8 block-quantized states),
Adafactor (factored states). Selected by name via ``make_optimizer``."""
from __future__ import annotations

from typing import Callable

from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.quantized import adamw8bit_init, adamw8bit_update
from repro_torch.optim.schedules import constant, warmup_cosine

_OPTS = {
    "adamw": (adamw_init, adamw_update),
    "adamw8bit": (adamw8bit_init, adamw8bit_update),
    "adafactor": (adafactor_init, adafactor_update),
}


def make_optimizer(name: str, cfg: AdamWConfig | None = None
                   ) -> tuple[Callable, Callable, AdamWConfig]:
    """Returns (init_fn(params), update_fn(grads, state, params, lr), cfg)."""
    cfg = cfg or AdamWConfig()
    init, update = _OPTS[name]
    return (lambda p: init(p, cfg),
            lambda g, s, p, lr: update(g, s, p, lr, cfg),
            cfg)


__all__ = ["AdamWConfig", "make_optimizer", "global_norm", "warmup_cosine",
           "constant", "adamw_init", "adamw_update", "adamw8bit_init",
           "adamw8bit_update", "adafactor_init", "adafactor_update"]
