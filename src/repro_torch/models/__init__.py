"""Decoders of all six families (dense, moe, vlm, audio, ssm, hybrid):
init, the JAX parameter bridge, the whole-prompt forward and prefill,
decode state, decode step, chunked prefill (the KV-cache families) and the
training loss (``model.py``)."""
from repro_torch.models.model import (KV_FAMILIES, decode_step, forward,
                                      init_decode_state, init_params,
                                      loss_fn, params_from_numpy, prefill,
                                      prefill_chunk)

__all__ = ["KV_FAMILIES", "init_params", "params_from_numpy", "forward",
           "loss_fn", "prefill", "init_decode_state", "decode_step",
           "prefill_chunk"]
