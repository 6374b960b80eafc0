"""Decoders of the KV-cache families (dense, moe, vlm, audio): init, the JAX
parameter bridge, the whole-prompt forward and prefill, decode state,
decode step and chunked prefill, and the training loss (``model.py``)."""
from repro_torch.models.model import (KV_FAMILIES, decode_step, forward,
                                      init_decode_state, init_params,
                                      loss_fn, params_from_numpy, prefill,
                                      prefill_chunk)

__all__ = ["KV_FAMILIES", "init_params", "params_from_numpy", "forward",
           "loss_fn", "prefill", "init_decode_state", "decode_step",
           "prefill_chunk"]
