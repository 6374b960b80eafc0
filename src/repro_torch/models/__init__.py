"""Dense decoder: init, the JAX parameter bridge, the whole-prompt forward
and prefill, decode state, decode step and chunked prefill (``model.py``)."""
from repro_torch.models.model import (decode_step, forward, init_decode_state,
                                      init_params, params_from_numpy, prefill,
                                      prefill_chunk)

__all__ = ["init_params", "params_from_numpy", "forward", "prefill",
           "init_decode_state", "decode_step", "prefill_chunk"]
