"""Dense decoder for serving: init, the JAX parameter bridge, decode state,
decode step and chunked prefill (``model.py``)."""
from repro_torch.models.model import (decode_step, init_decode_state,
                                      init_params, params_from_numpy,
                                      prefill_chunk)

__all__ = ["init_params", "params_from_numpy", "init_decode_state",
           "decode_step", "prefill_chunk"]
