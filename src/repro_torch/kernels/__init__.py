"""Hand-written Hopper kernels for the hot spots the paper's technique
optimizes, each beside a plain torch version of the same function:

  multiport_sram   — the N-port memory step (the wrapper itself)
  kv_multiport     — fused decode append+attend over the multi-port KV cache,
                     serial or split-KV (partial banks + LSE combine)
  kv_prefill_chunk — fused chunked-prefill append+attend
  flash_attention  — causal GQA flash attention over whole sequences (f32:
                     scores on the CUDA cores, P V in 3xTF32; bf16 on the
                     tensor cores)

``ops.py`` holds the public wrappers and ``ref.py`` the two-pass oracles.
The CUDA sources live in ``repro_torch/csrc`` and are built at first use
(``_build.py``); :func:`launch_counts` reports how often each was launched.
"""
from repro_torch.kernels import (flash_attention, kv_multiport,
                                 kv_prefill_chunk, multiport_sram)
from repro_torch.kernels._build import (build, launch_counts,
                                        reset_launch_counts)

__all__ = ["build", "launch_counts", "reset_launch_counts",
           "flash_attention", "kv_multiport", "kv_prefill_chunk",
           "multiport_sram"]
