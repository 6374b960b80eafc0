"""repro_torch: the configurable multi-port memory system in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

A port of the JAX package ``repro`` (which stays the reference), module by
module: configs, core (the paper's port semantics), kernels, models, the
paged multi-port KV pool, the serving engine and its launcher. It imports
torch and numpy, never JAX. Entry points run on the card unless the caller
passes ``device="cpu"``, where the kernels' plain torch versions run.
"""

__version__ = "0.1.0"
