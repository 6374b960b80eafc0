"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on NVIDIA
H100 cards: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See ``harness.py``."""
