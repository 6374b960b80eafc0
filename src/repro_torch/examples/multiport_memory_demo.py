"""The paper's Figures 4 & 6, in software: configure the wrapper as 4-, 3-,
2- and 1-port on successive macro-cycles, drive all ports, and print the
clock-generator waveform plus the serviced transactions.

    PYTHONPATH=src python -m repro_torch.examples.multiport_memory_demo
    PYTHONPATH=src python -m repro_torch.examples.multiport_memory_demo \\
        --device cpu

The storage and every request live on ``--device`` (the card by default);
the request addresses are drawn by ``np.random.default_rng(0)``, as in the
JAX package's ``examples/multiport_memory_demo.py``, so the read lanes are
the same.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import (READ, WRITE, MemorySpec, PortConfig,
                              build_schedule, empty_request, read_request,
                              simulate_waveform, step, write_request)

CONFIGS = [
    PortConfig((True,) * 4, (WRITE, READ, WRITE, READ)),          # 4-port
    PortConfig((True, True, True, False), (WRITE, READ, READ, READ)),
    PortConfig((True, True, False, False), (WRITE, READ, READ, READ)),
    PortConfig((True, False, False, False), (READ, READ, READ, READ)),
]


def waveform_ascii(w, names=("CLK ", "CLKP", "BACK", "CLK2")) -> None:
    for name, sig in zip(names, (w.clk, w.clkp, w.back, w.clk2)):
        print(f"  {name} " + "".join("▔" if v else "▁" for v in sig))
    sel = "".join(str(p) if p >= 0 else "." for p in w.selected_port)
    print(f"  port {sel}")


def main(argv=None) -> dict:
    """Prints the waveform and the walk; returns {"waveform": the
    ``Waveform``, "slots": each cycle's service order, "reads": each
    cycle's {read port: lane 0 as a list}}."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples."
                                 "multiport_memory_demo")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the storage (default: cuda)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    spec = MemorySpec(num_words=32, word_width=4, num_banks=4)
    storage = spec.init_storage(device=dev)

    print("== clock generator (paper Fig. 4): BACK=N, CLK2=N-1 pulses ==")
    wave = simulate_waveform(CONFIGS, resolution=12)
    waveform_ascii(wave)

    print("\n== functional walk (paper Fig. 6) ==")
    rng = np.random.default_rng(0)
    out = {"waveform": wave, "slots": [], "reads": []}
    for cyc, cfg in enumerate(CONFIGS):
        sched = build_schedule(cfg)
        reqs = []
        for p in range(4):
            if not cfg.enabled[p]:
                reqs.append(empty_request(4, spec.word_width, device=dev))
            elif cfg.roles[p] == WRITE:
                reqs.append(write_request(
                    torch.as_tensor(rng.integers(0, 32, 4), dtype=torch.int32,
                                    device=dev),
                    torch.full((4, 4), float(10 * (p + 1)), device=dev)))
            else:
                reqs.append(read_request(rng.integers(0, 32, 4), 4,
                                         device=dev))
        storage, reads = step(spec, cfg, storage, reqs)
        served = " > ".join("ABCD"[s] + ("W" if cfg.roles[s] == WRITE else "R")
                            for s in sched.slots)
        print(f"cycle {cyc}: {cfg.describe():28s} slots: {served}")
        lanes = {}
        for p in range(4):
            if cfg.enabled[p] and cfg.roles[p] == READ:
                lanes[p] = reads[p][0].cpu().numpy()
                print(f"    port {'ABCD'[p]} read lane0 -> {lanes[p]}")
        out["slots"].append(tuple(sched.slots))
        out["reads"].append({p: v.tolist() for p, v in lanes.items()})
    print("\n4x transactions per cycle in 4-port mode — one storage traversal.")
    return out


if __name__ == "__main__":
    main()
