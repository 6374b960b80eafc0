"""Phase 8b's sharded training step with a card a rank, on a host of 4
cards:

    python3 chip_mesh.py

tinyllama-1.1b at its published widths, bf16, AdamW, batch 8 x 1024, over
(data 2, model 2): ``launch.local_ranks`` starts 4 ranks, one on each card,
and picks NCCL for them (``peermem.choose_backend``). Before the ranks
start, this process takes the same first step on one card; the ranks'
first ce is held to it within ``chip_smoke.py``'s bf16 tolerance. Prints
each step's ce, grad_norm and seconds by rank, each rank's peak memory,
and the seconds of each phase. Exits non-zero with fewer than 4 cards and
when a check fails. ``chip_smoke.py`` runs phase 8 on one card, its ranks
sharing the card over the peer-memory group.
"""
from __future__ import annotations

import os
import sys
import time

import torch

import chip_smoke as C

CARDS = 4
STEPS = 3


def one_device_ce() -> float:
    """The first AdamW step's ce of ``launch.train``'s own build on card
    0 (phase 7's one-device reference), its memory freed after."""
    _, s = C._train_setup(C.TRAIN + ["--steps", "1"])
    state, s.state = s.state, None
    _, metrics = s.step(state, s.loader.get(0))
    ce = C._record(metrics)["ce"]
    del state, s, metrics
    torch.cuda.empty_cache()
    return ce


def nccl_steps(card: str, ce1: float) -> None:
    """8b's rank body on 4 ranks with a card each over NCCL: the first ce
    within the bf16 tolerance of one card's, each step's seconds by rank
    and each rank's peak memory."""
    from repro_torch.launch import local_ranks
    t0 = time.perf_counter()
    ranks = local_ranks.run(
        "chip_smoke:rank_full_width", CARDS, device="cuda",
        kwargs=dict(argv=C.TRAIN + ["--steps", str(STEPS)], steps=STEPS,
                    backend="nccl"),
        timeout=C.MESH_TIMEOUT, path=[str(C.ROOT)],
        workdir=str(C.ROOT / "build" / "chip_mesh" / "nccl"))
    r0 = ranks[0]
    ce = r0["steps"][0]["ce"]
    if abs(ce - ce1) > C.BF16_TOL:
        raise AssertionError(f"NCCL step 1 ce {ce} != one card's {ce1} "
                             f"(limit {C.BF16_TOL})")
    for i, rec in enumerate(r0["steps"]):
        print(f"mesh nccl [tinyllama-1.1b, published widths, bf16, AdamW, "
              f"batch 8 x 1024, data 2 x model 2, {CARDS} ranks on "
              f"{CARDS} cards, NCCL] step {i}: ce {rec['ce']:.6f}, "
              f"grad_norm {rec['grad_norm']:.4f}; seconds by rank "
              f"{', '.join(C._secs(r, i) for r in ranks)} ({card})")
    print(f"mesh nccl: step 1 ce {ce:.6f} vs one card {ce1:.6f} (|diff| "
          f"{abs(ce - ce1):.3g}, limit {C.BF16_TOL}); peak memory by rank "
          f"{', '.join(C._gib(r['peak']) for r in ranks)}; init "
          f"{r0['init_s']:.1f} s; job {time.perf_counter() - t0:.1f} s "
          f"({card})")


def main(argv: list) -> int:
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        print(f"chip_mesh: needs {CARDS} CUDA devices", file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(C.ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C._card()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")
    lap = C.Laps(card)
    ce1 = one_device_ce()
    print(f"one card [tinyllama-1.1b, published widths, bf16, AdamW, batch "
          f"8 x 1024] step 0: ce {ce1:.6f} ({card})")
    lap("one card")
    nccl_steps(card, ce1)
    lap("8b over NCCL")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
