"""A job of N ranks on this host: N processes, each joined to one process
group and running the same function, as ``torchrun`` would start them.

    results = local_ranks.run("pkg.module:fn", 4, device="cuda",
                              kwargs={...}, timeout=300)

Each rank calls ``fn(**kwargs)`` after joining the group (a ``FileStore``
in a fresh directory, so no port is fixed) and returns a JSON-able value;
``run`` returns every rank's value in rank order. Rank ``r`` computes on
card ``r mod cards``. The backend is ``peermem.choose_backend``'s: gloo on
the CPU, NCCL when each rank has a card of its own, and the peer-memory
group (``distributed/peermem.py``) when ranks share a card. An explicit
``backend=`` wins: ``"peermem"`` or ``"hoststaged"`` (whose collectives on
CPU tensors are gloo's, counted) put CPU ranks on those groups. A rank that
fails or a job that outlives ``timeout`` ends the whole job (no rank is
left waiting in a collective) and raises with the failing rank's log.

The command line below is the rank's side; ``run`` is the only caller.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2])


def run(target: str, world: int, *, device: str = "cuda",
        kwargs: dict | None = None, timeout: float = 300.0,
        path: list | None = None, workdir: str | None = None,
        backend: str | None = None) -> list:
    """Run ``target`` (``"module:function"``) on ``world`` ranks; returns
    each rank's result. ``path`` adds directories to the ranks' import
    path (the package's ``src`` is always there)."""
    if backend is None:
        from repro_torch.distributed import peermem
        cards = 0
        if device == "cuda":
            import torch
            cards = torch.cuda.device_count()
        backend = peermem.choose_backend(device, world, cards, world)
    work = Path(workdir or tempfile.mkdtemp(prefix="local_ranks_"))
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    if store.exists():
        store.unlink()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [*(str(p) for p in path or ()), SRC,
         *filter(None, [os.environ.get("PYTHONPATH")])]))
    procs = []
    for r in range(world):
        out = work / f"rank{r}.json"
        if out.exists():
            out.unlink()
        log = open(work / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.local_ranks",
             "--target", target, "--rank", str(r), "--world", str(world),
             "--store", str(store), "--device", device, "--timeout",
             str(timeout), "--out", str(out), "--backend", backend],
            stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT,
            env=dict(env, LOCAL_RANKS_KWARGS=json.dumps(kwargs or {}))),
            log))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = next((r for r, (p, _) in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        else:
            failed = next((r for r, (p, _) in enumerate(procs)
                           if p.returncode != 0), None)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed is None and any(p.returncode != 0 for p, _ in procs):
        failed = -1                         # killed at the deadline
    if failed is not None:
        r = max(failed, 0)
        tail = (work / f"rank{r}.log").read_text()[-6000:]
        why = ("outlived its limit of "
               f"{timeout:.0f} s" if failed < 0 else
               f"rank {r} exited {procs[r][0].returncode}")
        raise RuntimeError(f"local job {target} on {world} ranks: {why}; "
                           f"rank {r}'s log ends:\n{tail}")
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(world)]


def _rank_main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    for flag in ("--target", "--store", "--device", "--out", "--backend"):
        ap.add_argument(flag, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--timeout", type=float, required=True)
    a = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    if a.device == "cuda":
        torch.cuda.set_device(a.rank % torch.cuda.device_count())
    else:                       # the host's cores shared among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // a.world))
    options = None
    if a.backend == "peermem":
        from repro_torch.distributed import peermem

        peermem.register()
        options = peermem.Options(device=a.device)
    elif a.backend == "hoststaged":
        from repro_torch.distributed import hoststaged

        hoststaged.register()
    dist.init_process_group(a.backend, init_method=f"file://{a.store}",
                            rank=a.rank, world_size=a.world,
                            timeout=datetime.timedelta(seconds=a.timeout),
                            pg_options=options)
    mod, fn = a.target.split(":")
    result = getattr(importlib.import_module(mod), fn)(
        **json.loads(os.environ["LOCAL_RANKS_KWARGS"]))
    Path(a.out).write_text(json.dumps(result))
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main()
