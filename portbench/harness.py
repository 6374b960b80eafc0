"""The benchmark's harness, driven by data.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; the harness
finds by name its configuration (``portbench/configs/<config>.json``), its
traffic mix (``portbench/traffic/<traffic>.json``), its deployment
(``portbench/workloads/<cell>.json``: the driver module under
``portbench/``, the engine's settings, the warm-up and the check's limit) and a reader for each metric
(``portbench/metrics/<metric>.py``, a ``read(run)`` that returns the number
or None where it finds nothing to read). A new configuration, mix, cell or
metric is new files and new entries; no file here changes.

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace
of the window. The result is the last line of standard output; the numbers
compared and their limits are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, name: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): an entry with ``workloads`` lists its cells; one without
    it goes to every cell that reports what it moves."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name]) and m["moves"] in moved]


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, device, t_start: float):
    """Run one cell on ``device``; returns (the driver's run, the cell's
    metrics as {name: {"value", "unit"}})."""
    bench = benchmark()
    entry = cell(bench, args.workload)
    workload = load_json(HERE / "workloads" / f"{args.workload}.json")
    cfg = config_of(bench, entry["config"])
    from portbench.traffic import generator
    mix = generator.load(entry["traffic"])
    driver = importlib.import_module(f"portbench.{workload['driver']}")
    wanted = metrics_of(bench, args.workload, bool(args.trace))
    readers = {m["name"]: reader(m["name"]) for m in wanted}
    run = driver.run_cell(cfg, workload, mix, args.seed, args.seconds,
                          bool(args.trace), device, t_start)
    values = {}
    for m in wanted:
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return run, values


def main(argv, t_start: float) -> int:
    args = parse(argv)
    import torch
    bench = benchmark()
    chips = cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run, values = execute(args, device, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    checks = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
              for k, c in run.checks.items()}
    recs = run.attempted()
    result = {
        "correct": bool(run.correct),
        "attempted": len(recs),
        "failed": sum(1 for r in recs if r.req.shed_reason is not None),
        "metrics": values,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips,
                   "memory_peak_bytes": int(run.memory_peak_bytes)},
    }
    if args.trace:
        from portbench import tracing
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.window_s
        result["breakdown"] = tracing.breakdown(run.trace)
    # seconds of set-up spent loading the kernels: the build with nvcc in a
    # checkout's first run, a load from the checkout's build/ after it
    result["build_s"] = run.build_s
    result["checks"] = checks
    print("readings " + " ".join(f"{k} {v}" for k, v in run.readings.items())
          + f" over {sum(len(t) for t in run.sample[2])} served tokens of "
          f"{len(run.sample[0])} requests", file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def _finite(x: float):
    return x if math.isfinite(x) else None
