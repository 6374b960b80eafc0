"""The control of a serving cell's check, and the readings its limit is
set from, on the card:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 10] [--control 1]

For each seed, one process runs the cell (the timed path, at the cell's
own load, for a short window), checks the sampled requests' served tokens
against the float32 reference as a run does (the program's reading), and
with ``--control 1`` reads the control on the same prompts and tokens: the
reference with every weight matrix in float8 e4m3, the step below the
configurations' bfloat16, taking at each position the token it puts first.
One JSON line a seed. The benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "portbench"]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness
    from portbench.reference import compare
    from portbench.reference import model as ref_model
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        run, values = harness.execute(argparse.Namespace(
            workload=args.workload, seed=seed, seconds=args.seconds,
            trace=0), device, t)
        seqs, pos, toks = run.sample
        ref = ref_model.logits(run.cfg, seed, seqs, pos, device)
        line = {"seed": seed, "program": compare.readings(ref, toks),
                "served": sum(len(x) for x in toks),
                "requests": len(seqs),
                "longest": max((len(x) for x in toks), default=0),
                "metrics": {k: v["value"] for k, v in values.items()}}
        if args.control:
            low = ref_model.logits(run.cfg, seed, seqs, pos, device,
                                   precision="fp8")
            line["control"] = compare.readings(
                ref, compare.control_tokens(low))
            del low
        del ref
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
