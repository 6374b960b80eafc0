"""Run one cell of the port's benchmark on the card this process finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (the port under ``src/``). Prints one JSON
result line last on standard output; exits non-zero with no result when
CUDA or the cell's cards are missing, when a file it needs is missing, or
when the run loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the package is imported as ``portbench``, not its files as top-level names
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "portbench"]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"

if __name__ == "__main__":
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
