"""Run one cell of the benchmark once, on the card it is started on.

    python3 perfbench/run.py --workload zamba2-train --seed 7 --seconds 20 --trace 0

Prints the result as the last line of standard output (see
``harness.py``).  Run from the root of a checkout: the program is
``src/repro_torch``, and every cache of a build stays inside the checkout.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench_cache"

if __name__ == "__main__":
    # fixed cache directories inside the checkout, set before torch loads
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness
    sys.exit(harness.main())
