"""Run one cell of the benchmark and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA devices;
``BENCHMARK.json`` at the root lists the cells.  Exits 2 without a result
where the devices are missing.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Only the checkout is searched first: the benchmark's own modules never shadow the library's.
sys.path[0] = str(ROOT)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
