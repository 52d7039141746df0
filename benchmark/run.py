"""Run one cell of the benchmark once, on the CUDA card of this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output (see ``benchmark/harness.py``); exits non-zero, with no
result, when the card is missing, when the run loaded JAX, or when the
program cannot be imported.
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The checkout's root, not this folder, is where imports start.
sys.path[0] = str(ROOT)
# Every build and kernel cache stays inside the checkout, at a fixed path.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / "benchmark" / sub)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=START))
