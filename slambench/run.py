"""The benchmark's command: one run of one cell on the card.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the run's JSON result; the numbers
that decide ``correct`` close standard error. See slambench/README.md.
"""

import os
import sys
import time

T_START = time.perf_counter()

BENCH = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(BENCH, ".cache")
# every compile cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
# one process, few threads: the host issues the work, and idle worker
# pools spinning beside it only add noise to what the runs read
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, os.path.dirname(BENCH))

from slambench.harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.run(sys.argv[1:], T_START))
