"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  The cells, configurations, traffic
mixes and metrics are listed in BENCHMARK.json at that root; see
portbench/core.py.  Exits 2, printing no result, without the CUDA
cards the cell asks for.
"""

import os
import sys
import time

_T0 = time.perf_counter()
# the checkout's root, not this directory, heads the import path: the
# harness is the package ``portbench`` and the port sits beside it
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=_T0))
