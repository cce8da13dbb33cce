#!/usr/bin/env python3
"""The benchmark of smart_crossover_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout on a machine with the CUDA card(s) the
cell asks for.  See ``benchmark/README.md``.
"""
import os
import sys
import time

_PERF0 = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (Linux), so that set-up counts
    the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        return max(time.clock_gettime(time.CLOCK_BOOTTIME)
                   - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age_s()

if __name__ == "__main__":
    # the checkout's root, not this folder, goes first on the path: the
    # port and the ``benchmark`` package are imported from there, and no
    # folder of the benchmark shadows an installed module
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from benchmark.harness.cli import main

    sys.exit(main(sys.argv[1:], _PERF0, _AGE0))
