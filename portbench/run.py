#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the CUDA cards of this machine:

    python3 portbench/run.py --workload r101_ig_b4 --seed 7 --seconds 10 \
        --trace 0

from the root of a checkout of the repository.  Prints diagnostics and
each compared number beside its limit on standard error, and the result
as one JSON line, last, on standard output.  The run sees only the
cell's cards (``CUDA_VISIBLE_DEVICES``: the first ``chips`` of it, or
cards 0..chips-1).  Exits 2, printing no result, when the machine lacks
the CUDA cards the cell needs, and 3 when the run loaded JAX or the JAX
package.
"""
import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age_s()

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T0))
