"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `portbench/`
and `warp_rnnt_tpu_torch/`.  Sets up the cell (inputs and weights from
the seed, on the card; every kernel built and every shape warmed), runs
its timed calls for ``--seconds``, checks what they produced against the
plain reference and prints one JSON line last on standard output: the
end-to-end metrics, or with ``--trace 1`` the per-layer ones read from
the device trace.  Without a CUDA device, without the cards the cell asks
for, or where the program cannot be loaded, it prints no result and exits
with a code other than 0.
"""

import os
import sys
import time


def _process_start() -> float:
    """The wall time at which this process started (the interpreter's
    start-up included), from /proc where it is readable."""
    now = time.time()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


if __name__ == "__main__":
    T_START = _process_start()
    # the checkout's root in place of this directory, whose modules would
    # otherwise shadow the standard library's (`trace`)
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from portbench import harness

    harness.cache_env()
    sys.exit(harness.main(sys.argv[1:], T_START))
