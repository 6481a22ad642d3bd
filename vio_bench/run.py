"""One run of one cell of the benchmark:

    python -m vio_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the cell's numbers compared with their
limits as the last lines of standard error, and the result as one JSON
object on the last line of standard output (``harness.main``)."""

import os
import time

T_START = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = _process_age_s()

if __name__ == "__main__":
    import sys

    from vio_bench import harness

    sys.exit(harness.main(sys.argv[1:], T_START - AGE_AT_START))
