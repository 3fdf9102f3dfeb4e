"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout on a machine with the cell's CUDA cards.
The last line of standard output is the result (JSON); everything else goes
to standard error.  ``harness`` has the rest.
"""

import os
import sys
import time


def _since_process_start() -> float:
    """Seconds from this process's start to now, by /proc (0 where there is none)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _since_process_start()  # set-up counts from the process's start

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
