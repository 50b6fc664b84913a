"""Run one benchmark cell once and print its result as the last line.

    python3 gpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  See ``gpbench/README.md``.
"""

import time

T0 = time.monotonic()  # set-up is timed from here, the first line that runs

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gpbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
