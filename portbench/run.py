"""Run one benchmark cell once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

See ``portbench/README.md`` and :mod:`portbench.harness`.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# import the benchmark as a package and the program from the checkout's
# src/, never this directory's files as top-level modules
sys.path[0:1] = [_ROOT, os.path.join(_ROOT, "src")]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
