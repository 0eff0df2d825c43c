"""Medians and spreads of a cell's runs, from their result lines.

    python3 portbench/spread.py OUT...

reads the last line of each file (a run's standard output) and prints,
for each metric, the runs' values, their median and their spread: the
distance between the first and third quartile (``statistics.quantiles``,
``n=4``) over the median.  Give one set of runs at a time; a bound is
about five times the widest spread over the cells (at least 0.01).
"""

import json
import os
import statistics
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(paths) -> int:
    from portbench.timing import spread
    values = {}
    for path in paths:
        with open(path) as f:
            line = f.read().strip().splitlines()[-1]
        for name, m in json.loads(line)["metrics"].items():
            values.setdefault(name, []).append(m["value"])
    for name, xs in values.items():
        print(json.dumps({"metric": name, "runs": len(xs), "values": xs,
                          "median": statistics.median(xs),
                          "spread": spread(xs) if len(xs) > 1 else None}))
    return 0


if __name__ == "__main__":
    sys.path[0:1] = [_ROOT]
    sys.exit(main(sys.argv[1:]))
