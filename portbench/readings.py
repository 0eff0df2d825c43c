"""The two readings each limit of the check is set from, on the chip.

    python3 portbench/readings.py --workload <cell> --seeds <a>:<b> \\
        --seconds <s> [--out FILE]

For each seed, in one process: the cell's set-up and a short window at
its own load, then the numbers the check compares, twice over the same
answers: once judging the program's answers (the lower reading: the
largest over sound runs) and once with the control in the program's
place (the upper reading: the smallest the control gives).  The control
is the reference's oracle with every event time rounded to bfloat16, the
precision below the float32 that the configurations state.  One JSON line
a seed, then one line with the largest program reading and the smallest
control reading of each number.
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    import json

    from portbench import harness
    p = argparse.ArgumentParser(prog="python3 portbench/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="a:b, seeds a..b-1")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    os.environ.update(harness.environment())
    cell = harness.find_cell(args.workload)
    a, b = (int(x) for x in args.seeds.split(":"))
    lines, prog, ctrl = [], {}, {}
    for seed in range(a, b):
        run, state = harness.measure(cell, seed, args.seconds, False,
                                     args.device)
        judge = harness.check(run, state)
        ctrl_judge = harness.check(run, state, control=True)
        got, control = judge.numbers(), ctrl_judge.numbers()
        line = {"seed": seed, "program": got, "control": control,
                "found": judge.values, "control_found": ctrl_judge.values,
                "rows": judge.n_rows, "attempted": run.attempted,
                "e2e": run.e2e}
        lines.append(line)
        print(json.dumps(line), flush=True)
        for k, v in got.items():
            prog[k] = max(prog.get(k, v), v)
            ctrl[k] = min(ctrl.get(k, control[k]), control[k])
    summary = {"workload": cell.name, "seeds": [a, b],
               "lower": prog, "control_least": ctrl}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.path[0:1] = [_ROOT, os.path.join(_ROOT, "src")]
    sys.exit(main())
