#!/usr/bin/env python3
"""Medians and spreads of a cell's runs, set by set.

    python3 portbench/spread.py A_11.out A_12.out ... B_11.out ...

Each file holds one run's standard output; its last line is the result. A
file's name up to the first ``_`` names its set. For each set and metric:
the runs, the median, the quartiles by ``statistics.quantiles(n=4)`` and
their distance as a share of the median (the spread a bound is set from),
the spread without the run farthest from the median, and how many runs were
correct.
"""

import collections
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.yardstick import quartile_spread  # noqa: E402


def main(paths) -> int:
    sets = collections.defaultdict(list)
    for p in paths:
        with open(p) as f:
            lines = [x for x in f.read().splitlines() if x.strip()]
        sets[os.path.basename(p).split("_")[0]].append(json.loads(lines[-1]))
    for name, runs in sorted(sets.items()):
        print(f"set {name}: {len(runs)} runs, {sum(r['correct'] is True for r in runs)} correct")
        for metric in runs[0]["metrics"]:
            vals = [r["metrics"][metric]["value"] for r in runs]
            med = statistics.median(vals)
            q1, _, q3 = statistics.quantiles(vals, n=4)
            rest = sorted(vals, key=lambda v: abs(v - med))[:-1]
            print(f"  {metric}: median {med!r}, quartiles {q1!r} {q3!r}, spread {quartile_spread(vals):.5f}, "
                  f"without the farthest {quartile_spread(rest):.5f}; runs {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
