#!/usr/bin/env python3
"""The readings each cell's limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13

For every seed, in one process: the cell's set-up (no window), then the
numbers ``correct`` compares for the program (sound runs: the lower
readings) and for the control (the reference one precision below the
configuration's, in the program's place: the upper readings). One JSON line
a seed on standard output, then the largest program reading and the least
control reading of each number.
"""

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.run import Context  # noqa: E402


def readings(cell, seed: int, device) -> dict:
    s = cell.driver.setup(Context(cell.config, cell.traffic, seed, device))
    out = {"seed": seed, "program": cell.driver.check(s), "control": cell.driver.control(s)}
    cell.driver.release(s)
    return out


def summary(rows) -> dict:
    """Per number: the largest program reading and the least control
    reading."""
    return {k: {"program_max": max(r["program"][k] for r in rows),
                "control_min": min(r["control"][k] for r in rows)} for k in rows[0]["program"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.note("no CUDA card")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.resolve(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    rows = []
    for seed in (int(x) for x in args.seeds.split(",")):
        rows.append(readings(cell, seed, torch.device("cuda", 0)))
        print(json.dumps(rows[-1], default=lambda x: None if not math.isfinite(x) else x), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
