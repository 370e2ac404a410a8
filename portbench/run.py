#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernel library, the inputs drawn on the card from
``--seed``, warm-up of the cell's own shapes) is timed as
``setup_s``; then the cell's driver runs its traffic for ``--seconds`` on
the host clock. With ``--trace 1`` a short fixed slice runs under
``torch.profiler`` afterwards and the cell's per-layer metrics are read from
it. Last, the program's output is held against the plain reference. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced), then
``checks``, each compared number beside its limit, which also close
standard error.

Exits non-zero, with no result line, without a CUDA card (or with fewer
than the cell asks for), when a cell's files or the port are missing, and
when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the program's caches inside the checkout, at fixed paths, so the first run
# in a checkout builds and every later one finds what it built
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")

from portbench import harness  # noqa: E402


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    device: object


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, cell, device, t_start):
    """Set-up, window, trace, check. Returns the result object."""
    import torch

    ctx = Context(cell.config, cell.traffic, args.seed, device)
    state = cell.driver.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    harness.note(f"set-up {setup_s:.3f} s")
    window = cell.driver.window(state, args.seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result = {"correct": None, "attempted": window["attempted"], "failed": window["failed"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if args.trace:
        from portbench import trace

        facts = {}
        t = trace.profile(lambda: facts.update(cell.driver.trace_slice(state)), cell.driver.SPANS)
        result["metrics"] = harness.read_metrics(cell, t, facts)
        for key in (k for k in facts if k.endswith("_launches")):  # the profiler drops a few events a session
            kernel = key[: -len("_launches")]
            harness.note(f"traced slice: the profiler saw {len(t.ops_named(kernel))} {kernel} kernels of "
                         f"{facts[key]} launched")
        dev["busy_s"] = t.busy_s()
        dev["window_s"] = t.window_s
        result["breakdown"] = t.breakdown()
        harness.note(f"traced slice: {t.window_s:.6f} s, device busy {t.busy_s():.6f} s, "
                     f"{len(t.ops)} device operations")
    else:
        names = {m["name"] for m in cell.end_to_end}
        metrics = {k: v for k, v in window["metrics"].items() if k in names}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        missing = names - set(metrics)
        if missing:
            raise harness.Refused(f"the driver measured no {sorted(missing)}")
        result["metrics"] = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}
    result["device"] = dev
    cell.driver.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = harness.judge(cell.driver.check(state), cell.limits)
    result["correct"] = window["failed"] == 0 and all(map(harness.within, checks.values()))
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    try:
        bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cell = harness.resolve(bench, args.workload)
    except harness.Refused as e:
        harness.note(str(e))
        return 2
    try:
        import the_algorithm_tpu_torch  # noqa: F401  the system under test
    except ImportError as e:
        harness.note(f"the port is not here: {e}")
        return 5
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.note(f"cell {cell.name} needs {cell.chips} CUDA card(s); this machine has {n}")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    harness.note(f"set-up: python, torch and the card in {time.perf_counter() - T_START:.3f} s")
    harness.note(f"cell {cell.name}, seed {args.seed}, {args.seconds} s, trace {args.trace}; "
                 f"{torch.cuda.get_device_name(device)}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run(args, cell, device, T_START)
    found = harness.forbidden_modules()
    if found:
        harness.note(f"JAX or the JAX package was loaded: {found}")
        return 4
    for line in harness.checks_line(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
