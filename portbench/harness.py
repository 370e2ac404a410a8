"""Finding a cell's files by name, and the checks every run makes.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
harness reads ``configs/<file>`` as that entry gives it,
``traffic/<traffic>.json`` (whose ``driver`` names ``drivers/<driver>.py``),
``limits/<cell>.json`` and, for a traced run, ``metrics/<metric>.py`` for
each per-layer metric the cell reports. Adding a cell, a mix or a metric adds
files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from types import ModuleType
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names no run may hold: JAX and the JAX package (compared
# whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "the_algorithm_tpu")


class Refused(Exception):
    """A cell, a file or a run the harness cannot go on with."""


def load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise Refused(f"no file {os.path.relpath(path, ROOT)}") from None


def load_module(path: str, name: str) -> ModuleType:
    """The Python file at ``path`` as a module (metric names hold dots, so
    readers load by path, not by import name)."""
    if not os.path.exists(path):
        raise Refused(f"no file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    driver: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    """A per-layer metric is read in the cells it lists, or without a list in
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def resolve(bench: dict, cell_name: str, root: str = ROOT) -> Cell:
    """The cell's files, each found by its name; refuses what is missing."""
    here = os.path.join(root, "portbench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise Refused(f"no cell {cell_name!r} in BENCHMARK.json")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise Refused(f"cell {cell_name} names an unknown configuration {w['config']!r}")
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    driver = load_module(os.path.join(here, "drivers", f"{traffic['driver']}.py"),
                         f"portbench_driver_{traffic['driver']}")
    limits = load_json(os.path.join(here, "limits", f"{cell_name}.json"))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell_name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, cell_name, names)]
    for m in layer:
        if m["moves"] not in names:
            raise Refused(f"metric {m['name']} moves {m['moves']}, which cell {cell_name} does not report")
    return Cell(cell_name, int(w["chips"]), config, traffic, limits, driver, e2e, layer)


def reader(metric: dict, root: str = ROOT) -> ModuleType:
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    return load_module(os.path.join(root, "portbench", "metrics", f"{metric['name']}.py"),
                       "portbench_metric_" + metric["name"].replace(".", "_").replace("-", "_"))


def validate(bench: dict, root: str = ROOT) -> None:
    """Every cell resolves and every per-layer metric has its reader, whose
    unit agrees with the entry."""
    for w in bench["workloads"]:
        cell = resolve(bench, w["name"], root)
        for m in cell.per_layer:
            r = reader(m, root)
            if r.UNIT != m["unit"] or r.MOVES != m["moves"]:
                raise Refused(f"reader of {m['name']} says {r.UNIT} / {r.MOVES}, BENCHMARK.json "
                              f"{m['unit']} / {m['moves']}")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".")[0] in FORBIDDEN})


def note(message: str) -> None:
    print(f"portbench: {message}", file=sys.stderr, flush=True)


class Laps:
    """Notes how long each phase of a set-up took, on the device's clock as
    the host sees it (each lap waits for the card)."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, what: str) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        note(f"set-up: {what} in {now - self.t:.3f} s")
        self.t = now


def within(check: Dict[str, float]) -> bool:
    """A number within its limit."""
    return check["value"] <= check["limit"]


def checks_line(checks: Dict[str, Dict[str, float]]) -> List[str]:
    """One line a number: its name, its value and its limit."""
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} ({'ok' if within(v) else 'OVER'})"
            for k, v in checks.items()]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; a number the limits file does not name
    is refused."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise Refused(f"no limit for {missing}")
    return {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}


def read_metrics(cell: Cell, trace, facts: dict, root: str = ROOT) -> Dict[str, dict]:
    """Each per-layer metric the cell reports that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value: Optional[float] = reader(m, root).read(trace, facts)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
