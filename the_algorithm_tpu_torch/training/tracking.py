"""Experiment tracking: run records, metric history, scalar event logs.

A host copy of ``the_algorithm_tpu/training/tracking.py`` (the JAX
package's modules cannot be imported without JAX), ≡
``twml/twml/tracking/experiment_tracker.py`` and ``twml/twml/tensorboard/``:
each run gets a directory with ``run.json`` (hyperparams, git rev, status,
timings), ``metrics.jsonl`` (step-stamped scalar appends, one JSON object a
line, so a crash mid-write loses one line) and a terminal status record;
``compare_runs`` is the tracker's best-run-by-metric query. The files are
the JAX package's, so either package reads the other's runs.
"""

from __future__ import annotations

import dataclasses
import getpass
import json
import os
import subprocess
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence


def _git_rev(cwd: Optional[str] = None) -> Optional[str]:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=cwd, timeout=5,
        ).stdout.strip() or None
    except Exception:
        return None


class ExperimentTracker:
    """One training run's record + scalar stream."""

    def __init__(
        self,
        root: str,
        run_name: str,
        hparams: Optional[Mapping[str, Any]] = None,
        clock=time.time,
    ):
        self.run_dir = os.path.join(root, run_name)
        os.makedirs(self.run_dir, exist_ok=True)
        self._clock = clock
        self._metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self._run_path = os.path.join(self.run_dir, "run.json")
        self._run: Dict[str, Any] = {
            "name": run_name,
            "user": getpass.getuser(),
            "started_at": clock(),
            "status": "running",
            "hparams": dict(hparams or {}),
            "git_rev": _git_rev(),
        }
        self._flush_run()

    def _flush_run(self) -> None:
        tmp = self._run_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._run, f, indent=1, sort_keys=True)
        os.replace(tmp, self._run_path)

    # -- scalar stream (tensorboard-scalars analog) ---------------------------

    def log_metrics(self, step: int, metrics: Mapping[str, float]) -> None:
        rec = {"step": int(step), "t": self._clock()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")

    def metrics(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self._metrics_path):
            return []
        out = []
        with open(self._metrics_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass  # torn tail write from a crash — drop it
        return out

    # -- terminal status -------------------------------------------------------

    def finish(self, status: str = "done",
               final_metrics: Optional[Mapping[str, float]] = None) -> None:
        self._run["status"] = status
        self._run["finished_at"] = self._clock()
        if final_metrics:
            self._run["final_metrics"] = {
                k: float(v) for k, v in final_metrics.items()
            }
        self._flush_run()

    def record_export(self, path: str, version: int) -> None:
        """Bind the run to its exported serving artifact (train→serve
        lineage, ≡ the tracker's model-repo path record)."""
        self._run.setdefault("exports", []).append(
            {"path": path, "version": int(version), "t": self._clock()}
        )
        self._flush_run()


def load_run(root: str, run_name: str) -> Dict[str, Any]:
    with open(os.path.join(root, run_name, "run.json")) as f:
        return json.load(f)


def list_runs(root: str) -> List[str]:
    if not os.path.isdir(root):
        return []
    return sorted(
        d for d in os.listdir(root)
        if os.path.exists(os.path.join(root, d, "run.json"))
    )


def compare_runs(
    root: str, metric: str, mode: str = "max"
) -> List[tuple]:
    """[(run_name, best_value)] sorted best-first — the tracker's
    best-checkpoint-by-metric query (`twml trainer best_or_latest`)."""
    assert mode in ("max", "min")
    rows = []
    for name in list_runs(root):
        t = ExperimentTracker.__new__(ExperimentTracker)
        t._metrics_path = os.path.join(root, name, "metrics.jsonl")
        vals = [m[metric] for m in ExperimentTracker.metrics(t)
                if metric in m]
        run = load_run(root, name)
        fm = run.get("final_metrics", {})
        if metric in fm:
            vals.append(fm[metric])
        if vals:
            best = max(vals) if mode == "max" else min(vals)
            rows.append((name, best))
    rows.sort(key=lambda kv: -kv[1] if mode == "max" else kv[1])
    return rows
