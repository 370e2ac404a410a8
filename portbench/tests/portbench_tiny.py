"""Shared helpers of the harness's CPU tests: the repository's cells at a
size a test run holds, on the CPU, with the kernels' plain versions."""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import run as portbench_run  # noqa: E402

SANN_CELL = "foryou.sann_q1024"
TINY_SANN = dict(communities=8, clusters_per_community=64, M=40, N=10, X=20, T=8192, KT=8, subsets_per_community=16)
TINY_TRAFFIC = dict(queries_per_batch=32, pool_batches=3, slice_batches=4)


def bench() -> dict:
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def tiny_cell(name: str) -> harness.Cell:
    """The cell as ``BENCHMARK.json`` has it, with its configuration and mix
    cut to a test's size."""
    cell = harness.resolve(bench(), name)
    cell.config = dict(cell.config, **TINY_SANN)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)
    return cell


def run_tiny(name: str, seed: int = 2**31 + 11, seconds: float = 0.3, trace: int = 0) -> dict:
    """A whole run of the cell on the CPU, past the harness's look for a card."""
    args = portbench_run.parse(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                                "--trace", str(trace)])
    return portbench_run.run(args, tiny_cell(name), torch.device("cpu"), time.perf_counter())


def setup_tiny(name: str, seed: int):
    cell = tiny_cell(name)
    return cell, cell.driver.setup(portbench_run.Context(cell.config, cell.traffic, seed, torch.device("cpu")))
