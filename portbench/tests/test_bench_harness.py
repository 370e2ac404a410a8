"""How the harness finds a cell's files, what it refuses, and what the
command's modules may import."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch
from portbench_tiny import ROOT, SANN_CELL, bench, tiny_cell

from portbench import harness
from portbench.run import Context


def test_every_cell_resolves_and_every_metric_has_its_reader():
    b = bench()
    harness.validate(b)
    names = {m["name"] for m in b["per_layer"]}
    for w in b["workloads"]:
        cell = harness.resolve(b, w["name"])
        assert cell.per_layer and {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert all(m["name"] in names for m in cell.per_layer)
        for m in cell.per_layer:  # a metric moves what its cell reports
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
            assert harness.reader(m).LAYER == m["layer"]


class _Reads(dict):
    """A dict that notes the keys read from it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def test_every_number_of_a_cells_files_is_read():
    """A configuration or mix holds no number that changes nothing when set:
    the driver's set-up reads each one."""
    cell = tiny_cell(SANN_CELL)
    config, traffic = _Reads(cell.config), _Reads(cell.traffic)
    cell.driver.setup(Context(config, traffic, 2**31 + 5, torch.device("cpu")))
    for held in (config, traffic):
        numbers = {k for k, v in held.items() if isinstance(v, (int, float)) and not isinstance(v, bool)}
        assert numbers and numbers <= held.read, sorted(numbers - held.read)


@pytest.fixture
def copy_root(tmp_path):
    """BENCHMARK.json and portbench/ in a directory of their own."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def _edit(root, change):
    b = json.loads((root / "BENCHMARK.json").read_text())
    change(b)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return b


def test_a_cell_of_an_unknown_configuration_is_refused(copy_root):
    b = _edit(copy_root, lambda b: b["workloads"][0].update(config="no_such_config"))
    with pytest.raises(harness.Refused, match="unknown configuration"):
        harness.resolve(b, b["workloads"][0]["name"], str(copy_root))


def test_a_metric_without_its_reader_is_refused(copy_root):
    b = _edit(copy_root, lambda b: b["per_layer"].append(dict(b["per_layer"][0], name="no_such.metric")))
    with pytest.raises(harness.Refused, match="no_such.metric"):
        harness.validate(b, str(copy_root))


def test_a_metric_moving_what_its_cell_does_not_report_is_refused(copy_root):
    def change(b):
        m = next(m for m in b["per_layer"] if SANN_CELL in m["workloads"])
        m["moves"] = "foryou_requests_per_s"
    b = _edit(copy_root, change)
    with pytest.raises(harness.Refused, match="does not report"):
        harness.resolve(b, SANN_CELL, str(copy_root))


def test_a_cell_and_a_metric_added_as_files_are_found(copy_root):
    """A new mix, cell and metric: new files and entries, no file edited."""
    pb = copy_root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    (pb / "traffic" / "sann_q256.json").write_text(json.dumps(
        dict(json.loads((pb / "traffic" / "sann_q1024.json").read_text()), queries_per_batch=256)))
    (pb / "limits" / "foryou.sann_q256.json").write_text((pb / "limits" / f"{SANN_CELL}.json").read_text())
    (pb / "metrics" / "launches.sann.py").write_text(textwrap.dedent('''
        UNIT = "launches"
        LAYER = "kernels"
        MOVES = "sann_queries_per_s"

        def read(trace, facts):
            return facts.get("row_gather_launches")
    '''))

    def change(b):
        b["workloads"].append({"name": "foryou.sann_q256", "config": "simclusters_ann", "traffic": "sann_q256",
                               "chips": 1, "why": "bench.py's batch"})
        next(m for m in b["end_to_end"] if m["name"] == "sann_queries_per_s")["workloads"].append("foryou.sann_q256")
        b["per_layer"].append({"name": "launches.sann", "unit": "launches", "better": "lower",
                               "source": "program_counter", "layer": "kernels", "moves": "sann_queries_per_s",
                               "workloads": ["foryou.sann_q256"]})
    b = _edit(copy_root, change)
    harness.validate(b, str(copy_root))
    cell = harness.resolve(b, "foryou.sann_q256", str(copy_root))
    assert cell.traffic["queries_per_batch"] == 256
    assert [m["name"] for m in cell.per_layer] == ["launches.sann"]
    assert harness.read_metrics(cell, None, {"row_gather_launches": 3}, str(copy_root)) == {
        "launches.sann": {"value": 3.0, "unit": "launches"}}
    assert all(p.read_bytes() == data for p, data in before.items())


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = {"jax": 1, "jax.numpy": 1, "jaxtyping": 1, "flax.linen": 1, "the_algorithm_tpu": 1,
              "the_algorithm_tpu.ops.gather": 1, "the_algorithm_tpu_torch": 1, "the_algorithm_tpu_torch.ops": 1,
              "jaxlib": 1, "portbench": 1}
    assert harness.forbidden_modules(loaded) == ["flax.linen", "jax", "jax.numpy", "jaxlib", "the_algorithm_tpu",
                                                 "the_algorithm_tpu.ops.gather"]


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "portbench", "tests")))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every cell's whole run (traced), in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or the_algorithm_tpu."""
    loaded = _modules_after(textwrap.dedent(f'''
        import portbench_tiny as t
        assert t.run_tiny({SANN_CELL!r}, trace=1)["correct"] is not None
    '''))
    assert "the_algorithm_tpu_torch" in loaded
    assert harness.forbidden_modules(dict.fromkeys(loaded)) == []


def test_the_yardstick_imports_nothing_of_the_port():
    """The references, the comparison, the generators and the arithmetic
    load no module of the port (top-level name the_algorithm_tpu_torch)."""
    loaded = _modules_after("import portbench.compare, portbench.yardstick, portbench.trace\n"
                            "import portbench.reference.sann, portbench.generators.sann_world")
    assert not [m for m in loaded if m.split(".")[0] in ("the_algorithm_tpu_torch", "the_algorithm_tpu", "jax")]
