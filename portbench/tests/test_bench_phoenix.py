"""The Phoenix cell at a test's size on the CPU (the kernels' plain
versions): it resolves and validates, every number of its files is read, a
sound run is correct, and an altered answer and the fp8 control are not.
The limits are the cell's own (``limits/``)."""

import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch
from portbench_tiny import ROOT, bench

from portbench import harness
from portbench import run as portbench_run
from portbench.run import Context

CELL = "foryou.phoenix_moonlight_b16"
TINY_CONFIG = dict(hidden_size=128, num_attention_heads=4, num_key_value_heads=4, num_hidden_layers=3,
                   intermediate_size=256, moe_intermediate_size=64, n_routed_experts=8, n_shared_experts=1,
                   num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                   author_buckets=512, max_history=32, max_candidates=24)
TINY_TRAFFIC = dict(requests_per_batch=3, min_valid_history=4, candidates_per_request=24, pool_batches=2,
                    slice_batches=3, warm_seconds=0.1)
SEED = 2**31 + 23


def tiny_cell() -> harness.Cell:
    cell = harness.resolve(bench(), CELL)
    cell.config = dict(cell.config, **TINY_CONFIG)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)
    return cell


def run_tiny(trace: int = 0) -> dict:
    args = portbench_run.parse(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.2", "--trace", str(trace)])
    return portbench_run.run(args, tiny_cell(), torch.device("cpu"), time.perf_counter())


def test_the_cell_resolves_and_validates():
    b = bench()
    harness.validate(b)
    cell = harness.resolve(b, CELL)
    assert cell.chips == 1 and cell.driver.__name__.endswith("phoenix_batches")
    assert {m["name"] for m in cell.end_to_end} == {"sann_queries_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"mfu.phx_moon", "expert_gemm_roofline.phx_moon",
                                                   "phoenix.device_ms.phx_moon", "device.idle.phx_moon"}
    assert set(cell.limits) == {"logit_err", "answer_err", "route_far"} and cell.limits["route_far"] == 0


class _Reads(dict):
    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def test_every_number_of_the_cells_files_is_read():
    cell = tiny_cell()
    config, traffic = _Reads(cell.config), _Reads(cell.traffic)
    cell.driver.setup(Context(config, traffic, SEED, torch.device("cpu")))
    for held in (config, traffic):
        numbers = {k for k, v in held.items() if isinstance(v, (int, float)) and not isinstance(v, bool)}
        assert numbers and numbers <= held.read, sorted(numbers - held.read)


def test_a_sound_run_is_correct_and_traced():
    result = run_tiny(trace=1)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    # the CPU has no device operations to read: only the model FLOPs over the slice's length
    assert set(result["metrics"]) == {"mfu.phx_moon"}
    assert result["checks"]["route_far"]["value"] == 0


def test_an_altered_answer_and_the_fp8_control_are_not_correct(monkeypatch):
    from the_algorithm_tpu_torch.models import phoenix

    cell = tiny_cell()
    s = cell.driver.setup(Context(cell.config, cell.traffic, SEED, torch.device("cpu")))
    limits = cell.limits
    assert all(harness.within(v) for v in harness.judge(cell.driver.check(s), limits).values())
    over = harness.judge(cell.driver.control(s), limits)
    assert [k for k, v in over.items() if not harness.within(v)], over
    s.host[1][0, 3, 5] += 0.25  # another probability where the answer is served
    assert not harness.within(harness.judge(cell.driver.check(s), limits)["answer_err"])

    orig = phoenix.PhoenixModel._readout
    monkeypatch.setattr(phoenix.PhoenixModel, "_readout",
                        lambda self, x, *a: orig(self, x.flip(1), *a))  # the history read backwards
    assert not all(harness.within(v) for v in harness.judge(cell.driver.check(s), limits).values())


def test_the_parent_of_the_block_fails_the_cell_at_once():
    """Without the decoder kind (a port whose PhoenixConfig takes no
    ``decoder``), set-up raises before it allocates anything."""
    code = textwrap.dedent(f'''
        import sys, types
        sys.modules["the_algorithm_tpu_torch.models.moe_transformer"] = None
        import torch
        sys.path.insert(0, {os.path.join(ROOT, "portbench", "tests")!r})
        from test_bench_phoenix import tiny_cell
        from portbench.run import Context
        cell = tiny_cell()
        try:
            cell.driver.setup(Context(cell.config, cell.traffic, 1, torch.device("cpu")))
        except ImportError:
            print("failed cleanly")
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert "failed cleanly" in out.stdout, out.stderr[-3000:]


def test_the_yardstick_imports_nothing_of_the_port():
    code = ("import portbench.compare_phoenix, portbench.phoenix_flops, portbench.generators.phoenix_world\n"
            "import portbench.reference.phoenix_moonlight\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.split(".")[0] in ("the_algorithm_tpu_torch", "the_algorithm_tpu", "jax")]


@pytest.mark.parametrize("valid_history, want", [([1], 1), ([2], 3), ([4, 1], 11)])
def test_model_flops_count_causal_pairs(valid_history, want):
    from portbench import phoenix_flops

    cfg = dict(bench_config(), num_bool_features=0, num_actions=0)
    per_token, per_pair = phoenix_flops.token_flops(cfg)
    D = cfg["hidden_size"]
    got = phoenix_flops.model_flops(cfg, valid_history, [0] * len(valid_history))
    n = sum(valid_history)
    assert got == pytest.approx(n * per_token + cfg["num_hidden_layers"] * per_pair * want + 4 * D * D * n)


def bench_config() -> dict:
    return harness.resolve(bench(), CELL).config


def test_expert_gemm_work_counts_experts_with_slots():
    from portbench import phoenix_flops

    cfg = bench_config()
    D, I = cfg["hidden_size"], cfg["moe_intermediate_size"]
    flops, nbytes = phoenix_flops.expert_gemm(cfg, [[3, 0, 1], [0, 0, 4]])
    assert flops == 8 * 6 * D * I
    assert nbytes == 3 * (3 * D * I * 2) + 8 * 2 * (D + I) * 2
