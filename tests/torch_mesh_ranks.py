"""Run a program of the port on several gloo ranks, one process each.

The mesh tests (tests/test_torch_{mesh,sharded_table,ann_sharded,
sharded_serve,sharded_search}.py) hold the port's mesh layer against the
JAX package's shard_map paths. The JAX side runs in the test process on a
sub-mesh of its 8 virtual CPU devices; the port's side runs here, on 2-4
processes joined by ``torch.distributed`` with the gloo backend — the port's
counterpart of those devices. This module imports no JAX, and neither do
the programs it runs (tests/torch_mesh_programs.py), so a rank starts in
about a second.

    run_ranks("program", world, tmp_path, inputs) -> [rank 0's output, ...]

Each rank loads ``inputs`` (a pickle of numpy arrays and plain values),
calls ``torch_mesh_programs.<program>(inputs)`` after joining the group
through a ``file://`` store in ``tmp_path`` (no port, so parallel test
workers never collide), and pickles the dict it returns. A rank that fails
fails the test with its output; ranks still running after ``timeout``
seconds are killed and fail it too, so a hung collective never hangs the
suite.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta

TIMEOUT_S = 120
_HERE = os.path.dirname(os.path.abspath(__file__))


class RanksFailed(RuntimeError):
    pass


def run_ranks(program: str, world: int, tmp_path, inputs: dict, timeout: float = TIMEOUT_S) -> list:
    """``program`` on ``world`` gloo ranks → each rank's output, by rank."""
    work = os.path.join(str(tmp_path), program)
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(_HERE), _HERE,
                                                       os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(work, f"rank{rank}.log"), "w+")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), program, str(rank), str(world),
                                       work], stdout=log, stderr=subprocess.STDOUT, env=env))
        logs.append(log)
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if hung or failed:
        tails = []
        for r, log in enumerate(logs):
            log.seek(0)
            tails.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n" + log.read()[-3000:])
        for log in logs:
            log.close()
        what = f"ranks {hung} still running after {timeout:.0f} s" if hung else f"ranks {failed} failed"
        raise RanksFailed(f"{program} on {world} ranks: {what}\n" + "\n".join(tails))
    for log in logs:
        log.close()
    outs = []
    for rank in range(world):
        with open(os.path.join(work, f"out{rank}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _rank_main(program: str, rank: int, world: int, work: str) -> None:
    import torch
    import torch.distributed as dist

    import torch_mesh_programs

    torch.set_num_threads(1)
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'store')}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        out = getattr(torch_mesh_programs, program)(inputs)
        dist.barrier()  # no rank tears the group down while a peer's last collective is in flight
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
