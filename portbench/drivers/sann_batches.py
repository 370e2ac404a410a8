"""Batches of SimClusters-ANN queries through the port's retrieval tier.

The mix file gives ``queries_per_batch`` (Q), ``pool_batches`` (distinct
batches drawn at set-up and cycled), ``in_flight`` (batches dispatched
before the oldest one's results are waited on) and ``slice_batches`` (the
traced slice). Each batch goes through
``simclusters.ann.get_tweet_candidates_batch`` over the index, and its
top-X ids and scores are copied to pinned host memory; a query counts as
answered once its results are on the host.

``correct``: once the window has closed, every pool batch's last answer in
the window against the plain reference (``reference/sann.py``) in float64,
by ``compare.sann``.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

from portbench import compare, harness, yardstick
from portbench.generators import sann_world
from portbench.reference import sann as ref_sann

SPANS = ("sann.batch",)
REFERENCE_BLOCK = 128  # queries the reference scores at a time


class _Done:
    """A finished batch on a CPU run (no stream to wait on)."""

    def synchronize(self):
        pass


class State:
    pass


def setup(ctx) -> State:
    from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex, ScoringAlgorithm
    from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
    from the_algorithm_tpu_torch.simclusters import ann

    dev = ctx.device
    shape = sann_world.shape_of(ctx.config)
    t = ctx.traffic
    Q, P = t["queries_per_batch"], t["pool_batches"]
    lap = harness.Laps()
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    world = sann_world.build(shape, gen, dev)
    pool = [sann_world.draw_queries(shape, world.comm_clusters, Q, gen, dev) for _ in range(P)]
    lap(f"world of {shape.T} tweets and {P} x {Q} queries drawn")
    s = State()
    s.shape, s.Q, s.P, s.in_flight, s.slice_batches = shape, Q, P, t["in_flight"], t["slice_batches"]
    s.world, s.pool, s.device = world, pool, dev
    s.index = ClusterTweetIndex(world.index_ids, world.index_scores, world.index_ts)
    s.sources = [SparseEmbedding(ids, scores) for ids, scores in pool]
    s.cfg = ann.SimClustersANNConfig(max_scan_clusters=shape.N, max_top_tweets_per_cluster=shape.M,
                                     max_num_results=shape.X, scoring_algorithm=ScoringAlgorithm.COSINE)
    pin = dev.type == "cuda"
    s.host_ids = [torch.empty((Q, shape.X), dtype=torch.int32, pin_memory=pin) for _ in range(P)]
    s.host_scores = [torch.empty((Q, shape.X), dtype=torch.float32, pin_memory=pin) for _ in range(P)]
    s.distinct = [int(torch.unique(ids).numel()) for ids, _ in pool]
    s.traced = False
    for i in range(P):  # every batch's shapes once; then the pipeline as the window runs it
        dispatch(s, i).synchronize()
    lap("the kernel library loaded, each batch once")
    _pipeline(s, lambda n: n < 2 * P)
    lap(f"{2 * P} batches warm")
    return s


def dispatch(s: State, i: int):
    """Batch ``i`` of the pool: the retrieval call, its results copied to
    the host; returns what to wait on."""
    from the_algorithm_tpu_torch.simclusters import ann

    span = torch.profiler.record_function("sann.batch") if s.traced else contextlib.nullcontext()
    with span:
        ids, scores = ann.get_tweet_candidates_batch(s.index, s.sources[i], s.cfg)
        cuda = s.device.type == "cuda"
        s.host_ids[i].copy_(ids, non_blocking=cuda)
        s.host_scores[i].copy_(scores, non_blocking=cuda)
        if not cuda:
            return _Done()
        ev = torch.cuda.Event()
        ev.record()
        return ev


def _pipeline(s: State, more) -> int:
    """Batches in pool order, ``in_flight`` dispatched ahead, while
    ``more(batches dispatched)``; returns the batches answered."""
    pending, n, done = collections.deque(), 0, 0
    while more(n):
        pending.append(dispatch(s, n % s.P))
        n += 1
        if len(pending) >= s.in_flight:
            pending.popleft().synchronize()
            done += 1
    while pending:
        pending.popleft().synchronize()
        done += 1
    return done


def window(s: State, seconds: float) -> dict:
    if s.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    done = _pipeline(s, lambda n: time.perf_counter() < deadline)
    elapsed = time.perf_counter() - t0
    return {"attempted": done * s.Q, "failed": 0,
            "metrics": {"sann_queries_per_s": {"value": done * s.Q / elapsed, "unit": "queries/s"}}}


def trace_slice(s: State) -> dict:
    """``slice_batches`` batches as the window runs them, each in a
    ``sann.batch`` span; the facts the readers need: bytes a batch needs by
    kernel and in all, and the hand kernels' launches."""
    from the_algorithm_tpu_torch import _build
    from the_algorithm_tpu_torch.ops import gather, seg_scan

    before = (_build.launches(gather.row_gather), _build.launches(seg_scan.run_collapse_sorted))
    s.traced = True
    try:
        n = _pipeline(s, lambda k: k < s.slice_batches)
    finally:
        s.traced = False
    launched = (_build.launches(gather.row_gather) - before[0],
                _build.launches(seg_scan.run_collapse_sorted) - before[1])
    sh, Q = s.shape, s.Q
    batches = [k % s.P for k in range(n)]
    row_bytes = sh.M * (4 + 4 + 4)  # the index's ids, scores and timestamps
    gather_b = sum(yardstick.gather_bytes(Q * sh.N, s.distinct[i], row_bytes) for i in batches)
    collapse_b = n * yardstick.collapse_bytes(Q, sh.N * sh.M, 2)
    # the least a batch must move: the queries in, each distinct index row
    # once, the top-X ids and scores out
    needed = sum(Q * sh.N * 8 + s.distinct[i] * row_bytes + Q * sh.X * 8 for i in batches)
    return {"batches": n, "row_gather_bytes": gather_b, "row_gather_launches": launched[0],
            "run_collapse_bytes": collapse_b, "run_collapse_launches": launched[1], "needed_bytes": needed}


def release(s: State) -> None:
    """The program's own state; the index and queries are the benchmark's
    inputs, kept for the reference."""
    s.cfg = None


def _blocks(s: State, served):
    """``served(i, a, b)`` — the lists of pool batch i's queries a:b — held
    to the float64 reference block by block."""
    readings = []
    for i, (q_ids, q_scores) in enumerate(s.pool):
        for a in range(0, s.Q, REFERENCE_BLOCK):
            b = min(a + REFERENCE_BLOCK, s.Q)
            cands = ref_sann.candidates(s.world.index_ids, s.world.index_scores, q_ids[a:b], q_scores[a:b])
            _, ref_scores = ref_sann.top(cands, b - a, s.shape.X)
            ids, scores = served(i, a, b)
            readings.append(compare.sann(ids.to(s.device), scores.to(s.device), cands, ref_scores))
    return compare.merge(readings)


def check(s: State) -> dict:
    """Every pool batch's last answer in the window against the float64
    reference."""
    return _blocks(s, lambda i, a, b: (s.host_ids[i][a:b], s.host_scores[i][a:b]))


def control(s: State) -> dict:
    """The control's numbers: the reference computed in bf16 in the
    program's place."""
    def served(i, a, b):
        q_ids, q_scores = s.pool[i]
        c16 = ref_sann.candidates(s.world.index_ids, s.world.index_scores, q_ids[a:b], q_scores[a:b],
                                  dtype=torch.bfloat16)
        ids, scores = ref_sann.top(c16, b - a, s.shape.X)
        return ids, scores.float()

    return _blocks(s, served)
