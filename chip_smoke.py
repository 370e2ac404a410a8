#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths once on one NVIDIA GPU.

    python3 chip_smoke.py

The run_collapse sweep alone, for a copy of this script placed in an older
tree (it times whichever ``the_algorithm_tpu_torch`` sits beside it):

    python3 -c "import chip_smoke as c; d = c.phase_device(); c.phase_build(); c.phase_collapse_sweep(d)"

Phases, each printing its result on its own line:

1. device: requires CUDA, prints ``nvidia-smi``'s name and power limit, pins
   f32 products to full f32 (no TF32);
2. build: compiles ``the_algorithm_tpu_torch/csrc/*.cu`` with nvcc (set-up);
3. retrieval: SimClusters-ANN at the production shape (C=145,408 clusters,
   M=400, N=50, X=200, Q=256) on ``bench.py``'s seeded data rebuilt with
   numpy; the kernels' launch counts during that batch; queries/s on the
   host clock, taken before any profiler session (a process that has run
   some dozens of them dispatches more slowly); oracle parity on 8 queries;
   recall@100 against the exact full-corpus scan;
4. candidates: the For You candidate sources at ``bench.py``'s shape
   (``data/foryou_world.py``): the earlybird in-network scan (R=32 users of
   a 262,144-doc index, 700 results), UTEG (R=32 users x 8 seeds, 400
   results) and UTG (256 source tweets, 200 results), one counted batch
   each with the kernels' launches; the graphs built on the card against
   the per-event append loop; earlybird against the port on the CPU (the
   same ranking up to near-ties), UTEG on every user and UTG on 16 sources against numpy dict
   oracles; batches/s on the host clock, then a profile of each batch; the
   kernels against their plain versions at these paths' shapes (their
   sorted entries and their row fetches) and on seeded rows of those shapes;
5. foryou: bench.py's For You request end to end at its sizes (a 16,384-user
   hydration world, 1,536 candidate slots, the 6,823-column schema, MaskNet
   in bf16, top-50): the SANN rows of step 3 and the sources of step 4
   merged by ``BatchedForYouEngine``, hydrated through the row-gather
   multiget and scored on the card; the launches of one counted R=32 batch;
   requests/s at each batch size, R=1 latency and a 2-worker
   ``RequestBatcher`` on the host clock; the card against the port on the
   CPU (features per schema column, scores), the scores again on the same
   requests with small creation times, where they spread (card against
   CPU, bf16 against f32), device selection against the host rescore, bf16
   against f32; each step's device time, each multiget launch against
   ``index_select``, and a profile of the batch. The
   candidate paths' kernel timings of step 4 run after this phase;
6. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the SANN batch gives it, with both times (CUDA
   events around the call, and device time alone from ``torch.profiler``)
   and the share of each kernel's bytes bound; run_collapse's device time
   at its tile shape and each neighbour (the measurement behind
   ``seg_scan.SHAPE``); the TMA ring's device time at its chosen shape and
   each neighbour shape, at the SANN rows and the 256-byte hydration rows
   (the measurement behind ``gather.RING``); then a row_gather sweep at the
   hydration tables' widths and 4-byte words, bit-exact against
   ``index_select``, with both times and TB/s; then a run_collapse sweep
   over Q, W and k on seeded sorted rows, against its plain version, with
   both times, TB/s, the share of its bound, and the device time of
   ``copy_`` moving the same bytes;
7. ranking: a MaskNet at the flagship width (F=6000, 15 heads, G=4, D=512,
   A=128, trunk (256, 128)) from a seeded generator, saved as a registry
   version and served over HTTP in bf16; every answer is held against a
   direct f32 forward of the same weights;
8. exact_tier: bench.py's exact-tier serving (bench.py:616-694) over the
   step-3 corpus padded to 2,031,616 rows and the step-5 engine: the f32
   full-corpus scan against a float64 numpy brute force on 4 queries, the
   turbo (bf16) scan's recall@100 against the f32 scan on all 256 queries;
   the tiered SANN leg (turbo scan for a sticky 80% of users, the SANN rows
   for the rest) warmed at R=64 and every scan Q, the launches of one
   counted R=64 batch, 256 requests from 128 clients through a 2-worker
   ``RequestBatcher`` (requests/s on the host clock), routing against the
   host ``Decider`` and under the ``EXACT_RETRIEVAL_TIER`` param, the
   ``exact_tier`` column;
9. live: bench.py's live updates (bench.py:696-798) into the step-5
   engine's tables: the updater's unthrottled ceiling, 4 R=32 batches served
   while a feeder applies 256-event batches at 6,000 events/s, the probe's
   top candidate's score moving in the next request (counted), one seeded
   batch folded on the card against the CPU; then an updater carrying a
   [131,072, 400] tweet-embedding state (user interests: the step-3 query
   embeddings) over the same batches, its refreshed [145,408, 1,600] index
   holding the target tweet in its clusters' rows and serving a faver's
   SANN query (counted); ``build_cluster_index`` at T=16,384 against the
   CPU;
10. the device time of an f32 and a bf16 scan at Q=64 by op, of a fold
    and of a refresh, and the kernels at the refreshed-index query's
    shapes. Steps 8-10 run last: on the card, the profiler sessions that
    follow their thousands of launches and copies miss many of the copy
    events a short session makes.

Then one JSON line with each kernel's launches (in all, and by path: SANN,
UTEG, UTG, For You, the exact tier, live updates), error and times, and, as the last line,
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero and prints no result; it needs no network.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd import DeviceType

from the_algorithm_tpu_torch import _build
from the_algorithm_tpu_torch.core.config import Params, param_scope
from the_algorithm_tpu_torch.core.decider import Decider
from the_algorithm_tpu_torch.data import foryou_world, sann_world
from the_algorithm_tpu_torch.graph import graphjet, uteg
from the_algorithm_tpu_torch.mixers import batched_foryou as bf
from the_algorithm_tpu_torch.mixers import device_hydration as dh
from the_algorithm_tpu_torch.mixers import feature_schema as fs
from the_algorithm_tpu_torch.mixers import live_updates as lu
from the_algorithm_tpu_torch.mixers import wide_hydrators as wh
from the_algorithm_tpu_torch.mixers.home_mixer import ForYouQuery
from the_algorithm_tpu_torch.mixers.home_products import EXACT_RETRIEVAL_TIER
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.ops import gather, retrieval, seg_scan, sparse
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex, ScoringAlgorithm
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.search import earlybird
from the_algorithm_tpu_torch.serving.batcher import BatcherConfig, RequestBatcher
from the_algorithm_tpu_torch.serving.model_registry import ModelRegistry, save_params_npz
from the_algorithm_tpu_torch.serving.server import InferenceServer
from the_algorithm_tpu_torch.simclusters import ann
from the_algorithm_tpu_torch.simclusters import tweet_embeddings as te
from the_algorithm_tpu_torch.training import metrics

REPO = os.path.dirname(os.path.abspath(__file__))
K_RECALL = 100
JAX_RECALL_AT_100 = 0.5705  # the JAX package on the same seeded data (BENCH_r05.json)
EXACT_BLOCK = 65536  # bench.py's exact-scan block
# SANN sums: f32 run totals of a few terms, summed in another order than the plain version's
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
# served bf16 scores against the f32 forward: bf16 keeps 8 mantissa bits, and the
# rounding of each product moves the logits by ~1e-2 at this width; a score of a
# negative combined sum lands in (0, 1e-6], hence the absolute floor
SCORE_RTOL, SCORE_ATOL = 2e-2, 1e-8
LOGIT_ATOL = 5e-2
PROFILER_ATTEMPTS = 5  # sessions a device time may take (device_ms)
# device-time sessions opened, those opened again after one that saw too
# little, the times taken from a session that left out kernel events, and
# the kernels it left out, by name
PROFILER = {"sessions": 0, "again": 0, "short": 0, "left_out": Counter()}
MIN_SEEN = 0.95  # the share of a session's kernel launches the profiler must report
# H100 SXM device memory rate (NVIDIA's data sheet): a kernel's bytes bound
HBM_BYTES_PER_S = 3.35e12
# the candidate sources as bench.py's For You phase runs them (bench.py:497-500)
CAND_R = 32  # users in a batch (bench.py's largest)
EB_RESULTS, UTEG_RESULTS, UTG_RESULTS = 700, 400, 200
UTG_CHECKED = 16  # UTG sources held against the numpy oracle
# earlybird on the card against the port on the CPU: float32 scores whose sums
# (the 184-feature dot product above all) run in another order on each device;
# docs whose scores lie within twice this of each other may trade places
EB_RTOL, EB_ATOL = 1e-5, 1e-5
# UTEG/UTG scores: sums of whole numbers (exact), and one f32 division and square root
GRAPH_RTOL = 1e-6


def bound_ms(moved_bytes: int) -> float:
    """The least time the card could take to move ``moved_bytes``."""
    return moved_bytes / HBM_BYTES_PER_S * 1e3


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``reps`` calls, warm."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def session_kernels(calls):
    """The CUDA kernel events (``key_averages``) of one ``torch.profiler``
    session that makes ``calls`` in order."""
    PROFILER["sessions"] += 1
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def per_call_ms(kernels, calls: int):
    """Device time of one of ``calls`` calls in ms from the kernel events of
    their profiler session: each kernel's mean time times the launches a
    call makes (its count over ``calls``, rounded). On the card a session
    often leaves out a kernel event or two, which a mean passes over. None
    when the session saw no device time, or fewer than MIN_SEEN of the
    launches those rounded counts imply."""
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.key, (0, 0.0))
        by_name[e.key] = (n + e.count, us + e.self_device_time_total)
    per_call = {k: round(n / calls) for k, (n, _) in by_name.items()}
    want, seen = calls * sum(per_call.values()), sum(n for n, _ in by_name.values())
    ms = sum(us / n * per_call[k] for k, (n, us) in by_name.items() if n) / 1000
    if want == 0 or seen < MIN_SEEN * want or ms <= 0:
        return None
    PROFILER["short"] += seen < want
    PROFILER["left_out"].update({k: calls * per_call[k] - n for k, (n, _) in by_name.items()
                                 if n < calls * per_call[k]})
    return ms


def device_ms(fn, reps: int, kernels_only: bool = False) -> float:
    """Device time of one call of ``fn`` in ms, from ``torch.profiler``'s
    kernel events of ``reps`` warm calls (:func:`per_call_ms`). Unlike
    :func:`cuda_ms` it leaves out the host's work between launches.
    ``kernels_only`` leaves the copies and fills out too."""
    for _ in range(3):
        fn()
    for attempt in range(PROFILER_ATTEMPTS):  # a session that saw too little is measured again, a second later
        time.sleep(attempt and 1.0)
        PROFILER["again"] += attempt > 0
        kernels = [e for e in session_kernels([fn] * reps)
                   if not (kernels_only and e.key.startswith(("Memcpy", "Memset")))]
        ms = per_call_ms(kernels, reps)
        if ms is not None:
            return ms
    seen = Counter()
    for e in kernels:
        seen[e.key[:60]] += e.count
    raise RuntimeError(f"chip_smoke: torch.profiler saw too few kernels in {PROFILER_ATTEMPTS} sessions of {reps} "
                       f"calls (after {PROFILER['sessions']} sessions); the last saw {dict(seen)}")


def timed_pair(kernel, plain, reps=50, clock=cuda_ms):
    """Plain, kernel, kernel, plain, so drift on the card splits evenly."""
    p1, k1, k2, p2 = clock(plain, reps), clock(kernel, reps), clock(kernel, reps), clock(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_pair(kernel, plain, name: str, reps: int = 50):
    """Device times of one call of ``kernel`` and of ``plain`` in ms, as
    :func:`device_ms` takes them, from ONE profiler session that runs plain,
    kernel, kernel, plain (``reps`` calls each): the kernels whose name holds
    ``name`` are the hand kernel's, the rest the plain version's. One
    session where :func:`timed_pair` would open four."""
    for fn in (plain, kernel):
        for _ in range(3):
            fn()
    for attempt in range(PROFILER_ATTEMPTS):
        time.sleep(attempt and 1.0)
        PROFILER["again"] += attempt > 0
        kernels = session_kernels([plain] * reps + [kernel] * (2 * reps) + [plain] * reps)
        mine = per_call_ms([e for e in kernels if name in e.key], 2 * reps)
        rest = per_call_ms([e for e in kernels if name not in e.key], 2 * reps)
        if mine is not None and rest is not None:
            return mine, rest
    raise RuntimeError(f"chip_smoke: torch.profiler saw too few of {name}'s or the plain version's kernels in "
                       f"{PROFILER_ATTEMPTS} sessions")


def time_gather(ids, tables, label):
    """row_gather against index_select on the card: bit-exact, both clocks, TB/s."""
    got = gather.row_gather(ids, *tables)
    want = gather.row_gather_plain(ids, *tables)
    torch.cuda.synchronize()
    require(all(torch.equal(g.view(torch.uint8), w.view(torch.uint8)) for g, w in zip(got, want)),
            f"row_gather differs from index_select at {label}")
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    kernel = lambda: gather.row_gather(ids, *tables)  # noqa: E731
    plain = lambda: gather.row_gather_plain(ids, *tables)  # noqa: E731
    ms, plain_ms = timed_pair(kernel, plain)
    dev_ms, plain_dev_ms = device_pair(kernel, plain, "row_gather")
    # the bytes the gather needs from HBM: the ids, each distinct row once (a
    # row fetched again may come from L2) and every output row written
    row_bytes = sum(t.shape[1] * t.element_size() for t in tables)
    distinct = int(torch.unique(ids).numel())
    needed = ids.numel() * ids.element_size() + (distinct + ids.numel()) * row_bytes
    bound = bound_ms(needed)
    print(f"kernel row_gather: {label}, {distinct} distinct rows, {needed / 1e6:.1f} MB needed, bit-exact; device "
          f"{dev_ms:.4f} ms ({needed / dev_ms / 1e9:.2f} TB/s, {100 * bound / dev_ms:.1f}% of its {bound:.4f} ms "
          f"bound) vs index_select {plain_dev_ms:.4f} ms ({needed / plain_dev_ms / 1e9:.2f} TB/s); events "
          f"{ms:.4f} ms vs {plain_ms:.4f} ms")
    # the plain version is one index_select per table: the library's own call
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms, plain_device_ms=plain_dev_ms,
                bound_ms=bound, bound_by="bytes", library_ms=plain_dev_ms)


def phase_device():
    require(torch.cuda.is_available(), "no CUDA device: this script runs on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, tf32 off")
    return torch.device("cuda", 0)


def phase_build():
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"build: {os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a; set-up)")


def build_world(dev):
    t0 = time.perf_counter()
    shape = sann_world.PROD
    tweet_ids, tweet_scores, _, comm = sann_world.build_corpus(shape)
    index_np = sann_world.build_index(shape, tweet_ids, tweet_scores)
    q_ids, q_scores = sann_world.draw_queries(shape, comm)
    index = ClusterTweetIndex(*(torch.from_numpy(a).to(dev) for a in index_np))
    sources = SparseEmbedding(torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_scores).to(dev))
    torch.cuda.synchronize()
    print(f"world: C={shape.C} M={shape.M} T={shape.T} KT={shape.KT} Q={shape.Q} built with numpy "
          f"and copied to the card in {time.perf_counter() - t0:.1f} s (set-up)")
    return shape, tweet_ids, tweet_scores, index_np, q_ids, q_scores, index, sources


def time_collapse(entries, label):
    """run_collapse against its plain version on the card: the same (row, id)
    slots, sums within SUM_RTOL / SUM_ATOL, both clocks, TB/s and the share
    of the bytes bound."""
    got = seg_scan.run_collapse_sorted(*entries)
    want = seg_scan.run_collapse_sorted_plain(*entries)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]), f"run_collapse (row, id) slots differ from the plain version at {label}")
    require(all(torch.allclose(g, w, rtol=SUM_RTOL, atol=SUM_ATOL) for g, w in zip(got[1:], want[1:])),
            f"run_collapse sums differ from the plain version at {label}")
    err = max(float((g - w).abs().max()) for g, w in zip(got[1:], want[1:]))
    n_runs = int((got[0] != PAD_ID).sum())
    kernel = lambda: seg_scan.run_collapse_sorted(*entries)  # noqa: E731
    plain = lambda: seg_scan.run_collapse_sorted_plain(*entries)  # noqa: E731
    ms, plain_ms = timed_pair(kernel, plain)
    dev_ms, plain_dev_ms = device_pair(kernel, plain, "run_collapse")
    # the same bytes through the device's own copy kernel: what the memory
    # system gives this traffic in practice
    copies = [torch.empty_like(t) for t in entries]
    copy_ms = device_ms(lambda: [c.copy_(t) for c, t in zip(copies, entries)], 50)
    del copies
    moved = 2 * sum(t.numel() * t.element_size() for t in entries)  # every slot read + written
    bound = bound_ms(moved)
    Q, W = entries[0].shape
    print(f"kernel run_collapse: {label} [{Q}, {W}] k={len(entries) - 1}, {n_runs} runs, {moved / 1e6:.2f} MB "
          f"moved, same (row, id) slots, max |sum err| {err:.3g} (rtol {SUM_RTOL}, atol {SUM_ATOL}); device "
          f"{dev_ms:.4f} ms ({moved / dev_ms / 1e9:.2f} TB/s, {100 * bound / dev_ms:.1f}% of its {bound:.4f} ms "
          f"bound) vs plain {plain_dev_ms:.4f} ms; events {ms:.4f} ms vs {plain_ms:.4f} ms; copy_ of the same "
          f"bytes {copy_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms, plain_device_ms=plain_dev_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None, copy_ms=copy_ms)


def phase_kernels(shape, index, sources):
    """Each kernel against its plain version on the inputs the SANN batch gives it."""
    src = sparse.truncate(sources, shape.N)
    safe = torch.where(src.valid_mask(), src.ids, 0).reshape(-1).contiguous()  # [Q·N] = 12,800
    tables = (index.tweet_ids, index.scores, index.timestamps)

    label = f"{safe.shape[0]} rows x 3 tables [{shape.C}, {shape.M}]"
    gathered = time_gather(safe, tables, label)
    time_ring_shapes(safe, tables, label)
    got = gather.row_gather(safe, *tables)
    rows = tuple(r.reshape(shape.Q, shape.N, shape.M) for r in got)
    entries = retrieval.sort_by_id(*retrieval.scan_entries(*rows, src))  # sorted [Q, N·M]
    collapsed = time_collapse(entries, "SANN batch's sorted entries")
    time_tile_shapes(entries, "SANN batch's sorted entries")
    return {"run_collapse": collapsed, "row_gather": gathered}


def time_tile_shapes(entries, label):
    """run_collapse's device time at seg_scan.SHAPE (first and last) and at
    each neighbour, every shape checked against the plain version: the
    measurement behind seg_scan.SHAPE."""
    want = seg_scan.run_collapse_sorted_plain(*entries)
    chosen, times = seg_scan.SHAPE, []
    try:
        for tile_shape in [chosen, *(seg_scan.TileShape(*n) for n in TILE_NEIGHBOURS), chosen]:
            seg_scan.SHAPE = tile_shape
            got = seg_scan.run_collapse_sorted(*entries)
            torch.cuda.synchronize()
            require(torch.equal(got[0], want[0]) and all(
                torch.allclose(g, w, rtol=SUM_RTOL, atol=SUM_ATOL) for g, w in zip(got[1:], want[1:])),
                f"run_collapse with {tile_shape} differs from the plain version at {label}")
            times.append((tile_shape, device_ms(lambda: seg_scan.run_collapse_sorted(*entries), 50)))
    finally:
        seg_scan.SHAPE = chosen
    (Q, W), k = entries[0].shape, len(entries) - 1
    sms = torch.cuda.get_device_properties(entries[0].device).multi_processor_count
    print(f"tile shapes at {label} (most slots a tile / stages / CTAs per SM -> plan: device ms): " + ", ".join(
        f"{s.tile_max}/{s.stages}/{s.per_sm}{'*' if s == chosen else ''} -> {tuple(seg_scan._plan(Q, W, k, sms, s))}: "
        f"{ms:.4f}"
        for s, ms in times))


# run_collapse's sweep (Q, W, k) on seeded rows, the SANN shape first
COLLAPSE_SWEEP = [(256, 20_000, 2), (32, 20_000, 2), (1024, 20_000, 2), (256, 20_000, 1), (256, 20_000, 3),
                  (16, 200_000, 2)]
# run_collapse at the candidate sources' shapes on seeded rows: UTEG [R, 8 seeds x 32],
# UTG [B, 128 users x 32] with one sum and with the JAX package's two
CANDIDATE_COLLAPSE_SWEEP = [(32, 256, 2), (256, 4096, 1), (256, 4096, 2)]
# the top-K of each path: (rows, row width, k, path)
TOP_K_SHAPES = [(256, 20_000, 200, "SANN"), (32, 1 << 18, 700, "earlybird in-network"), (32, 256, 256, "UTEG"),
                (256, 4096, 200, "UTG")]
# the neighbours of seg_scan.SHAPE: most slots to a tile, stages, CTAs aimed at per SM
TILE_NEIGHBOURS = [(2040, 2, 1), (2040, 3, 1), (2728, 3, 1), (3000, 2, 1), (4088, 1, 1), (4088, 2, 2)]


def collapse_entries(dev, Q, W, k, seed):
    """Seeded sorted rows: ids with runs of ~5 slots on average over the
    first 80% of each row, then a PAD tail; values uniform in [0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    real = W - W // 5
    ids = torch.randint(0, max(1, real // 5), (Q, W), generator=g, device=dev, dtype=torch.int32)
    ids[:, real:] = PAD_ID
    ids = torch.sort(ids, dim=1).values.contiguous()
    return (ids, *(torch.rand((Q, W), generator=g, device=dev) for _ in range(k)))


def phase_collapse_sweep(dev):
    """run_collapse at each sweep shape against its plain version."""
    for i, (Q, W, k) in enumerate(COLLAPSE_SWEEP):
        time_collapse(collapse_entries(dev, Q, W, k, i), "seeded rows")
    torch.cuda.empty_cache()


# the hydration tables' widths (the_algorithm_tpu/mixers/device_hydration.py:71-102)
# and the 4-byte path: (rows, columns, ids)
GATHER_SWEEP = [(1_000_000, 64, 16_384), (1_000_000, 128, 16_384), (1_000_000, 4, 262_144),
                (1_000_000, 7, 262_144)]
# the TMA ring's neighbours of gather.RING: stage budget, stages, CTAs per SM
# (at most: _plan keeps every CTA resident)
RING_NEIGHBOURS = [gather.RingShape(8 * 1024, 4, 8), gather.RingShape(32 * 1024, 4, 8),
                   gather.RingShape(16 * 1024, 2, 8), gather.RingShape(16 * 1024, 6, 8),
                   gather.RingShape(16 * 1024, 4, 4), gather.RingShape(16 * 1024, 4, 12)]


def time_ring_shapes(ids, tables, label):
    """The ring's device time at gather.RING (first and last) and at each
    neighbour, every shape bit-exact: the measurement behind gather.RING."""
    want = gather.row_gather_plain(ids, *tables)
    chosen, times = gather.RING, []
    try:
        for ring in [chosen, *RING_NEIGHBOURS, chosen]:
            gather.RING = ring
            got = gather.row_gather(ids, *tables)
            torch.cuda.synchronize()
            require(all(torch.equal(g.view(torch.uint8), w.view(torch.uint8)) for g, w in zip(got, want)),
                    f"row_gather with ring {ring} differs from index_select at {label}")
            times.append((ring, device_ms(lambda: gather.row_gather(ids, *tables), 50)))
    finally:
        gather.RING = chosen
    print(f"ring shapes at {label} (stage KB, stages, CTAs/SM: device ms): " + ", ".join(
        f"{r.stage_bytes // 1024}/{r.stages}/{r.ctas_per_sm}{'*' if r == chosen else ''}: {ms:.4f}"
        for r, ms in times))


def sweep_table(dev, i):
    R, M, B = GATHER_SWEEP[i]
    table = torch.randn((R, M), generator=torch.Generator(device=dev).manual_seed(i), device=dev)
    ids = torch.from_numpy(np.random.default_rng(i).integers(0, R, size=B).astype(np.int32)).to(dev)
    return ids, (table,), f"{B} rows of [{R}, {M}] f32 ({4 * M}-byte rows)"


def phase_gather_sweep(dev):
    """row_gather at each sweep shape: one f32 table, seeded ids with repeats."""
    time_ring_shapes(*sweep_table(dev, 0))
    for i in range(len(GATHER_SWEEP)):
        time_gather(*sweep_table(dev, i))
    torch.cuda.empty_cache()


def phase_retrieval(shape, tweet_ids, tweet_scores, index_np, q_ids, q_scores, index, sources):
    cfg = ann.SimClustersANNConfig(
        max_scan_clusters=shape.N, max_top_tweets_per_cluster=shape.M,
        max_num_results=shape.X, scoring_algorithm=ScoringAlgorithm.COSINE,
    )
    # the main path, counted: one batch through both kernels
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    out_ids, out_scores = ann.get_tweet_candidates_batch(index, sources, cfg)
    torch.cuda.synchronize()
    launches = {"run_collapse": seg_scan.run_collapse_sorted.launches,
                "row_gather": gather.row_gather.launches}
    require(all(n > 0 for n in launches.values()), f"a kernel of the path never launched: {launches}")
    require(out_ids.shape == (shape.Q, shape.X) and out_scores.shape == (shape.Q, shape.X),
            f"result shape {tuple(out_ids.shape)}")
    real = out_ids != PAD_ID
    require(bool(real.all()), "a query returned fewer than X candidates")
    require(bool(torch.isfinite(out_scores[real]).all()), "non-finite scores")
    require(bool((out_scores[:, :-1] >= out_scores[:, 1:]).all()), "scores not descending")
    print(f"retrieval: get_tweet_candidates_batch Q={shape.Q} COSINE -> [{shape.Q}, {shape.X}], "
          f"launches {launches}")

    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ann.get_tweet_candidates_batch(index, sources, cfg)
    torch.cuda.synchronize()
    qps = shape.Q * reps / (time.perf_counter() - t0)

    got_np = out_ids.cpu().numpy()
    hits = total = 0
    for q in range(8):
        want = retrieval.approximate_cosine_similarity_reference(
            *index_np, q_ids[q], q_scores[q], max_results=K_RECALL, algorithm=ScoringAlgorithm.COSINE
        )
        want_ids = {t for t, _ in want}
        hits += len(want_ids & set(got_np[q, :K_RECALL].tolist()))
        total += len(want_ids)
    parity = hits / max(total, 1)
    require(parity >= 0.99, f"oracle parity {parity} < 0.99")

    ti, tsc = sann_world.padded_corpus(tweet_ids, tweet_scores, EXACT_BLOCK)
    t0 = time.perf_counter()
    truth, _ = retrieval.exact_cosine_scan(
        torch.from_numpy(ti).to(index.scores.device), torch.from_numpy(tsc).to(index.scores.device),
        sources, num_clusters=shape.C, max_results=K_RECALL, block=EXACT_BLOCK,
    )
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    recall = float(metrics.recall_at_k(out_ids[:, :K_RECALL], truth, pad_id=PAD_ID))
    require(abs(recall - JAX_RECALL_AT_100) <= 0.02, f"recall@100 {recall} not within 0.02 of 0.5705")
    print(f"retrieval: oracle parity {parity:.4f} on 8 queries; recall@{K_RECALL} {recall:.4f} against "
          f"the exact scan ({exact_s:.2f} s, {ti.shape[0]} rows; JAX package: {JAX_RECALL_AT_100})")
    print(f"retrieval: {qps:.1f} queries/s at Q={shape.Q} (host clock, {reps} batches; not a benchmark)")

    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        ann.get_tweet_candidates_batch(index, sources, cfg)
        torch.cuda.synchronize()
    print("retrieval profile, one batch (torch.profiler, top 16 by device time):")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=16))
    return launches, out_ids.cpu().numpy(), out_scores.cpu().numpy(), recall


def ring_loop(shape, rows, *values):
    """The JAX package's per-event ring append (``uteg.py:73-79``) in numpy:
    the reference the port's one-pass append is held to."""
    tables = [np.full(shape, PAD_ID, np.int32)] + [np.zeros(shape, np.int32) for _ in values[1:]]
    for i, r in enumerate(rows):
        for t, v in zip(tables, values):
            t[r, 1:] = t[r, :-1]
            t[r, 0] = v[i]
    return tables


def uteg_oracle(tables, seeds, k):
    """One user's UTEG list from numpy dicts: score = Σ seed weight (1) ·
    type weight over the seeds' engagements, proof = their count, ranked by
    score, then id (``lax.top_k``'s order over id-sorted slots)."""
    tweets, types, _ = tables
    score, proof = {}, {}
    for s in seeds:
        for t, ty in zip(tweets[s], types[s]):
            if t != PAD_ID:
                score[t] = score.get(t, 0.0) + float(uteg.DEFAULT_TYPE_WEIGHTS[ty])
                proof[t] = proof.get(t, 0) + 1
    ranked = sorted(score, key=lambda t: (-np.float32(score[t]), t))[:k]
    return ranked, [np.float32(score[t]) for t in ranked], [proof[t] for t in ranked]


def utg_oracle(right_users, left_tweets, src, k):
    """One source's UTG list from numpy dicts: cooc(c) = engagements of c by
    the users who engaged ``src``; score = cooc / sqrt(deg(src) · deg(c)) in
    float32; ranked by score, then id."""
    cooc = {}
    for u in right_users[src]:
        if u != PAD_ID:
            for t in left_tweets[u]:
                if t != PAD_ID and t != src:
                    cooc[t] = cooc.get(t, 0) + 1
    deg = np.maximum((right_users != PAD_ID).sum(1), 1).astype(np.float32)
    score = {t: np.float32(c) / np.sqrt(deg[src] * deg[t]) for t, c in cooc.items()}
    ranked = sorted(score, key=lambda t: (-score[t], t))[:k]
    return ranked, [score[t] for t in ranked], [cooc[t] for t in ranked]


def check_same_ranking(ids, scores, want_ids, want_scores, rtol, atol, what):
    """Two [R, K] rankings (numpy) of float32 scores summed in different
    orders agree: scores rank by rank within ``rtol``/``atol``; ids equal at
    every rank whose score stands more than twice the tolerance from its
    neighbours'; elsewhere near-tied docs may trade places, or trade the last
    kept place for the first dropped one, and an id in both lists has the
    same score in both. Returns the number of ranks whose ids differ."""
    require(ids.shape == want_ids.shape and np.array_equal(ids == PAD_ID, want_ids == PAD_ID),
            f"{what}: not the same number of results")
    require(np.allclose(scores, want_scores, rtol=rtol, atol=atol), f"{what}: scores differ")
    moved = 0
    for r in range(ids.shape[0]):
        n = int((want_ids[r] != PAD_ID).sum())
        a, b = ids[r, :n], want_ids[r, :n]
        s = want_scores[r, :n].astype(np.float64)
        tol = 2 * (atol + rtol * np.abs(s))
        near = np.zeros(n, bool)
        near[1:] |= np.abs(np.diff(s)) <= tol[1:]
        near[:-1] |= np.abs(np.diff(s)) <= tol[:-1]
        got_s = dict(zip(a.tolist(), scores[r, :n].tolist()))
        want_s = dict(zip(b.tolist(), s.tolist()))
        for t in got_s.keys() & want_s.keys():
            require(abs(got_s[t] - want_s[t]) <= atol + rtol * abs(want_s[t]), f"{what}: id {t} scored apart")
        for t in got_s.keys() ^ want_s.keys():  # only across the cut of a full list
            require(n == ids.shape[1] and abs(got_s.get(t, want_s.get(t)) - s[-1]) <= tol[-1],
                    f"{what}: id {t} in one list only, away from the cut")
        clear = ~near
        if n == ids.shape[1] and a[-1] not in want_s:
            clear[-1] = False  # the last kept place went to a doc the other list dropped
        require(bool((a == b)[clear].all()), f"{what} row {r}: ids differ at a rank clear of its neighbours")
        moved += int((a != b).sum())
    return moved


def check_list(got, want, k, what, rtol):
    """A [k] result row (ids, scores, counts) against an oracle's ranked list:
    ids and counts exact, scores within ``rtol``, PAD_ID / -inf / 0 after."""
    ids, scores, counts = (t.cpu().numpy() for t in got)
    w_ids, w_scores, w_counts = want
    n = len(w_ids)
    require(ids.shape == (k,) and ids[:n].tolist() == list(w_ids) and bool((ids[n:] == PAD_ID).all()),
            f"{what}: ids differ from the oracle's")
    require(counts[:n].tolist() == list(w_counts) and bool((counts[n:] == 0).all()),
            f"{what}: counts differ from the oracle's")
    require(np.allclose(scores[:n], w_scores, rtol=rtol, atol=0) and bool(np.isneginf(scores[n:]).all()),
            f"{what}: scores differ from the oracle's")


def phase_candidates(dev):
    """The For You candidate sources at bench.py's shape: the earlybird
    in-network scan, UTEG and UTG, each as one batch on the card."""
    t0 = time.perf_counter()
    s = foryou_world.FULL
    world = foryou_world.build(s, users=CAND_R)
    index = foryou_world.earlybird_index(world, dev)
    graph = foryou_world.engagement_graph(world, dev)
    right = foryou_world.right_index(world, dev)
    query = foryou_world.in_network_query().to(dev)
    follows = torch.from_numpy(world.follows).to(dev)
    seeds = torch.from_numpy(world.seeds[np.arange(CAND_R) % s.num_users]).to(dev)
    weights = torch.ones(seeds.shape, device=dev)
    sources = torch.from_numpy(world.utg_sources).to(dev)
    torch.cuda.synchronize()
    print(f"candidates: For You world (earlybird {s.eb_docs} docs x {len(earlybird.DOC_FEATURES)} features, "
          f"UTEG {s.num_users} users x {s.uteg_width}, UTG {s.tweet_space} tweets x {s.utg_width}, "
          f"{world.ev_users.shape[0]} events) built with numpy and on the card in {time.perf_counter() - t0:.1f} s "
          "(set-up)")

    batches = {
        "earlybird": lambda: earlybird.search_in_network_batch(index, query, follows, max_results=EB_RESULTS),
        "uteg": lambda: uteg.recommend(graph, seeds, weights, max_results=UTEG_RESULTS),
        "utg": lambda: graphjet.related_tweets(graph, right, sources, max_results=UTG_RESULTS),
    }
    # the main paths, counted: one batch each
    outs, launches = {}, {}
    for name, fn in batches.items():
        seg_scan.run_collapse_sorted.launches = 0
        gather.row_gather.launches = 0
        outs[name] = fn()
        torch.cuda.synchronize()
        launches[name] = {"run_collapse": seg_scan.run_collapse_sorted.launches,
                          "row_gather": gather.row_gather.launches}
    print(f"candidates: launches per batch {launches}")
    require(launches["uteg"] == {"run_collapse": 1, "row_gather": 1}, f"UTEG launches {launches['uteg']}")
    require(launches["utg"] == {"run_collapse": 1, "row_gather": 2}, f"UTG launches {launches['utg']}")

    # the graphs built on the card equal the per-event loop
    t0 = time.perf_counter()
    want = ring_loop((s.num_users, s.uteg_width), world.ev_users, world.ev_tweets, world.ev_types, world.ev_ts)
    require(all(np.array_equal(g.cpu().numpy(), w) for g, w in zip(graph, want)), "UTEG graph != per-event loop")
    left_np = want
    want = ring_loop((s.tweet_space, s.utg_width), world.ev_tweets, world.ev_users, world.ev_ts)
    require(all(np.array_equal(g.cpu().numpy(), w) for g, w in zip(right, want)), "UTG index != per-event loop")
    right_np = want
    print(f"candidates: UTEG graph and UTG index built on the card equal the per-event append loop "
          f"({time.perf_counter() - t0:.1f} s of numpy)")

    # earlybird: the card against the port on the CPU, same index and follows
    ids, scores = outs["earlybird"]
    cpu_ids, cpu_scores = earlybird.search_in_network_batch(
        foryou_world.earlybird_index(world, "cpu"), foryou_world.in_network_query(), torch.from_numpy(world.follows),
        max_results=EB_RESULTS)
    ids, scores = ids.cpu(), scores.cpu()
    require(ids.shape == (CAND_R, EB_RESULTS), f"earlybird ids of shape {tuple(ids.shape)}")
    moved = check_same_ranking(ids.numpy(), scores.numpy(), cpu_ids.numpy(), cpu_scores.numpy(), EB_RTOL, EB_ATOL,
                               "earlybird on the card against the CPU run")
    real = ids != PAD_ID
    require(bool(real[:, 0].all()) and bool(torch.isfinite(scores[real]).all())
            and bool((scores[:, :-1] >= scores[:, 1:]).all()), "earlybird results not ranked")
    err = float((scores[real] - cpu_scores[real]).abs().max())
    print(f"candidates: earlybird in-network R={CAND_R} -> [{CAND_R}, {EB_RESULTS}], {int(real.sum())} hits, the "
          f"CPU run's ranking ({moved} ranks hold another id, all within near-ties), max |score diff| {err:.3g} "
          f"(rtol {EB_RTOL}, atol {EB_ATOL})")

    # UTEG and UTG against numpy dict oracles
    k = min(UTEG_RESULTS, s.seeds * s.uteg_width)
    for r in range(CAND_R):
        check_list([t[r] for t in outs["uteg"]], uteg_oracle(left_np, world.seeds[r % s.num_users], k), k,
                   f"UTEG user {r}", GRAPH_RTOL)
    hits = int((outs["uteg"][0] != PAD_ID).sum())
    print(f"candidates: UTEG R={CAND_R} x {s.seeds} seeds -> [{CAND_R}, {k}], {hits} candidates, all {CAND_R} users "
          f"equal the numpy oracle (ids, proof exact; scores rtol {GRAPH_RTOL})")
    k = min(UTG_RESULTS, s.utg_width * s.uteg_width)
    for b in range(UTG_CHECKED):
        check_list([t[b] for t in outs["utg"]], utg_oracle(right_np[0], left_np[0], int(world.utg_sources[b]), k), k,
                   f"UTG source {b}", GRAPH_RTOL)
    hits = int((outs["utg"][0] != PAD_ID).sum())
    print(f"candidates: UTG B={s.utg_sources} sources -> [{s.utg_sources}, {k}], {hits} candidates, {UTG_CHECKED} "
          f"sources equal the numpy oracle (ids, co-occurrence exact; scores rtol {GRAPH_RTOL})")

    # host clock, before this phase's profiler sessions
    reps = 20
    for name, fn in batches.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        print(f"candidates: {name} {1 / dt:.1f} batches/s ({1e3 * dt:.3f} ms a batch; host clock, {reps} batches; "
              "not a benchmark)")
    for name, fn in batches.items():
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            fn()
            torch.cuda.synchronize()
        print(f"candidates: {name} profile, one batch (torch.profiler, top 10 by device time):")
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=10))

    return {name: launches[name] for name in ("uteg", "utg")}, (world, index, graph, right)


def phase_candidate_kernels(dev, cand):
    """The kernels at the shapes the candidate paths give them, and on
    seeded rows; then top_k at each path's shape."""
    world, _, graph, right = cand
    s = world.shape
    seeds = torch.from_numpy(world.seeds[np.arange(CAND_R) % s.num_users]).to(dev)
    weights = torch.ones(seeds.shape, device=dev)
    sources = torch.from_numpy(world.utg_sources).to(dev)
    entries = retrieval.sort_by_id(*uteg.engagement_entries(graph, seeds, weights))
    time_collapse(entries, "UTEG batch's sorted entries")
    flat, ones, users = graphjet.cooccurrence_entries(graph, right, sources)
    time_collapse(retrieval.sort_by_id(flat, ones), "UTG batch's sorted entries")
    time_collapse(retrieval.sort_by_id(flat, ones, ones), "UTG batch's sorted entries, the JAX package's two sums")
    for i, (Q, W, kk) in enumerate(CANDIDATE_COLLAPSE_SWEEP):
        time_collapse(collapse_entries(dev, Q, W, kk, 100 + i), "seeded rows")
    time_gather(uteg.safe_rows(seeds, s.num_users).reshape(-1), tuple(graph),
                f"UTEG seed fetch, {seeds.numel()} rows x 3 tables [{s.num_users}, {s.uteg_width}] int32")
    hop1 = gather.jax_rows(sources, s.tweet_space)
    time_gather(hop1, (right.user_ids, right.timestamps),
                f"UTG first hop, {hop1.numel()} rows x 2 tables [{s.tweet_space}, {s.utg_width}] int32")
    hop2 = gather.jax_rows(torch.where(users != PAD_ID, users, 0), s.num_users).reshape(-1)
    time_gather(hop2, (graph.tweet_ids, graph.timestamps),
                f"UTG second hop, {hop2.numel()} rows x 2 tables [{s.num_users}, {s.uteg_width}] int32")
    for Q, N, k, label in TOP_K_SHAPES:
        time_top_k(dev, Q, N, k, label)
    torch.cuda.empty_cache()


# the For You request as bench.py serves it (bench.py:395-614): its hydration
# world, candidate slots, ranker and selection, nothing cut
FY_WORLD = dict(seed=5, num_users=16_384, num_authors=4_096, num_tweets=1 << 17, engagement_width=16,
                now=foryou_world.NOW)
FY_PB = 1536
FY_TOP_K = 50
FY_MODEL = dict(num_heads=15, mask_blocks=4, block_dim=512, aggregation_dim=128, head_hidden=(256, 128))
FY_BATCHES = (1, 2, 4, 8, 16, 32)
FY_R = 32  # the counted serve batch (bench.py's largest)
FY_CPU_R = 2  # requests held against the port on the CPU
FY_SERIAL = 32  # R=1 requests for the latency percentiles
FY_FRONT = 64  # concurrent requests through the 2-worker front
# kernel launches of one serve batch: the hydration multiget reads the keyed
# tables in 13 launches of <= 3 same-key tables (16-byte rows on the TMA ring,
# the two 4-byte tables apart) and the packed aggregate stores in 2; UTEG's
# seed fetch 1, its dedup 1 run_collapse
FY_LAUNCHES = {"run_collapse": 1, "row_gather": 16}
# the card against the CPU: float32 sums of ≤ 16 terms, exp2/log1p/sqrt of
# them, in another order on each device; the model's scores at the same rtol
FY_RTOL, FY_ATOL = 1e-5, 1e-6
# device selection against the host's: the same scores but for the host's
# float64 diversity factor
SELECT_RTOL = 1e-6
# the score checks are repeated on candidates with creation times below
# SPREAD_TS seconds (ids % SPREAD_TS, as the CPU tests' lift): bench.py's
# ~1e7-second times dominate the random ranker's input layer norm and squeeze
# a request's scores within ~1e-4 of each other, where neither a wrong row
# nor bf16's rounding shows
SPREAD_TS = 1000
# bf16 against f32 there: each score's distance from its request's median
# within this share of the largest distance, and the two orders' rank
# correlation at least this (a path that scored other rows, or ignored its
# input, fails both)
BF16_DEV_SHARE, BF16_RANK_CORR = 0.1, 0.99
# schema families that are copies, one-hots or counts: equal on both devices
FY_EXACT = ("eb_", "twhin_", "user_interests_emb", "author_agg_emb", "media_clip", "text_emb", "uss_",
            "follows_who", "tweepcred", "author_follower", "author_following", "author_account",
            "author_is_verified", "viewer_follows", "author_follows", "retrieval_score", "social_proof",
            "author_id", "created_ts", "is_in_network", "topic_relevance", "ctx_", "source_onehot")


def schema_columns():
    """[(name, start, end)] of every schema spec, in column order."""
    out, col = [], 0
    for spec in fs.WIDE_SCHEMA:
        out.append((spec.name, col, col + spec.width))
        col += spec.width
    return out


def ranked(lists, k):
    """Served lists of Candidates as [R, k] ids (PAD_ID after the last) and
    scores (0 after)."""
    ids, scores = np.full((len(lists), k), PAD_ID, np.int64), np.zeros((len(lists), k))
    for r, got in enumerate(lists):
        ids[r, :len(got)], scores[r, :len(got)] = [c.id for c in got], [c.score for c in got]
    return ids, scores


def top_by_score(batch, scored, k):
    """[R, k] ids and combined scores of each request's k best candidates
    (stable order), from a columnar batch and its ``score_columnar``."""
    ids, scores = np.full((len(batch), k), PAD_ID, np.int64), np.zeros((len(batch), k))
    for r, ((_, cols, _), (_, combined)) in enumerate(zip(batch, scored)):
        top = np.argsort(-combined, kind="stable")[:k]
        ids[r, :len(top)], scores[r, :len(top)] = cols["ids"][top], combined[top]
    return ids, scores


def spread_lift(lift):
    """``lift``, but with creation times below SPREAD_TS seconds."""
    def attach(c):
        c.cols.setdefault("created_ts", c.ids % SPREAD_TS)
        return lift(c)
    return attach


def card_against_cpu(card, cpu, cols):
    """Every candidate's f32 score from the ``card`` scorer against the
    ``cpu`` one on columnar requests, and their top-K before the diversity
    rescore as :func:`check_same_ranking` holds them. Returns the largest
    relative score error, the ranks holding another id, and the median over
    requests of the relative gap between neighbouring top-K scores."""
    got, want = card.score_columnar(cols), cpu.score_columnar(cols)
    err, gaps = 0.0, []
    for (gp, gc), (wp, wc) in zip(got, want):
        np.testing.assert_allclose(gp, wp, rtol=FY_RTOL, atol=FY_ATOL)
        np.testing.assert_allclose(gc, wc, rtol=FY_RTOL, atol=0)
        err = max(err, float(np.max(np.abs(gc - wc) / np.abs(wc))))
        top = np.sort(wc.astype(np.float64))[::-1][:FY_TOP_K]
        gaps.append(np.median(-np.diff(top)) / top[0])
    ids, scores = top_by_score(cols, got, FY_TOP_K)
    want_ids, want_sc = top_by_score(cols, want, FY_TOP_K)
    moved = check_same_ranking(ids, scores, want_ids, want_sc, FY_RTOL, 0.0, "the f32 top-50 on the card")
    return err, moved, float(np.median(gaps))


def bf16_against_f32(got16, want):
    """bf16 combined scores against f32 ones, each request's: within
    SCORE_RTOL / SCORE_ATOL (required). Returns the largest relative error;
    the largest gap between a bf16 and an f32 score's distance from its
    request's median, over the largest f32 distance; and the least rank
    correlation of the two orders."""
    rel, share, corr = 0.0, 0.0, 1.0
    for (_, c16), (_, c32) in zip(got16, want):
        np.testing.assert_allclose(c16, c32, rtol=SCORE_RTOL, atol=SCORE_ATOL)
        rel = max(rel, float(np.max(np.abs(c16 - c32) / np.maximum(np.abs(c32), 1e-30))))
        d16, d32 = c16 - np.median(c16), c32 - np.median(c32)
        share = max(share, float(np.max(np.abs(d16 - d32)) / np.max(np.abs(d32))))
        ranks = [np.argsort(np.argsort(c, kind="stable")) for c in (c16, c32)]
        corr = min(corr, float(np.corrcoef(*ranks)[0, 1]))
    return rel, share, corr


def phase_foryou(dev, sann, cand):
    """bench.py's For You request end to end: SANN rows, the earlybird and
    UTEG sources, the hydration of a 6,823-column row per candidate slot and
    MaskNet in bf16, the author-diversity top-50 on the card, behind a
    RequestBatcher. Returns the launches of one counted R=32 batch, and the
    serving engine's pieces the exact-tier and live-update phases reuse."""
    sann_ids, sann_scores = sann
    fy_world, index, graph, _ = cand
    t0 = time.perf_counter()
    world = wh.synthetic_world(**FY_WORLD, device=dev)
    tables, fns, res = dh.build_from_world(world, world.pop("device_spec"))
    torch.cuda.synchronize()
    n_sources = len(fs.candidate_source_names())
    F = fs.total_width(fs.WIDE_SCHEMA)
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()  # the stores are views into their pack
                for f in tables for t in (f if isinstance(f, tuple) else (f,))}
    table_mb = sum(storages.values()) / 1e6
    print(f"foryou: hydration world (users {FY_WORLD['num_users']}, authors {FY_WORLD['num_authors']}, tweets "
          f"{FY_WORLD['num_tweets']}, {len(tables.agg_values)} aggregate stores; {table_mb:.0f} MB of tables) built "
          f"with numpy and on the card in {time.perf_counter() - t0:.1f} s (set-up); schema {F} columns, "
          f"{n_sources} sources")

    cfg32 = masknet.MaskNetConfig(num_features=F, **FY_MODEL, dtype="float32")
    ref = masknet.MaskNet(cfg32, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    m16 = masknet.MaskNet(masknet.MaskNetConfig(num_features=F, **FY_MODEL, dtype="bfloat16"), device=dev)
    m16.load_state_dict(ref.state_dict())
    weights = masknet.DEFAULT_HEAD_WEIGHTS

    def scorer(model, dtype, k, t=tables):
        return dh.DeviceHydrationScorer(t, fns, res, model, weights, pad_b=FY_PB, compute_dtype=dtype, select_top_k=k)

    half = sann_ids.shape[0] // 2
    s = fy_world.shape
    sources = [  # bench.py:495-506
        bf.PrecomputedBatchSource(sann_ids[:half], sann_scores[:half]),
        bf.EarlybirdBatchSource(index, foryou_world.NOW, max_results=EB_RESULTS),
        bf.UtegBatchSource(graph, lambda u: fy_world.seeds[u % s.num_users], max_results=UTEG_RESULTS),
        bf.PrecomputedBatchSource(sann_ids[half:], sann_scores[half:], name="TweetMixer"),
    ]

    lift = bf.ColumnsLift(FY_WORLD["num_authors"], foryou_world.NOW)

    def engine(sc, lift=lift, max_age_s=48 * 3600):
        return bf.BatchedForYouEngine(batch_sources=sources, scorer=sc, head_names=masknet.DEFAULT_HEAD_NAMES,
                                      lift=lift, max_age_s=max_age_s)

    served = engine(scorer(m16, torch.bfloat16, FY_TOP_K))  # the serving engine: bf16, selection on the card
    f32 = engine(scorer(ref, torch.float32, FY_TOP_K))  # the same in f32
    host_select = engine(scorer(ref, torch.float32, None))  # f32, the diversity rescore on the host
    follows = [[int(a) for a in row if a != PAD_ID] for row in fy_world.follows]

    def queries(R, base=0):
        return [ForYouQuery(user_id=base + u, followed_authors=follows[(base + u) % len(follows)],
                            max_results=FY_TOP_K, now=foryou_world.NOW) for u in range(R)]

    for R in FY_BATCHES:  # each batch size once, as bench.py warms up
        require(all(len(o) > 0 for o in served.serve_batch(queries(R))), f"an empty list at R={R}")
    torch.cuda.synchronize()

    # the main path, counted: one serve batch
    batch = queries(FY_R)
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    out = served.serve_batch(batch)
    torch.cuda.synchronize()
    launches = {"run_collapse": seg_scan.run_collapse_sorted.launches, "row_gather": gather.row_gather.launches}
    print(f"foryou: launches per R={FY_R} serve batch {launches} (hydration multiget and UTEG)")
    require(launches == FY_LAUNCHES, f"For You launches {launches}, want {FY_LAUNCHES}")
    require(len(out) == FY_R and all(0 < len(o) <= FY_TOP_K for o in out), "a list empty or too long")
    for o in out:
        sc = np.asarray([c.score for c in o])
        require(bool(np.isfinite(sc).all()) and bool((sc[:-1] >= sc[1:]).all()), "a list not ranked")
        require(len({c.id for c in o}) == len(o), "a list repeats an id")
    merged, _ = served.columns(batch)
    n_cands = [len(c) for c in merged]
    print(f"foryou: R={FY_R} -> {sum(len(o) for o in out)} ranked of {sum(n_cands)} candidates "
          f"({min(n_cands)}-{max(n_cands)} a request, {FY_PB} slots)")

    # host clock, before this phase's profiler sessions
    rps = {}
    for R in FY_BATCHES:
        qs = queries(R, base=200)
        reps = 3 if R >= 16 else 6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            served.serve_batch(qs)
        torch.cuda.synchronize()
        rps[R] = (R * reps / (time.perf_counter() - t0), (time.perf_counter() - t0) / reps)
    batch_ms = 1e3 * rps[FY_R][1]
    t0 = time.perf_counter()
    _, cols32 = served.columns(batch)
    t1 = time.perf_counter()
    served.scorer.select_columnar(cols32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lat = []
    for u in range(FY_SERIAL):
        t0s = time.perf_counter()
        served.serve_batch(queries(1, base=100 + u))
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0s))
    lat = np.sort(lat)
    sizes = []

    def serve(qs):
        sizes.append(len(qs))
        return served.serve_batch(qs)

    front = RequestBatcher(serve, BatcherConfig(max_batch_size=FY_R, max_delay_ms=10.0), n_workers=2)
    try:
        with ThreadPoolExecutor(FY_FRONT) as pool:
            t0f = time.perf_counter()
            answers = list(pool.map(lambda i: front.serve(queries(1, base=300 + i)[0], timeout=300), range(FY_FRONT)))
            front_s = time.perf_counter() - t0f
    finally:
        front.close()
    require(len(answers) == FY_FRONT and all(0 < len(a) <= FY_TOP_K for a in answers), "the front left a request empty")
    print("foryou: requests/s by batch (host clock; not a benchmark): " + ", ".join(
        f"R={R} {v[0]:.1f} ({1e3 * v[1]:.1f} ms a batch)" for R, v in rps.items()))
    print(f"foryou: R={FY_R} batch split on the host clock: sources + merge {1e3 * (t1 - t0):.1f} ms, scorer "
          f"(request build, pack, device pass, fetch) {1e3 * (t2 - t1):.1f} ms")
    print(f"foryou: serial R=1 latency over {FY_SERIAL} requests: p50 {lat[len(lat) // 2]:.1f} ms, p99 "
          f"{lat[min(len(lat) - 1, int(np.ceil(0.99 * (len(lat) - 1))))]:.1f} ms")
    print(f"foryou: 2-worker front (max batch {FY_R}, 10 ms) answered {FY_FRONT} concurrent requests, each a "
          f"non-empty list, in {front_s:.2f} s ({FY_FRONT / front_s:.1f} requests/s; batches of {sizes})")

    # the card against the port on the CPU, the same requests
    _, cpu_cols = f32.columns(batch[:FY_CPU_R])
    sc = f32.scorer
    req = dh.batch_requests([sc.builder.build_columnar(q, c, n) for q, c, n in cpu_cols])
    packed = dh.pack_requests(req, compact_rows=sc._compact_rows)
    cpu_tables = tables.to("cpu")
    got = {}
    for where, t in (("card", tables), ("cpu", cpu_tables)):
        with torch.inference_mode():
            r = dh.unpack_requests(torch.from_numpy(packed).to(t.doc_table.device), sc.builder.follow_width,
                                   compact_rows=sc._compact_rows)
            got[where] = dh.assemble(t, fns, r, n_sources=n_sources, agg_packed=t.agg_packed).cpu()
    x, want_x = got["card"], got["cpu"]
    require(x.shape == (FY_CPU_R, FY_PB, F) and bool(torch.isfinite(x).all()), f"features of shape {tuple(x.shape)}")
    worst = {}
    for name, a, b in schema_columns():
        d = (x[..., a:b].double() - want_x[..., a:b].double()).abs()
        if name.startswith(FY_EXACT):
            require(torch.equal(x[..., a:b], want_x[..., a:b]), f"{name} differs between the card and the CPU")
        require(torch.allclose(x[..., a:b], want_x[..., a:b], rtol=FY_RTOL, atol=FY_ATOL),
                f"{name} beyond rtol {FY_RTOL} / atol {FY_ATOL} of the CPU")
        fam = name.split("_")[0]
        if float(d.max()) >= worst.get(fam, (0.0, ""))[0]:
            worst[fam] = (float(d.max()), name)
    cpu_scorer = scorer(masknet.MaskNet(cfg32, device="cpu"), torch.float32, None, cpu_tables)
    cpu_scorer.model.load_state_dict(ref.state_dict())
    # the f32 engine's ranking before its diversity rescore (which a later
    # check holds on the card): at bench.py's creation times its combined
    # scores sit a few float32 ulps apart, where two summation orders may
    # swap neighbours
    err, moved, gap = card_against_cpu(host_select.scorer, cpu_scorer, cpu_cols)
    print(f"foryou: card against CPU, R={FY_CPU_R} x {FY_PB} slots x {F} columns: copies, one-hots and counts "
          f"equal; worst |diff| by family " + ", ".join(f"{f} {e:.3g} ({n})" for f, (e, n) in worst.items() if e > 0)
          + f" (rtol {FY_RTOL}, atol {FY_ATOL}); f32 scores of {sum(n for _, _, n in cpu_cols)} candidates within "
          f"rel {err:.3g}; top-{FY_TOP_K} the CPU's ranking ({moved} ranks hold another id, within near-ties; "
          f"neighbours {gap:.3g} apart, relative)")
    del x, want_x, got

    # the same requests with small creation times, where scores spread: the
    # card against the CPU, then bf16 against f32
    spread = engine(host_select.scorer, lift=spread_lift(lift), max_age_s=10 ** 9)
    _, spread_cols = spread.columns(batch)
    t0 = time.perf_counter()
    err, moved, gap = card_against_cpu(host_select.scorer, cpu_scorer, spread_cols)
    print(f"foryou: card against CPU with creation times below {SPREAD_TS} s, R={FY_R}: f32 scores of "
          f"{sum(n for _, _, n in spread_cols)} candidates within rel {err:.3g} (rtol {FY_RTOL}); top-{FY_TOP_K} "
          f"the CPU's ranking ({moved} ranks hold another id, within near-ties; neighbours {gap:.3g} apart, "
          f"relative; {time.perf_counter() - t0:.1f} s with the CPU's pass)")
    del cpu_tables, cpu_scorer
    scorer16 = scorer(m16, torch.bfloat16, None)
    rel, dev_share, corr = bf16_against_f32(scorer16.score_columnar(spread_cols),
                                            host_select.scorer.score_columnar(spread_cols))
    require(dev_share <= BF16_DEV_SHARE and corr >= BF16_RANK_CORR,
            f"bf16 scores off f32's spread: deviation share {dev_share:.3g}, rank correlation {corr:.4f}")
    print(f"foryou: bf16 against f32 with creation times below {SPREAD_TS} s, R={FY_R}: max rel err {rel:.3g} "
          f"(rtol {SCORE_RTOL}); each score's distance from its request's median within {dev_share:.3g} of the "
          f"largest (at most {BF16_DEV_SHARE}); rank correlation at least {corr:.5f} (at least {BF16_RANK_CORR})")

    # device selection against the host's rescore, and bf16 against f32, on the card
    ids, scores = ranked(f32.serve_batch(batch), FY_TOP_K)
    want_ids, want_sc = ranked(host_select.serve_batch(batch), FY_TOP_K)
    moved = check_same_ranking(ids, scores, want_ids, want_sc, SELECT_RTOL, 0.0, "device selection")
    print(f"foryou: device-selected top-{FY_TOP_K} against the host rescore (R={FY_R}): the same ranking "
          f"({moved} ranks hold another id, within near-ties; rtol {SELECT_RTOL})")
    _, cols32 = f32.columns(batch)
    want = host_select.scorer.score_columnar(cols32)
    rel, dev_share, corr = bf16_against_f32(scorer16.score_columnar(cols32), want)
    print(f"foryou: served bf16 scores against the f32 engine over {sum(len(c) for _, c in want)} candidates: "
          f"max rel err {rel:.3g} (rtol {SCORE_RTOL}, atol {SCORE_ATOL}); at bench.py's creation times the "
          f"scores spread too little to rank by: distance from the median within {dev_share:.3g} of the largest, "
          f"rank correlation {corr:.3g} (neither required)")

    # where an R=32 batch's device time goes: each step alone, then the batch profiled
    free, total = torch.cuda.mem_get_info()
    print(f"foryou: device memory after the checks: peak allocated {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB, reserved {torch.cuda.memory_reserved() / 2**30:.1f} GiB, free {free / 2**30:.1f} of "
          f"{total / 2**30:.1f} GiB")
    sc = served.scorer
    req = dh.batch_requests([sc.builder.build_columnar(q, c, n) for q, c, n in cols32])
    with torch.inference_mode():
        r = dh.unpack_requests(torch.from_numpy(dh.pack_requests(req, compact_rows=sc._compact_rows)).to(dev),
                               sc.builder.follow_width, compact_rows=sc._compact_rows)
        x = dh.assemble(tables, fns, r, n_sources=n_sources, agg_packed=tables.agg_packed)
        xb = x.reshape(-1, F).to(torch.bfloat16)
        combined = masknet.weighted_model_score(torch.sigmoid(m16(xb)).float(), weights).reshape(FY_R, FY_PB)
        steps = {
            "assemble": lambda: sc._assemble(r, tables),
            "MaskNet bf16": lambda: m16(xb),
            "select": lambda: dh.diversity_select(combined, r.author_ids, r.cand_ids, FY_TOP_K),
        }
        split = {name: device_ms(fn, 5) for name, fn in steps.items()}
        calls = []

        def recording(group, key):
            calls.append((group, key))
            return dh.multiget(group, key)

        dh.gather_rows(tables, r, gather=recording, agg_packed=tables.agg_packed)
    del x, xb
    print(f"foryou: device time of the R={FY_R} steps alone: "
          + ", ".join(f"{n} {ms:.3f} ms" for n, ms in split.items()))

    # the multiget's launches at their shapes against index_select
    for group, key in calls:
        flat = {n: dh._as_rows(t) for n, t in group.items()}
        for names in dh.launch_groups(flat):
            tabs = tuple(flat[n] for n in names)
            label = (f"hydration {', '.join(names)}: {key.numel()} rows x "
                     f"{'+'.join(str(t.shape[1] * t.element_size()) for t in tabs)} B")
            time_gather(key.reshape(-1).contiguous(), tabs, label)
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        served.serve_batch(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1000
    print(f"foryou: profile of one R={FY_R} serve batch (torch.profiler, top 16 by device time); device "
          f"{dev_ms:.2f} ms of the {batch_ms:.1f} ms batch on the host clock: busy {100 * dev_ms / batch_ms:.0f}%")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=16))
    torch.cuda.empty_cache()
    return launches, dict(served=served, sources=sources, lift=lift, queries=queries)


# the exact retrieval tier as bench.py serves it (bench.py:616-694): the turbo
# full-corpus scan for a sticky 80% of users, the SANN rows for the rest
TIER_AVAILABILITY = 8000  # of 10,000: the decider's dial
TIER_R = 64  # the tier front's batch (bench.py:647)
TIER_QS = (64, 32, 16, 8, 4, 2, 1)  # every power-of-two scan shape the front's tier counts give
TIER_REQUESTS, TIER_CLIENTS = 256, 128
TIER_RESULTS = 200
TIER_BASE = 400  # bench.py's make_query(400 + i)
BRUTE_QUERIES = 4  # queries held against the float64 brute force
# the f32 scan against the float64 brute force: f32 sums of 32 products of
# normalized scores, and f32 norms
EXACT_RTOL, EXACT_ATOL = 1e-5, 1e-6
TURBO_RECALL = 0.99  # the JAX package's recall_target
# the live updates as bench.py drives them (bench.py:696-798)
LIVE_E = 256  # events a batch
LIVE_EPS = 6000.0  # the feeder's rate: the reference's ingest point
LIVE_CEILING = 8  # batches of the unthrottled ceiling
LIVE_R, LIVE_SERVE = 32, 4  # R=32 batches served while the feeder runs
LIVE_TARGET_FAVS = 8  # events a batch on the probe's top candidate
FOLD_RTOL = 1e-6  # folded aggregates, card against CPU: exp2 decays and f32 sums in another order
# the tweet-embedding state the updater folds (simclusters/tweet_embeddings.py prod defaults)
EMB_T = 1 << 17
INDEX_T = 16_384  # tweets of the index build held against the CPU


class RoutedExact(bf.ExactScanBatchSource):
    """The tier's exact source, recording the users it scans for."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.users = set()

    def dispatch(self, queries, params):
        self.users.update(int(q.user_id) for q in queries)
        return super().dispatch(queries, params)


def brute_force_cosine(tweet_ids, tweet_scores, q_ids, q_scores, k):
    """Exact cosine top-k over the whole corpus in float64 numpy: (rows [k],
    scores [k]) for one query."""
    q = np.zeros(int(tweet_ids.max()) + 1)
    np.add.at(q, q_ids, q_scores.astype(np.float64))
    q /= max(np.sqrt(np.sum(q * q)), 1e-9)
    s = tweet_scores.astype(np.float64)
    score = np.sum(q[tweet_ids] * s, axis=1) / np.maximum(np.sqrt(np.sum(s * s, axis=1)), 1e-9)
    top = np.argsort(-score, kind="stable")[:k]
    return top, score[top]


def scan_profile(scan, label):
    """A scan's device time (device_ms) and its top ops by device time."""
    ms = device_ms(scan, 3)
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        scan()
        torch.cuda.synchronize()
    print(f"exact_tier: {label}: device {ms:.2f} ms a scan; by op (torch.profiler, top 8 by device time):")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=8))
    return ms


def phase_exact_tier(world, sann, sann_recall, fy):
    """bench.py's exact-tier For You serving: the tiered SANN leg (the turbo
    full-corpus scan for the decider's users, the precomputed SANN rows for
    the rest) with the earlybird and UTEG legs, MaskNet bf16 and top-50,
    behind a 2-worker RequestBatcher. Returns the launches of one counted
    R=64 batch, and the Q=64 scans whose device time phase_new_path_times
    takes."""
    shape, tweet_ids, tweet_scores, _, q_ids, q_scores, index, _ = world
    dev = index.scores.device
    sann_ids, sann_scores = sann
    t0 = time.perf_counter()
    ti, tsc = (torch.from_numpy(a).to(dev) for a in sann_world.padded_corpus(tweet_ids, tweet_scores, EXACT_BLOCK))
    queries = SparseEmbedding(torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_scores).to(dev))
    torch.cuda.synchronize()
    print(f"exact_tier: corpus [{ti.shape[0]}, {ti.shape[1]}] on the card in {time.perf_counter() - t0:.1f} s "
          f"(set-up); {shape.Q} query embeddings")

    def scan(q, k, turbo, n=shape.Q):
        src = SparseEmbedding(q.ids[:n], q.scores[:n])
        return retrieval.exact_cosine_scan(
            ti, tsc, src, num_clusters=shape.C, max_results=k, block=EXACT_BLOCK,
            compute_dtype=torch.bfloat16 if turbo else torch.float32, approx_block_topk=turbo)

    # the f32 scan against a float64 brute force over the whole corpus
    rows, scores = (t.cpu().numpy() for t in scan(queries, TIER_RESULTS, False, BRUTE_QUERIES))
    t0 = time.perf_counter()
    want = [brute_force_cosine(tweet_ids, tweet_scores, q_ids[q], q_scores[q], TIER_RESULTS)
            for q in range(BRUTE_QUERIES)]
    moved = check_same_ranking(rows, scores, np.stack([w[0] for w in want]), np.stack([w[1] for w in want]),
                               EXACT_RTOL, EXACT_ATOL, "the f32 exact scan against the float64 brute force")
    print(f"exact_tier: f32 scan top-{TIER_RESULTS} of {BRUTE_QUERIES} queries equals a float64 numpy brute-force "
          f"cosine over all {tweet_ids.shape[0]} tweets ({moved} ranks hold another id, within near-ties; rtol "
          f"{EXACT_RTOL}, atol {EXACT_ATOL}; {time.perf_counter() - t0:.1f} s of numpy)")
    # the turbo scan's recall@100 against the f32 scan on every query
    truth = scan(queries, K_RECALL, False)[0].cpu().numpy()
    fast = scan(queries, K_RECALL, True)[0].cpu().numpy()
    tier_recall = sum(len(set(fast[q].tolist()) & set(truth[q].tolist())) for q in range(shape.Q)) / truth.size
    require(tier_recall >= TURBO_RECALL, f"turbo scan recall@{K_RECALL} {tier_recall} < {TURBO_RECALL}")

    served, lift, make = fy["served"], fy["lift"], fy["queries"]
    half = sann_ids.shape[0] // 2
    q_np = (q_ids.astype(np.int32), q_scores)

    def emb_fn(uid):
        r = uid % q_np[0].shape[0]
        return q_np[0][r], q_np[1][r]

    exact = RoutedExact(ti, tsc, emb_fn, num_clusters=shape.C, max_results=TIER_RESULTS, block=EXACT_BLOCK,
                        turbo=True)
    decider = Decider({bf.TieredSannBatchSource.FEATURE: TIER_AVAILABILITY})
    tiered = bf.TieredSannBatchSource(bf.PrecomputedBatchSource(sann_ids[:half], sann_scores[:half]), exact, decider)
    engine = bf.BatchedForYouEngine(batch_sources=[tiered] + fy["sources"][1:], scorer=served.scorer,
                                    head_names=masknet.DEFAULT_HEAD_NAMES, lift=lift)
    batch = make(TIER_R, base=TIER_BASE)
    require(all(len(o) > 0 for o in engine.serve_batch(batch)), f"an empty list at R={TIER_R}")
    for qn in TIER_QS:  # warm every scan shape
        exact.collect(exact.dispatch(batch[:qn], None))
    torch.cuda.synchronize()

    # the main path, counted: one R=64 batch
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    out = engine.serve_batch(batch)
    torch.cuda.synchronize()
    launches = {"run_collapse": seg_scan.run_collapse_sorted.launches, "row_gather": gather.row_gather.launches}
    print(f"exact_tier: launches per R={TIER_R} serve batch {launches} (hydration multiget and UTEG; the scan's "
          "gather is index_select)")
    require(launches == FY_LAUNCHES, f"exact-tier launches {launches}, want {FY_LAUNCHES}")
    require(len(out) == TIER_R and all(0 < len(o) <= FY_TOP_K for o in out), "a tier list empty or too long")
    in_tier = [decider.is_available_for_id(tiered.FEATURE, q.user_id) for q in batch]
    merged, _ = engine.columns(batch)
    sann_slot = engine.source_index[tiered.name]
    for c, t in zip(merged, in_tier):
        flag = np.asarray(c.cols.get("exact_tier", np.zeros(len(c))))
        from_sann = c.cols["source_idx"] == sann_slot
        require(bool((flag[from_sann] == (1.0 if t else 0.0)).all()) and not flag[~from_sann].any(),
                "an exact_tier column off its tier")
    print(f"exact_tier: R={TIER_R}: {sum(in_tier)} requests in the tier; every tier candidate carries exact_tier 1, "
          "no other candidate does")

    # host clock, before this phase's profiler sessions: the 2-worker front
    exact.users.clear()
    front = RequestBatcher(engine.serve_batch, BatcherConfig(max_batch_size=TIER_R, max_delay_ms=10.0), n_workers=2)
    users = [TIER_BASE + i for i in range(TIER_REQUESTS)]
    try:
        with ThreadPoolExecutor(TIER_CLIENTS) as pool:
            t0 = time.perf_counter()
            answers = list(pool.map(lambda u: front.serve(make(1, base=u)[0], timeout=300), users))
            front_s = time.perf_counter() - t0
    finally:
        front.close()
    require(len(answers) == TIER_REQUESTS and all(0 < len(a) <= FY_TOP_K for a in answers),
            "the tier front left a request empty")
    want_tier = {u for u in users if decider.is_available_for_id(tiered.FEATURE, u)}
    require(exact.users == want_tier, f"{len(exact.users)} users routed to the tier, the decider's {len(want_tier)}")
    p = TIER_AVAILABILITY / 10000
    print(f"exact_tier: 2-worker front (max batch {TIER_R}, 10 ms) answered {TIER_REQUESTS} requests from "
          f"{TIER_CLIENTS} clients, each a non-empty list, in {front_s:.2f} s ({TIER_REQUESTS / front_s:.1f} "
          f"requests/s; host clock, not a benchmark); {len(want_tier)} routed to the tier, as the host Decider "
          f"routes them (availability {p})")
    print(f"exact_tier: tier scan recall@{K_RECALL} {tier_recall:.4f} against the f32 scan over {shape.Q} queries "
          f"(at least {TURBO_RECALL}); blended retrieval recall {p * tier_recall + (1 - p) * sann_recall:.4f} "
          f"({p} x tier + {1 - p:.1f} x the SANN recall@{K_RECALL} {sann_recall:.4f})")

    # the per-request override
    outside = next(u for u in range(5000, 6000) if not decider.is_available_for_id(tiered.FEATURE, u))
    inside = next(u for u in range(5000, 6000) if decider.is_available_for_id(tiered.FEATURE, u))
    for u, forced in ((outside, True), (inside, False)):
        exact.users.clear()
        with param_scope({EXACT_RETRIEVAL_TIER: forced}):
            got = engine.serve_batch(make(1, base=u), Params())
        require(len(got[0]) > 0 and (u in exact.users) == forced,
                f"EXACT_RETRIEVAL_TIER={forced} did not route user {u}")
    print(f"exact_tier: EXACT_RETRIEVAL_TIER under param_scope routes user {outside} (out of the decider's tier) "
          f"into the tier, and user {inside} (in it) out")

    del exact, tiered, engine
    torch.cuda.empty_cache()
    # device times come last (phase_new_path_times): the scans at Q=64
    label = f"Q={TIER_R}, top-{TIER_RESULTS}, {ti.shape[0] // EXACT_BLOCK} blocks of {EXACT_BLOCK}"
    return launches, {f"f32 scan, {label}": lambda: scan(queries, TIER_RESULTS, False, TIER_R),
                      f"turbo (bf16) scan, {label}": lambda: scan(queries, TIER_RESULTS, True, TIER_R)}


def bench_events(rng, clock, target, target_author, num_users, num_authors):
    """bench.py's event batch (bench.py:716-732): users, tweets below 2¹⁵ and
    kinds drawn as there, the first LIVE_TARGET_FAVS on the target tweet."""
    users = rng.integers(0, num_users, LIVE_E)
    tweets = rng.integers(0, 1 << 15, LIVE_E).astype(np.int64)
    tweets[:LIVE_TARGET_FAVS] = target
    kinds = rng.choice(np.asarray(["fav", "retweet", "reply", "click"]), LIVE_E, p=[0.7, 0.1, 0.1, 0.1])
    return lu.batch_from_actions([
        (int(users[i]), int(tweets[i]), int(tweets[i] % num_authors) if tweets[i] != target else target_author,
         str(kinds[i]), clock) for i in range(LIVE_E)])


def stub_scorer(tables, resolvers):
    """What LiveUpdater needs of a scorer: its tables and the resolvers."""
    return SimpleNamespace(tables=tables, builder=SimpleNamespace(resolvers=resolvers))


def fold_card_against_cpu(tables, resolvers, batch):
    """One event batch folded into the card's tables and into a CPU copy:
    aggregates within FOLD_RTOL, timestamps, rings and history exact."""
    card = lu.LiveUpdater(stub_scorer(tables, copy.deepcopy(resolvers)))
    cpu = lu.LiveUpdater(stub_scorer(tables.to("cpu"), copy.deepcopy(resolvers)))
    require(card.apply(batch) == cpu.apply(batch), "the card and the CPU applied different counts")
    got, want = card.scorer.tables, cpu.scorer.tables
    require(torch.allclose(got.agg_packed.values.cpu(), want.agg_packed.values, rtol=FOLD_RTOL, atol=0),
            f"folded aggregates beyond rtol {FOLD_RTOL} of the CPU's")
    for name in ("uss_ids", "uss_ts", "eng_ids", "eng_type", "eng_ts", "eng_valid"):
        require(torch.equal(getattr(got, name).cpu(), getattr(want, name)), f"{name} differs from the CPU's")
    require(torch.equal(got.agg_packed.last_ts.cpu(), want.agg_packed.last_ts), "agg last_ts differs from the CPU's")
    return float((got.agg_packed.values.cpu() - want.agg_packed.values).abs().max())


def seeded_embedding_state(dev, C):
    """A [INDEX_T, 400] tweet table of dyadic scores over 2,048 of the C
    clusters, four decay times and fav counts around the minimum: exact
    (cluster, score) ties, cut at M inside them."""
    rng = np.random.default_rng(31)
    cfg = te.TweetEmbeddingConfig()
    ids = rng.integers(0, min(C, 2048), (INDEX_T, cfg.clusters_per_tweet)).astype(np.int32)
    scores = (rng.integers(1, 8, ids.shape) * 0.125).astype(np.float32)
    ids[:, 300:], scores[:, 300:] = PAD_ID, 0
    last = (foryou_world.NOW - 3600 * rng.integers(0, 4, INDEX_T)).astype(np.int32)
    favs = rng.integers(0, 2 * cfg.min_favorite_count, INDEX_T).astype(np.int32)
    created = np.full(INDEX_T, foryou_world.NOW - 7200, np.int32)
    author = rng.integers(0, 4096, INDEX_T).astype(np.int32)
    arrays = (ids, scores, last, favs, created, author)
    return te.TweetEmbeddingState(*(torch.from_numpy(a).to(dev) for a in arrays))


def phase_live_updates(dev, world, fy):
    """bench.py's live updates: event batches folded into the serving
    engine's tables while it serves; freshness in the next request; the card
    against the CPU; then an updater carrying a tweet-embedding state whose
    refreshed cluster index serves a SANN query. Returns the launches of
    the freshness request and that query, and the work whose device time
    phase_new_path_times takes."""
    shape, _, _, _, q_ids, q_scores, _, _ = world
    served, make = fy["served"], fy["queries"]
    scorer = served.scorer
    num_users, num_authors = FY_WORLD["num_users"], FY_WORLD["num_authors"]
    now = foryou_world.NOW
    updater = lu.LiveUpdater(scorer)
    rng = np.random.default_rng(23)
    probe = make(1, base=900)[0]
    target = served.serve_batch([probe])[0][0]  # the probe's top candidate
    target_author = int(target.features.get("author_id", 0) or 0)
    clock = [now]

    def next_batch():
        clock[0] += 1
        return bench_events(rng, clock[0], int(target.id), target_author, num_users, num_authors)

    batches = [next_batch() for _ in range(1 + LIVE_CEILING)]
    updater.apply(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:]:
        updater.apply(b)
    torch.cuda.synchronize()
    ceiling = LIVE_CEILING * LIVE_E / (time.perf_counter() - t0)

    stop, applied = threading.Event(), [0]

    def feeder():
        while not stop.is_set():
            t_b = time.perf_counter()
            updater.apply(next_batch())
            applied[0] += LIVE_E
            time.sleep(max(0.0, LIVE_E / LIVE_EPS - (time.perf_counter() - t_b)))

    qs = make(LIVE_R, base=700)
    served.serve_batch(qs)
    torch.cuda.synchronize()
    th = threading.Thread(target=feeder, daemon=True)
    th.start()
    t0 = time.perf_counter()
    try:
        for _ in range(LIVE_SERVE):
            served.serve_batch(qs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    finally:
        stop.set()
        th.join(timeout=60)
    require(not th.is_alive(), "the feeder thread did not stop")
    window = time.perf_counter() - t0
    print(f"live: unthrottled updater ceiling {ceiling:.1f} events/s over {LIVE_CEILING} batches of {LIVE_E}; "
          f"serving {LIVE_SERVE} R={LIVE_R} batches while a feeder applied {applied[0]} events at a target "
          f"{LIVE_EPS:.0f}/s: {LIVE_SERVE * LIVE_R / serve_s:.1f} requests/s, {applied[0] / window:.1f} events/s "
          "achieved (host clock, not a benchmark)")

    # freshness: the next request after the fav bursts, counted
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    after = served.serve_batch([probe])[0]
    torch.cuda.synchronize()
    launches = {"run_collapse": seg_scan.run_collapse_sorted.launches, "row_gather": gather.row_gather.launches}
    require(launches == FY_LAUNCHES, f"launches of the request after the updates {launches}, want {FY_LAUNCHES}")
    after_s = {c.id: c.score for c in after}.get(target.id)
    require(after_s is None or abs(after_s - target.score) > 1e-9,
            f"the fav bursts did not move tweet {target.id}'s score ({target.score} -> {after_s})")
    print(f"live: freshness: tweet {target.id}, the probe's top candidate, scored {target.score:.6g} before the "
          f"updates and {'%.6g' % after_s if after_s is not None else 'out of the top-50'} in the next request "
          f"(launches {launches})")

    # one seeded batch folded on the card and on the CPU
    t0 = time.perf_counter()
    err = fold_card_against_cpu(scorer.tables, scorer.builder.resolvers,
                                bench_events(np.random.default_rng(29), now + 100, int(target.id), target_author,
                                             num_users, num_authors))
    print(f"live: one seeded batch of {LIVE_E} events folded on the card equals the port on the CPU: aggregates "
          f"max |diff| {err:.3g} (rtol {FOLD_RTOL}), timestamps, USS rings and engagement history exact "
          f"({time.perf_counter() - t0:.1f} s with the CPU's fold)")

    # the tweet-embedding state: the same batches, favers' interests the SANN queries
    cfg = te.TweetEmbeddingConfig()
    tweets = np.arange(EMB_T)
    state = te.init_state(EMB_T, cfg.clusters_per_tweet, now - tweets % (40 * 3600), tweets % num_authors,
                          device=dev)
    interests = SparseEmbedding(torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_scores).to(dev))
    emb = lu.LiveUpdater(scorer, emb_state=state, user_interests=interests, emb_config=cfg, num_clusters=shape.C)
    for b in batches:
        emb.apply(b)
    refreshed = clock[0] + 1
    index = emb.refresh_index(refreshed)
    row = int(target.id) % EMB_T
    st = emb.emb_state
    require(int(st.fav_count[row]) >= cfg.min_favorite_count, f"tweet {target.id} has too few favs to be indexed")
    clusters = st.cluster_ids[row][st.cluster_ids[row] != PAD_ID].long()
    require(clusters.numel() > 0 and bool((index.tweet_ids[clusters] == row).any(dim=1).all()),
            f"the refreshed index leaves tweet {target.id} out of some of its clusters' rows")
    favers = np.unique(np.concatenate([b.user_ids[b.tweet_ids == target.id] for b in batches]) % q_ids.shape[0])
    contributed = np.unique(q_ids[favers, :cfg.clusters_per_user_contribution])
    require(bool(np.isin(clusters.cpu().numpy(), contributed).all()), "the tweet holds clusters no faver gave it")
    overlap = [np.isin(q_ids[u, :cfg.clusters_per_user_contribution], clusters.cpu().numpy()).sum() for u in favers]
    faver = int(favers[int(np.argmax(overlap))])
    print(f"live: refresh_index over [{EMB_T}, {cfg.clusters_per_tweet}] tweets -> [{shape.C}, "
          f"{cfg.tweets_per_cluster}]: tweet {target.id} ({int(st.fav_count[row])} favs from {len(favers)} favers) in "
          f"the rows of all {clusters.numel()} of its clusters")

    # a SANN query from one faver's interests over the refreshed index, counted
    ann_cfg = ann.SimClustersANNConfig(max_scan_clusters=shape.N, max_top_tweets_per_cluster=cfg.tweets_per_cluster,
                                       max_num_results=shape.X)
    src = SparseEmbedding(interests.ids[faver:faver + 1], interests.scores[faver:faver + 1])
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    ids, _ = ann.get_tweet_candidates_batch(index, src, ann_cfg)
    torch.cuda.synchronize()
    query_launches = {"run_collapse": seg_scan.run_collapse_sorted.launches,
                      "row_gather": gather.row_gather.launches}
    require(all(n > 0 for n in query_launches.values()), f"a kernel of the refreshed-index query never launched: "
            f"{query_launches}")
    require(row in ids[0].tolist(), f"faver {faver}'s SANN query over the refreshed index misses tweet {target.id}")
    launches = {k: launches[k] + query_launches[k] for k in launches}
    print(f"live: faver {faver}'s SANN query (N={shape.N}, M={cfg.tweets_per_cluster}) over the refreshed index "
          f"retrieves tweet {target.id} (row {row}); launches {query_launches}")

    # the index build on the card against the CPU, exact ties included
    tied = seeded_embedding_state(dev, shape.C)
    t0 = time.perf_counter()
    got = te.build_cluster_index(tied, shape.C, cfg, now)
    want = te.build_cluster_index(te.TweetEmbeddingState(*(t.cpu() for t in tied)), shape.C, cfg, now)
    moved = int((got.tweet_ids.cpu() != want.tweet_ids).sum())
    require(moved == 0 and torch.equal(got.timestamps.cpu(), want.timestamps),
            f"build_cluster_index on the card places other tweets than the CPU's in {moved} slots")
    require(torch.allclose(got.scores.cpu(), want.scores, rtol=FOLD_RTOL, atol=0),
            f"build_cluster_index scores beyond rtol {FOLD_RTOL} of the CPU's")
    err = float((got.scores.cpu() - want.scores).abs().max())
    print(f"live: build_cluster_index at T={INDEX_T} (dyadic scores, exact ties cut at M={cfg.tweets_per_cluster}) "
          f"on the card equals the CPU's: ids and timestamps exact, decayed scores max |diff| {err:.3g} (rtol "
          f"{FOLD_RTOL}; exp2 on each device) ({time.perf_counter() - t0:.1f} s with the CPU's build)")
    del got, want, tied

    torch.cuda.empty_cache()

    def kernels():  # the kernels at the refreshed-index query's shapes
        safe = gather.jax_rows(torch.where(src.valid_mask(), src.ids, 0), shape.C).reshape(-1).contiguous()
        time_gather(safe, tuple(index), f"refreshed-index row fetch, {safe.numel()} rows x 3 tables [{shape.C}, "
                    f"{cfg.tweets_per_cluster}]")
        rows = tuple(r.reshape(1, shape.N, -1) for r in gather.row_gather(safe, *index))
        time_collapse(retrieval.sort_by_id(*retrieval.scan_entries(*rows, src)),
                      "refreshed-index query's sorted entries")

    # device times come last (phase_new_path_times): a fold with and without
    # the embedding state, and a refresh
    steps = {f"one {LIVE_E}-event batch folded (aggregates, rings, history)": (lambda: updater.apply(batches[1]), 5),
             f"the same with the [{EMB_T}, {cfg.clusters_per_tweet}] tweet-embedding fold":
                 (lambda: emb.apply(batches[1]), 5),
             f"a refresh_index to [{shape.C}, {cfg.tweets_per_cluster}]": (lambda: emb.refresh_index(refreshed), 3)}
    return launches, {"kernels": kernels, "steps": steps}


def phase_new_path_times(tier, live):
    """The device times of the exact-tier and live-update paths: each scan
    with its ops, a fold and a refresh (their kernels; the uploads' copies
    left out), then the kernels at the refreshed-index query's shapes."""
    for label, scan in tier.items():
        scan_profile(scan, label)
    times = {label: device_ms(fn, reps, kernels_only=True) for label, (fn, reps) in live["steps"].items()}
    print("live: device time of " + "; ".join(f"{label} {ms:.3f} ms" for label, ms in times.items()))
    live["kernels"]()


def time_top_k(dev, Q, N, k, label):
    """retrieval.top_k (lax.top_k's order among ties) against torch.topk on
    seeded [Q, N] float32 rows with ties (values in steps of 1/64): the same
    values, both device times, and that of the other way to keep the order,
    a stable descending sort of the whole row (what top_k does up to
    SMALL_SORT slots)."""
    g = torch.Generator(device=dev).manual_seed(Q + N + k)
    x = torch.randint(0, 1 << 12, (Q, N), generator=g, device=dev).float() / 64
    values, idx = retrieval.top_k(x, k)
    _, sort_idx = torch.sort(x, dim=-1, descending=True, stable=True)
    require(torch.equal(values, torch.topk(x, k, dim=-1).values), f"top_k values differ from torch.topk's at {label}")
    require(torch.equal(idx, sort_idx[:, :k]), f"top_k indices differ from a stable sort's at {label}")
    # four sessions (timed_pair), not device_pair's one: top_k launches
    # torch.topk's own kernels, so kernel names cannot tell the two apart
    ms, plain_ms = timed_pair(lambda: retrieval.top_k(x, k), lambda: torch.topk(x, k, dim=-1), clock=device_ms)
    sort_ms = device_ms(lambda: torch.sort(x, dim=-1, descending=True, stable=True), 50)
    print(f"top_k: {label} [{Q}, {N}] k={k}: device {ms:.4f} ms in lax.top_k's order vs torch.topk {plain_ms:.4f} ms, "
          f"stable sort of the row {sort_ms:.4f} ms")


def phase_ranking(dev):
    base = dict(num_features=6000, num_heads=15, mask_blocks=4, block_dim=512,
                aggregation_dim=128, head_hidden=(256, 128))
    cfg16 = masknet.MaskNetConfig(**base, dtype="bfloat16")
    cfg32 = masknet.MaskNetConfig(**base, dtype="float32")
    ref = masknet.MaskNet(cfg32, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    weights = masknet.DEFAULT_HEAD_WEIGHTS

    def build(arrays):
        model = masknet.MaskNet(cfg16, device=dev)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in arrays.items()})
        return masknet.score_fn(model, weights)

    n_req, per_req = 4, 64
    x = np.random.default_rng(0).normal(size=(n_req * per_req, cfg32.num_features)).astype(np.float32)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        save_params_npz(os.path.join(root, "masknet", "1"),
                        {k: v.cpu().numpy() for k, v in ref.state_dict().items()})
        reg = ModelRegistry(root)
        reg.scan_once()
        srv = InferenceServer(reg, build, batcher_config=BatcherConfig(max_batch_size=256, max_delay_ms=5.0))
        srv.start()
        try:
            def post(i):
                body = json.dumps({"instances": x[i * per_req:(i + 1) * per_req].tolist()}).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/v1/models/masknet:predict", data=body,
                    headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as r:  # an HTTP error raises
                    require(r.status == 200, f"HTTP {r.status}")
                    preds = json.loads(r.read())["predictions"]
                return np.asarray(preds, np.float32), time.perf_counter() - t0

            with ThreadPoolExecutor(n_req) as pool:
                answers = list(pool.map(post, range(n_req)))
        finally:
            srv.close()

    preds = np.concatenate([a for a, _ in answers])
    want = masknet.score_fn(ref, weights)(x)
    require(preds.shape == (n_req * per_req,) and bool(np.isfinite(preds).all()), "bad predictions")
    np.testing.assert_allclose(preds, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    rel = float(np.max(np.abs(preds - want) / np.maximum(np.abs(want), 1e-30)))
    # the model itself, before the weighted sum squeezes it: bf16 logits against f32
    m16 = masknet.MaskNet(cfg16, device=dev)
    m16.load_state_dict(ref.state_dict())
    xt = torch.from_numpy(x).to(dev)
    with torch.inference_mode():
        logit_err = float((m16(xt) - ref(xt)).abs().max())
    require(logit_err <= LOGIT_ATOL, f"bf16 logits off by {logit_err}")
    print(f"ranking: {n_req} HTTP predicts x {per_req} instances -> 200, finite; served bf16 vs f32 "
          f"forward: max rel score err {rel:.3g} (rtol {SCORE_RTOL}, atol {SCORE_ATOL}), max |logit err| "
          f"{logit_err:.3g} (atol {LOGIT_ATOL}); request latency {max(t for _, t in answers):.2f} s max")


def main() -> int:
    dev = phase_device()
    phase_build()
    world = build_world(dev)
    sann_launches, sann_ids, sann_scores, sann_recall = phase_retrieval(*world)
    by_path = {"sann": sann_launches}
    cand_launches, cand_world = phase_candidates(dev)
    by_path.update(cand_launches)
    by_path["foryou"], fy = phase_foryou(dev, (sann_ids, sann_scores), cand_world)
    phase_candidate_kernels(dev, cand_world)
    kernels = phase_kernels(world[0], world[6], world[7])
    phase_gather_sweep(dev)
    phase_collapse_sweep(dev)
    phase_ranking(dev)
    by_path["exact_tier"], tier_scans = phase_exact_tier(world, (sann_ids, sann_scores), sann_recall, fy)
    by_path["live"], live_times = phase_live_updates(dev, world, fy)
    phase_new_path_times(tier_scans, live_times)
    sources = {
        "run_collapse": ("the_algorithm_tpu_torch/csrc/seg_scan.cu", "the_algorithm_tpu/ops/seg_scan.py:101"),
        "row_gather": ("the_algorithm_tpu_torch/csrc/gather.cu", "the_algorithm_tpu/ops/gather.py:55"),
    }
    print(f"profiler: {PROFILER['sessions']} device-time sessions, {PROFILER['again']} of them opened again after "
          f"one that saw too little; {PROFILER['short']} times taken over kernel events the profiler left out, most "
          f"often of {PROFILER['left_out'].most_common(3)}")
    # launches: the counted batches of every path together; the times are at the SANN shapes
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(n[name] for n in by_path.values()),
         "launches_by_path": {path: n[name] for path, n in by_path.items()}, **kernels[name]}
        for name, (src, rep) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
