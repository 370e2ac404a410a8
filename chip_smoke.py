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
5. kernels: each hand-written kernel against its plain PyTorch version on
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
6. ranking: a MaskNet at the flagship width (F=6000, 15 heads, G=4, D=512,
   A=128, trunk (256, 128)) from a seeded generator, saved as a registry
   version and served over HTTP in bf16; every answer is held against a
   direct f32 forward of the same weights.

Then one JSON line with each kernel's launches (in all, and by path: SANN,
UTEG, UTG), error and times, and, as the last line, ``{"ok": true, "device": {...}}``. Any failure raises, so the
script exits non-zero and prints no result; it needs no network.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType

from the_algorithm_tpu_torch import _build
from the_algorithm_tpu_torch.data import foryou_world, sann_world
from the_algorithm_tpu_torch.graph import graphjet, uteg
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.ops import gather, retrieval, seg_scan, sparse
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex, ScoringAlgorithm
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.search import earlybird
from the_algorithm_tpu_torch.serving.batcher import BatcherConfig
from the_algorithm_tpu_torch.serving.model_registry import ModelRegistry, save_params_npz
from the_algorithm_tpu_torch.serving.server import InferenceServer
from the_algorithm_tpu_torch.simclusters import ann
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


def device_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn`` in ms: the self device time of every
    kernel ``reps`` warm calls launch, from ``torch.profiler``, over ``reps``.
    Unlike :func:`cuda_ms` it leaves out the host's work between launches."""
    for _ in range(3):
        fn()
    # a session now and then records no device activity at all, or only part
    # of it (seen after some dozens of sessions in one process): every call
    # launches at least one kernel, so a session that saw fewer kernels than
    # calls is measured again
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in kernels)
        if us > 0 and sum(e.count for e in kernels) >= reps:
            return us / reps / 1000
    raise RuntimeError("chip_smoke: torch.profiler saw fewer kernels than calls in three sessions")


def timed_pair(kernel, plain, reps=50, clock=cuda_ms):
    """Plain, kernel, kernel, plain, so drift on the card splits evenly."""
    p1, k1, k2, p2 = clock(plain, reps), clock(kernel, reps), clock(kernel, reps), clock(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


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
    dev_ms, plain_dev_ms = timed_pair(kernel, plain, clock=device_ms)
    moved = 2 * ids.numel() * sum(t.shape[1] * t.element_size() for t in tables)  # rows read + written
    bound = bound_ms(moved)
    print(f"kernel row_gather: {label}, {moved / 1e6:.1f} MB moved, bit-exact; device "
          f"{dev_ms:.4f} ms ({moved / dev_ms / 1e9:.2f} TB/s, {100 * bound / dev_ms:.1f}% of its {bound:.4f} ms "
          f"bound) vs index_select {plain_dev_ms:.4f} ms ({moved / plain_dev_ms / 1e9:.2f} TB/s); events "
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
    dev_ms, plain_dev_ms = timed_pair(kernel, plain, clock=device_ms)
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
    return launches


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

    # the kernels at the shapes these paths give them, and on seeded rows
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
    return {name: launches[name] for name in ("uteg", "utg")}


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
    by_path = {"sann": phase_retrieval(*world)}
    by_path.update(phase_candidates(dev))
    kernels = phase_kernels(world[0], world[6], world[7])
    phase_gather_sweep(dev)
    phase_collapse_sweep(dev)
    phase_ranking(dev)
    sources = {
        "run_collapse": ("the_algorithm_tpu_torch/csrc/seg_scan.cu", "the_algorithm_tpu/ops/seg_scan.py:101"),
        "row_gather": ("the_algorithm_tpu_torch/csrc/gather.cu", "the_algorithm_tpu/ops/gather.py:55"),
    }
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
