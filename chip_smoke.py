#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line:

1. device: requires CUDA, prints ``nvidia-smi``'s name and power limit, pins
   f32 products to full f32 (no TF32);
2. build: compiles ``the_algorithm_tpu_torch/csrc/*.cu`` with nvcc (set-up);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the SANN batch gives it, with both times;
4. retrieval: SimClusters-ANN at the production shape (C=145,408 clusters,
   M=400, N=50, X=200, Q=256) on ``bench.py``'s seeded data rebuilt with
   numpy; the kernels' launch counts during that batch; oracle parity on 8
   queries; recall@100 against the exact full-corpus scan;
5. ranking: a MaskNet at the flagship width (F=6000, 15 heads, G=4, D=512,
   A=128, trunk (256, 128)) from a seeded generator, saved as a registry
   version and served over HTTP in bf16; every answer is held against a
   direct f32 forward of the same weights.

Then one JSON line with each kernel's launches, error and times, and, as the
last line, ``{"ok": true, "device": {...}}``. Any failure raises, so the
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

from the_algorithm_tpu_torch import _build
from the_algorithm_tpu_torch.data import sann_world
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.ops import gather, retrieval, seg_scan, sparse
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex, ScoringAlgorithm
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
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


def timed_pair(kernel, plain, reps=50):
    """Plain, kernel, kernel, plain, so drift on the card splits evenly."""
    p1, k1, k2, p2 = cuda_ms(plain, reps), cuda_ms(kernel, reps), cuda_ms(kernel, reps), cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


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


def phase_kernels(shape, index, sources):
    """Each kernel against its plain version on the inputs the SANN batch gives it."""
    src = sparse.truncate(sources, shape.N)
    safe = torch.where(src.valid_mask(), src.ids, 0).reshape(-1).contiguous()  # [Q·N] = 12,800
    tables = (index.tweet_ids, index.scores, index.timestamps)

    got = gather.row_gather(safe, *tables)
    want = gather.row_gather_plain(safe, *tables)
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)), "row_gather differs from index_select")
    gather_err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    g_ms, g_plain_ms = timed_pair(lambda: gather.row_gather(safe, *tables),
                                  lambda: gather.row_gather_plain(safe, *tables))
    print(f"kernel row_gather: {safe.shape[0]} rows x 3 tables [{shape.C}, {shape.M}] bit-exact; "
          f"{g_ms:.4f} ms vs index_select {g_plain_ms:.4f} ms")

    rows = tuple(r.reshape(shape.Q, shape.N, shape.M) for r in got)
    entries = retrieval.sort_by_id(*retrieval.scan_entries(*rows, src))  # sorted [Q, N·M]
    got = seg_scan.run_collapse_sorted(*entries)
    want = seg_scan.run_collapse_sorted_plain(*entries)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]), "run_collapse (row, id) slots differ from the plain version")
    require(all(torch.allclose(g, w, rtol=SUM_RTOL, atol=SUM_ATOL) for g, w in zip(got[1:], want[1:])),
            "run_collapse sums differ from the plain version")
    collapse_err = max(float((g - w).abs().max()) for g, w in zip(got[1:], want[1:]))
    n_runs = int((got[0] != PAD_ID).sum())
    c_ms, c_plain_ms = timed_pair(lambda: seg_scan.run_collapse_sorted(*entries),
                                  lambda: seg_scan.run_collapse_sorted_plain(*entries))
    print(f"kernel run_collapse: [{shape.Q}, {shape.N * shape.M}] k=2, {n_runs} runs, same (row, id) "
          f"slots, max |sum err| {collapse_err:.3g} (rtol {SUM_RTOL}, atol {SUM_ATOL}); "
          f"{c_ms:.4f} ms vs plain {c_plain_ms:.4f} ms")
    return {
        "run_collapse": dict(max_abs_err=collapse_err, ms=c_ms, plain_ms=c_plain_ms),
        "row_gather": dict(max_abs_err=gather_err, ms=g_ms, plain_ms=g_plain_ms),
    }


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
    print("retrieval profile, one batch (torch.profiler, top 10 by device time):")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=10))
    return launches


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
    kernels = phase_kernels(world[0], world[6], world[7])
    launches = phase_retrieval(*world)
    phase_ranking(dev)
    sources = {
        "run_collapse": ("the_algorithm_tpu_torch/csrc/seg_scan.cu", "the_algorithm_tpu/ops/seg_scan.py:101"),
        "row_gather": ("the_algorithm_tpu_torch/csrc/gather.cu", "the_algorithm_tpu/ops/gather.py:55"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         **kernels[name]}
        for name, (src, rep) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
