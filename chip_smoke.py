#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

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
8. training, in a child process on the same card (``chip_smoke.py
   --training`` runs it alone): bench.py's MaskNet train step (bench.py:266-328: F=6000, bf16,
   B=16,384, bf16 inputs, ``AdamBf16(1e-3)``) timed over loop-carried steps
   with CUDA events (examples/s), the loss finite and falling, peak memory
   and the step's device time by part from one profiler session; the f32
   model at B=256 on the card against the CPU (first gradients, params
   after 3 steps); the ``Trainer`` at full width on a seeded linear teacher
   (``fit`` with the prefetch feeder and the per-head AUC eval, auc_mean >
   0.75 within 200 steps; a bit-exact checkpoint round trip; the export
   served over HTTP in bf16 against the f32 forward); the light ranker's
   lifecycle (TRec shards → calibration → ``DataRecordTrainer`` with
   adagrad on the card → held-out AUC > 0.75 → export → HTTP serve equal to
   ``predict_proba``), its counted steps one row_gather and one
   run_collapse launch each, its weight gradient bit-equal run to run and
   equal to ``index_put_(accumulate=True)``, and both kernels against their
   plain versions at its shapes;
9. exact_tier: bench.py's exact-tier serving (bench.py:616-694) over the
   step-3 corpus padded to 2,031,616 rows and the step-5 engine: the f32
   full-corpus scan against a float64 numpy brute force on 4 queries, the
   turbo (bf16) scan's recall@100 against the f32 scan on all 256 queries;
   the tiered SANN leg (turbo scan for a sticky 80% of users, the SANN rows
   for the rest) warmed at R=64 and every scan Q, the launches of one
   counted R=64 batch, 256 requests from 128 clients through a 2-worker
   ``RequestBatcher`` (requests/s on the host clock), routing against the
   host ``Decider`` and under the ``EXACT_RETRIEVAL_TIER`` param, the
   ``exact_tier`` column;
10. live: bench.py's live updates (bench.py:696-798) into the step-5
   engine's tables: the updater's unthrottled ceiling, 4 R=32 batches served
   while a feeder applies 256-event batches at 6,000 events/s, the probe's
   top candidate's score moving in the next request (counted; the probe
   served with creation times below 1,000 s, where scores spread), one seeded
   batch folded on the card against the CPU; then an updater carrying a
   [131,072, 400] tweet-embedding state (user interests: the step-3 query
   embeddings) over the same batches, its refreshed [145,408, 1,600] index
   holding the target tweet in its clusters' rows and serving a faver's
   SANN query (counted); ``build_cluster_index`` at T=16,384 against the
   CPU;
11. the device time of an f32 and a bf16 scan at Q=64 by op, of a fold
    and of a refresh, and the kernels at the refreshed-index query's
    shapes. Steps 9-11 run last: on the card, the profiler sessions that
    follow their thousands of launches and copies miss many of the copy
    events a short session makes;
12. home_pipeline, after the main process's last profiler session of steps
    1-11 (its candidate pipelines launch kernels from the engine's pool
    threads, and the tweet-mixer phase's threaded launches left later
    sessions short), over step 5's world, sources and MaskNets: the
    per-request For You product. Run A: ``build_for_you_pipeline`` with the
    host columnar catalog (``build_wide_hydrators``: 34 hydrators, all 6,823
    columns) and the f32 MaskNet, the four batch sources each asked per
    request, 8 users with creation times below 1,000 s and a few seen ids,
    held to the f32 batched engine on the same queries (the JAX test's
    bounds) and each request's matrix to
    ``DeviceHydrationScorer.assemble_features`` family by family. Run B:
    the bf16 MaskNet, Phoenix at ``PhoenixConfig()``'s full width (bf16) with
    each user's 400-event history and its loop (store, rescoring hydrator,
    reranker, side effect), inside ``build_for_you_mixer`` with the FRS
    world's HOME_TIMELINE flow as its who-to-follow module
    (``data/frs_world.py``, built before this phase) and two ads,
    registered beside the Following product, each timeline marshalled to
    URT, the users served twice: no failure at any level, every served
    tweet with MaskNet's heads and Phoenix's features, a who-to-follow
    module holding the flow's own first five for its user, and ads in each
    timeline.
    Launches a request held exactly in both runs (1 run_collapse + 4
    row_gather; 6 + 13 with the flow's sources); bf16 against f32 on the card on the requests' own model
    inputs; the f32 product on the card against the port on the CPU (2
    users, both passes: ids but near-ties, every URT entry, scores rtol
    1e-5); the host-clock split a request (sources, hydration, MaskNet,
    Phoenix, the rest); the device's busy share; the new row_gather
    launches (the three keyed groups, Phoenix's ``author_emb``) against
    ``index_select``;
13. edge, after home_pipeline in the main process, over the For You world,
    engines and f32 MaskNet of step 5 and run B's product registry of step
    12: an ``InferenceServer`` with two timeline products, ``for_you`` (a
    ``BatchedTimelineFront`` over the serving engine, max batch 32, 10 ms)
    and ``for_you_mixer`` (run B's product); 64 concurrent
    ``POST /v1/timelines/for_you`` from 32 client threads, each answer
    byte-equal to the URT of its own recorded batch answer, at least one
    batch of more than one request, launches 1 run_collapse + 16 row_gather
    a recorded batch, the server's ``errors`` 0, requests/s and p50/p99
    beside step 5's 2-worker front; run B's 4 users twice through
    ``for_you_mixer``, each byte-equal to its recorded timeline's URT, 1 + 5
    launches a request, no ``failures`` and no mixer ``failed`` counter;
    4 x 16 of run A's host-catalog rows as segdense ``records`` (names and
    precomputed ids, densified bit for bit) and as ``instances`` through
    the f32 MaskNet in a ``ModelRegistry``, within rtol 1e-5 / atol 1e-6 of
    its direct forward; the native front (``serving_core.cc``) over the
    same model, 64 requests of 16 rows from 16 clients, coalesced, within
    the same bound, no HTTP error and no held exception, beside the JSON
    ``instances`` path for the same rows; warmup over the registry at
    buckets 1, 8, 64, 256, and a wrong-width spec failing closed; the
    aggregation catalog's 18 stores folded on the card and on the CPU
    (4,096 seeded events, rtol 1e-6, timestamps exact);
13b. products, after edge in the main process, over the For You, candidate
    and SANN worlds and the FRS world (16,384 users following 48 of 4,096
    authors, the follower adjacency, the sims graph built on the card, a UUG
    and a RealGraph table): the six FRS device sources called directly for
    32 users (launches as ``frs_world.SOURCE_LAUNCHES``, card against the
    port on the CPU, SALSA and triangular closure against float64 oracles
    for 4), the four display-location flows (non-empty, no followed,
    blocked or self id, launches as derived), the sims graph card against
    CPU; the T&S recipe (``train_kfold`` at ``RecipeConfig()`` over 4,096
    texts with a planted toxic band: 1 row_gather + 1 run_collapse_rows a
    step, JAX's AUC bounds, the first step's gradients against the CPU);
    the T&S text model on 256 texts (one empty) and the media model on 64
    224 x 224 images against the CPU; 64 push targets through
    ``PushPipeline`` (the earlybird and UTEG adaptors over the For You
    sources, each candidate's hydration row, the light ranker and ClemNet,
    the health gate over the trained text model, NTab and fatigue: every
    target a winner, none again 60 s later; rankers and gate against the
    CPU); both timeline-ranker forms for 16 users and TSPS for 256 SANN
    tweets against 1,024 topics against the CPU; 4,096 raw events through
    the UUA adapters, staged enrichment and the recos-injector into UTEG and
    RealGraph (a planted fav burst first of ``uteg.recommend``, 1 + 1; an
    injected follow among ``top_edges``); then the kernels at the new
    shapes (SALSA's [1, 1,048,576] collapse and 16,384 x 256 B second hop,
    the sims expansion's [1, 266,240] collapse, the T&S embedding's 8,192 x
    512 B gather and its gradient into [32,768, 128]);
13c. write_path, after products: tweetypie's ``TweetWriteService`` wired
    by ``ingester_fanout`` to an ``EarlybirdIngester`` at the For You
    index's 262,144 docs: 4,096 posts (roots, reply chains to depth 4,
    quotes, media), 64 edits, 64 deletes, 16 undeletes, 16 takedowns,
    16,384 UUA actions, 32 suspended authors, the index after each step
    equal column by column to the same events replayed through the port on
    the CPU; the posts again as one batch (both rates on the host clock);
    flush and load, a 256-post tail ingested while another thread serves
    Following timelines (each held against the CPU on the index version it
    read) and replayed onto the snapshot, ``roll_expired`` of half the docs,
    feature updates at B = 4,096; the Following product with edit chains
    and a reply-chain resolver (conversation modules, replace_entry
    instructions, URT equal to the CPU's), the masked search, one R=32 For
    You batch over the ingested index (1 + 16 launches, against the CPU),
    and fault 10 (a post whose id passes int32: recorded, index unchanged);
13d. offline_simclusters, after write_path, in a child process
    (``chip_smoke.py --offline-simclusters`` runs it alone, the FRS world
    built again from its seed): over a planted 16,384 x 4,096
    follow graph (64 communities) the sims graph, KnownFor (C=256, 6
    iterations: ids equal to the CPU's, recovery > 0.8), InterestedIn (top
    50) and producer embeddings; tweepcred over the FRS follow graph (the
    iteration count equal to the CPU's, the sum 1 within 1e-4); launches as
    derived; the k = 4 collapse against its plain version on the kernel
    tests' COLLAPSE_CASES, and the new collapse shapes timed;
13e. offline_simclusters_2, after that one, in a child process
    (``chip_smoke.py --offline-simclusters-2`` runs it alone): the
    cluster→tweet index job at bench.py's SANN widths (C=145,408, M=400,
    Kt=20, K=50) over ``sann_world.build_index_job_world`` (65,536 users,
    1,048,576 tweets, 524,288 events: T·C far past 2³¹, where JAX's int32
    keys wrap), held to the port on the CPU and its scores to float64 sums
    by key (rtol 1e-5; the cuts up to near-ties); RMS with that InterestedIn
    table behind a host cache and the SANN wrapper source over the generated
    index for 32 users twice (launches from the cache's misses; each list
    equal to ``ann.get_tweet_candidates`` on the RMS row; oracle parity ≥
    0.99, ids tied at the cut counted); 4,096 pairs through every pair
    algorithm and a blend, card against CPU, ``PairScoreStore`` and
    ``weighted_sum_score`` beside them; over PR 16's offline world
    ``evaluate_clusters``, ``top_eigenvectors`` (k=8, 50 iterations), the
    clustering methods over its 4,096 producer embeddings (256 of them card
    against CPU), entity embeddings from the job's events (entity = the
    tweet's community); the pair model to AUC > 0.8; brute force and IVF
    (262,144 x 128, 256 cells) under ``run_loadtest`` and HNSW on the host;
    launches as derived on every path; the new kernel shapes timed;
14. tweet_mixer, in a child process after the main process's last profiler
    session (``chip_smoke.py --tweet-mixer [dir]`` runs it alone, the SANN
    world loaded from the main process's saved files in ``dir`` or built
    from its seed): tweet-mixer's
    Home product (20 pipelines) at bench.py's sizes
    (``data/tweet_mixer_world.py``) over the step-3 SANN world and the
    step-4 candidate world, built there from the same seeds, and TwHIN and
    two-tower models (16,384 users x 2,000,000 items x 128) built on the
    card, the item table exported once (CUDA events); each pipeline called
    directly for 8 users (none may come back empty: run_product fails open),
    one counted request whose launches must equal the count from its routed
    pipelines, the five dense engines' top-200 for 4 users against a float64
    numpy brute force, Home for 2 users against the port on the CPU, serial
    requests and the 8-thread ``TweetMixer`` fan-out on the host clock; then
    one profiler session of 3 requests (each pipeline's device time) and
    both kernels against their plain versions at its per-query shapes
    (SANN: run_collapse [1, 20,000] k=2, row_gather 50 x 3 x 1,600 B;
    single 512-byte TwHIN rows; the UTEG family's seed rows and dedup at
    R=1, one per seed count; UTG's two hops and dedup at B=1), with no
    copy_ yardstick;
15. embedding_training, in a child process after the others
    (``chip_smoke.py --embedding-training`` runs it alone): the copy_
    yardstick at step 14's collapse shapes; small-width f32 two-tower and
    TwHIN models through the ``Trainer`` on the card against the CPU (first
    gradients, params after 3 steps); both models at tweet-mixer's widths
    (16,384 users x 2,000,000 items x 128 f32 tables) trained on
    ``data/tweet_mixer_world.py``'s planted engagements with B=4,096
    in-batch negatives and adam: one counted step each (a row_gather launch
    a table read, a D-wide ``run_collapse_rows`` launch a table gradient;
    required exactly), steps on CUDA events, the step's device time by part,
    hits@100 of the planted item over all 2M items for 1,024 users (at least
    0.5; TwHIN per relation); the D-wide collapse on each table gradient's
    own inputs (:func:`time_collapse_rows`: one launch a call, bit-equal run
    to run, against float64 sums, its plain version and
    ``index_put_(accumulate=True)``), with times; RealGraph's edge model
    (fit, ``top_edges``) and a WALS fit (``consumer_embedding``,
    ``similar_items``), each card against CPU; then the trained tables
    served through the Home dense engines of a world built as step 14's,
    the planted items in a served user's dense top-200s;
16. collapse_rows, in a child process after that one (``chip_smoke.py
    --collapse-rows`` runs it alone): ``run_collapse_rows``' run-length
    sweep at D=128 (4,096 slots into 6, 64, 4,096, 16,384, 65,536, 262,144
    and 2,000,000 rows; 100,000 into one row and into 1,000), each shape held
    as the path's inputs are, with device times against the bound, the plain
    version and ``index_put_``; from 16,384 rows up the kernel writing every
    row against ``torch.zeros`` and the kernel writing the touched rows;
    then, at the item- and user-table shapes, the kernel launched while
    another stream of the process keeps the card busy (its cooperative
    launch: the call finishes with a quiet run's bits);
17. mesh, in a child process after that one (``chip_smoke.py --mesh`` runs
    it alone, building the SANN world itself): one NCCL rank and a 1x1
    (data, model) mesh (``core/mesh.py``); bench.py's lookup
    (bench.py:331-393: a 16,000,000 x 128 f32 table, 16 iterations of
    65,536 ids) through ``multiget_all_to_all`` (rows bit-equal to
    ``index_select``, the sum within rtol 1e-6 of the bare gather's, rows/s,
    bytes/s, ``lookup_vs_bare_gather``, each iteration's kernel time); the
    hybrid, query-sharded and index-sharded SANN forms at Q=256 against the
    batch path (oracle parity on 8 queries, launches), ``fetch_cluster_rows``
    of 12,800 ids, ``sharded_queries_per_s``; ``ShardedServeEngine`` at the
    step-5 width against ``DeviceHydrationScorer`` (f32 scores, the bf16
    device selection, R=32, creation times below 1,000 s; the launches of a
    batch; requests/s); ``search_sharded`` (relevance, recency) on the
    262,144-doc index against ``search``; GFS's ``feature_block_sharded``
    against ``feature_block``; then four gloo ranks on this one card
    (``--mesh-rank``, each its own process): the hybrid form on a 2x2 mesh
    and the index-sharded form on a 1x4 mesh against the world-1 lists, a
    4-way multiget of 65,536 ids bit-equal to ``index_select``;
18. mesh_training, in a child process after that one (``chip_smoke.py
    --mesh-training`` runs it alone): one NCCL rank and a 1x1 mesh; two-tower
    and TwHIN with ``explicit_lookup`` at tweet-mixer's widths (16,384 x
    2,000,000 x 128, B=4,096, adam 1e-2) through the sharded ``Trainer``
    (the models' PARTITION_RULES) beside the one-device ``Trainer`` from the
    same init: one counted step (2 + 2 and 3 + 3 row_gather +
    run_collapse_rows, required exactly), the params after 3 steps within
    the Adam rule (bit-equal said so), a step on CUDA events beside the
    one-device step, the owner's row gather at the step's shape against
    ``index_select``, then 300 steps and hits@100 of the planted item over
    all 2M items (at least 0.5); bench.py's MaskNet step (F=6,000, bf16,
    B=16,384, AdamBf16(1e-3)) through the sharded ``Trainer`` with
    ``masknet.PARTITION_RULES`` against the one-device step; then four gloo
    ranks on this one card (``--mesh-training-rank``): the explicit
    two-tower on a 2x2 mesh (16,384 x 262,144 x 128, B=1,024), MaskNet
    (F=6,000, f32, B=1,024) on a 1x4 mesh, and the 4x1 local-batch contract,
    each rank's blocks and losses against the same runs at world 1; the
    two-tower's checkpoint after 2 steps on 2x2 restored on 1x4 and 4x1 (the
    ranks), on the 1x1 NCCL mesh and into a one-device Trainer (this
    process): every rank's params and Adam moments bit-equal to the saved
    global arrays' blocks (assembled from the saved files here), and the next
    step within the Adam rule of the run that never stopped;
19. phoenix_training, in a child process after that one (``chip_smoke.py
    --phoenix-training`` runs it alone): Phoenix at ``PhoenixConfig()``'s
    full width (bf16) serves 160 requests of 1,400 candidates through the
    Phoenix scorer (users with planted liked authors, histories aggregated
    from 400 raw events), the side effect logs them, ``training_batch`` joins
    the planted favs, and the one-device ``Trainer`` (adam 1e-3) trains on
    128 of them in batches of 32: one counted step (1 row_gather + 1
    run_collapse_rows, required exactly), the first step's f32 gradients on
    the card against the port on the CPU, the JAX round trip's bars (last
    loss below 0.7 x the first, engaged candidates' mean fav probability
    above the unengaged ones'), the preference AUC on 32 held-out requests
    (printed), a save restored into a fresh Trainer (the saved bits; two
    equal steps from it bit-equal), a step on CUDA events and by part, both
    kernels at the step's shapes; then the JAX package's AUC recipe at its
    own shape (AUC > 0.75);
20. phoenix_moonlight, in a child process after that one (``chip_smoke.py
    --phoenix-moonlight`` runs it alone): Moonlight-16B-A3B's routed layer
    at the Phoenix cell's batch (16,384 tokens, top-6 of 64 experts, D
    2,048, I 1,408, bf16): the grouped GEMM's two kernels and the combine
    against their plain versions (within a bf16 step of the result's
    scale), each kernel's device time against its bound, its plain
    version's and, for the pair, a loop of per-expert library products;
    then a small decoder-kind Phoenix (3 routed layers) forward, counted
    (one launch of each kernel a routed layer and one row_gather, required
    exactly), every routed layer's kernels held against the plain versions
    on that layer's own inputs.

Then one JSON line with each kernel's launches (in all, and by path: SANN,
UTEG, UTG, tweet-mixer's Home, For You, training, the exact tier, live
updates, the per-request For You product, the serving edge, the products
phase's FRS, push, trust & safety, timeline ranker and actions, the write
path, the offline jobs, the index job, RMS and the wrapper source, the
score facade, evaluation, entity embeddings, ann_lib, embedding training,
the mesh layer's serving and training halves, Phoenix training, Phoenix
on Moonlight's layers),
error and times, and, as the last line,
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero and prints no result; it needs no network.
"""

from __future__ import annotations

import copy
import dataclasses
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
from the_algorithm_tpu_torch.core import mesh as meshlib
from the_algorithm_tpu_torch.core.config import Params, param_scope
from the_algorithm_tpu_torch.core.decider import Decider
from the_algorithm_tpu_torch.data import foryou_world, frs_world, sann_world, tweet_mixer_world
from the_algorithm_tpu_torch.features import aggregation_configs as ac
from the_algorithm_tpu_torch.graph import graphjet, uteg
from the_algorithm_tpu_torch.core.metrics import StatsReceiver
from the_algorithm_tpu_torch.mixers import batched_foryou as bf
from the_algorithm_tpu_torch.mixers import feature_hydrators as fh
from the_algorithm_tpu_torch.mixers import frs_catalog as fc
from the_algorithm_tpu_torch.mixers import push_candidates as pc
from the_algorithm_tpu_torch.mixers import pushservice as pushsvc
from the_algorithm_tpu_torch.mixers import timeline_ranker as tlr
from the_algorithm_tpu_torch.mixers import topic_social_proof as tsps
from the_algorithm_tpu_torch.mixers import home_mixer as hm
from the_algorithm_tpu_torch.mixers import home_products as hp
from the_algorithm_tpu_torch.mixers import phoenix_loop as pl
from the_algorithm_tpu_torch.mixers import phoenix_scorer as ps
from the_algorithm_tpu_torch.mixers import candidate_pipeline_catalog as cat
from the_algorithm_tpu_torch.mixers import device_hydration as dh
from the_algorithm_tpu_torch.mixers import feature_schema as fs
from the_algorithm_tpu_torch.mixers import live_updates as lu
from the_algorithm_tpu_torch.mixers import tweet_mixer as tm
from the_algorithm_tpu_torch.mixers import tweet_mixer_products as tmp
from the_algorithm_tpu_torch.mixers import wide_hydrators as wh
from the_algorithm_tpu_torch.mixers.home_mixer import ForYouQuery
from the_algorithm_tpu_torch.mixers.home_products import EXACT_RETRIEVAL_TIER
from the_algorithm_tpu_torch.graph import realgraph
from the_algorithm_tpu_torch.models import masknet, phoenix, push_rankers, twhin, two_tower, wals
from the_algorithm_tpu_torch.models import moe_transformer
from the_algorithm_tpu_torch.models import trust_safety as ts
from the_algorithm_tpu_torch.models import trust_safety_train as tst
from the_algorithm_tpu_torch.ops import expert_gemm, gather, id_sort, retrieval, seg_scan, sparse
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex, ScoringAlgorithm
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.pipeline import urt
from the_algorithm_tpu_torch.pipeline.component import (Candidate, CandidatePipeline, CandidateSource,
                                                        QueryFeatureHydrator, Selector)
from the_algorithm_tpu_torch.pipeline.mixer import EntryKind
from the_algorithm_tpu_torch.search import earlybird
from the_algorithm_tpu_torch.search import root as search_root
from the_algorithm_tpu_torch.actions import enricher as en
from the_algorithm_tpu_torch.actions import recos_injector as ri
from the_algorithm_tpu_torch.actions import uua_adapters as ua
from the_algorithm_tpu_torch.simclusters import interested_in, known_for, producer_embeddings, sims_graph
from the_algorithm_tpu_torch.graph import tweepcred
from the_algorithm_tpu_torch.ops import segment
from the_algorithm_tpu_torch.search import ingester as ing
from the_algorithm_tpu_torch.search import persistence as pers
from the_algorithm_tpu_torch.storage import tweetypie
from the_algorithm_tpu_torch.serving import segdense as sd
from the_algorithm_tpu_torch.serving import warmup as wu
from the_algorithm_tpu_torch.serving.batcher import BatcherConfig, RequestBatcher
from the_algorithm_tpu_torch.serving.model_registry import ModelRegistry, save_params_npz
from the_algorithm_tpu_torch.serving.native_front import NativeClient, NativeFrontConfig, NativePredictFront
from the_algorithm_tpu_torch.serving.product_front import BatchedTimelineFront, default_timeline_builder
from the_algorithm_tpu_torch.serving.server import InferenceServer
from the_algorithm_tpu_torch.simclusters import ann
from the_algorithm_tpu_torch.simclusters import tweet_embeddings as te
from the_algorithm_tpu_torch import ann_lib
from the_algorithm_tpu_torch.ann_lib import hnsw
from the_algorithm_tpu_torch.features import representation_scorer as rsx
from the_algorithm_tpu_torch.simclusters import candidate_source as csrc
from the_algorithm_tpu_torch.simclusters import clustering, entity_embeddings, evaluation
from the_algorithm_tpu_torch.simclusters import index_generation as igen
from the_algorithm_tpu_torch.simclusters import representation_manager as rmgr
from the_algorithm_tpu_torch.simclusters import score_facade as sfac
from the_algorithm_tpu_torch.simclusters import tweet_similarity as tsim
from the_algorithm_tpu_torch.data import datarecord, synthetic
from the_algorithm_tpu_torch.models import light_ranker
from the_algorithm_tpu_torch.ops import hashed_lr
from the_algorithm_tpu_torch.serving.model_registry import load_params_npz
from the_algorithm_tpu_torch.training import data_record_trainer as drt
from the_algorithm_tpu_torch.training import metrics, optimizers
from the_algorithm_tpu_torch.training.trainer import Trainer, TrainerConfig, make_auc_per_head_eval, put_batch

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
# calls in a copy_ yardstick's session: late in a run the profiler on the card
# leaves 8-13 Memcpy events out of a short session (8 of 100, 8 and 13 of 150
# in three whole runs), so the session holds enough copies that they stay
# under 1 - MIN_SEEN of it
COPY_REPS = 200
# kernel events a session opened again should hold: the profiler leaves out
# about a dozen events of a session whatever its length (a 3-call refresh_index
# session of 162 kernels came up short five times running in a whole run), so
# a session that came up short is opened again with enough calls that those
# stay under 1 - MIN_SEEN of it
MIN_EVENTS = 500
# H100 SXM device memory rate (NVIDIA's data sheet): a kernel's bytes bound
HBM_BYTES_PER_S = 3.35e12
# the candidate sources as bench.py's For You phase runs them (bench.py:497-500)
CAND_R = 32  # users in a batch (bench.py's largest)
SORT_Q = 1024  # the benchmark cell's SANN batch (BENCHMARK.json: foryou.sann_q1024)
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


def more_calls(reps: int, kernels) -> int:
    """The calls for a session opened again after one of ``reps`` calls that
    saw ``kernels`` and came up short: enough for MIN_EVENTS kernel events
    (``reps`` again when that session saw none)."""
    events = sum(e.count for e in kernels)
    return max(reps, -(-reps * MIN_EVENTS // events)) if events else reps


def device_ms(fn, reps: int, kernels_only: bool = False) -> float:
    """Device time of one call of ``fn`` in ms, from ``torch.profiler``'s
    kernel events of ``reps`` warm calls (:func:`per_call_ms`). Unlike
    :func:`cuda_ms` it leaves out the host's work between launches.
    ``kernels_only`` leaves the copies and fills out too."""
    for _ in range(3):
        fn()
    tried = []
    for attempt in range(PROFILER_ATTEMPTS):  # a session that saw too little is measured again, a second later
        time.sleep(attempt and 1.0)
        PROFILER["again"] += attempt > 0
        kernels = [e for e in session_kernels([fn] * reps)
                   if not (kernels_only and e.key.startswith(("Memcpy", "Memset")))]
        ms = per_call_ms(kernels, reps)
        if ms is not None:
            return ms
        tried.append(f"{sum(e.count for e in kernels)} kernels of {reps} calls")
        reps = more_calls(reps, kernels)
    seen = Counter()
    for e in kernels:
        seen[e.key[:60]] += e.count
    raise RuntimeError(f"chip_smoke: torch.profiler saw too few kernels in {PROFILER_ATTEMPTS} sessions "
                       f"({', '.join(tried)}; after {PROFILER['sessions']} sessions); the last saw {dict(seen)}")


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
        mine, rest = [e for e in kernels if name in e.key], [e for e in kernels if name not in e.key]
        mine_ms, rest_ms = per_call_ms(mine, 2 * reps), per_call_ms(rest, 2 * reps)
        if mine_ms is not None and rest_ms is not None:
            return mine_ms, rest_ms
        reps = max(more_calls(reps, mine), more_calls(reps, rest))
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


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device():
    require(torch.cuda.is_available(), "no CUDA device: this script runs on an NVIDIA GPU")
    print(card_line())
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


def time_collapse(entries, label, copy_yardstick=True):
    """run_collapse against its plain version on the card: the same (row, id)
    slots, sums within SUM_RTOL / SUM_ATOL, both clocks, TB/s and the share
    of the bytes bound; with ``copy_yardstick``, the device time of ``copy_``
    moving the same bytes (its own profiler session)."""
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
    copy_ms = None
    if copy_yardstick:
        copies = [torch.empty_like(t) for t in entries]
        copy_ms = device_ms(lambda: [c.copy_(t) for c, t in zip(copies, entries)], COPY_REPS)
        del copies
    moved = 2 * sum(t.numel() * t.element_size() for t in entries)  # every slot read + written
    bound = bound_ms(moved)
    Q, W = entries[0].shape
    print(f"kernel run_collapse: {label} [{Q}, {W}] k={len(entries) - 1}, {n_runs} runs, {moved / 1e6:.2f} MB "
          f"moved, same (row, id) slots, max |sum err| {err:.3g} (rtol {SUM_RTOL}, atol {SUM_ATOL}); device "
          f"{dev_ms:.4f} ms ({moved / dev_ms / 1e9:.2f} TB/s, {100 * bound / dev_ms:.1f}% of its {bound:.4f} ms "
          f"bound) vs plain {plain_dev_ms:.4f} ms; events {ms:.4f} ms vs {plain_ms:.4f} ms; copy_ of the same "
          f"bytes {'not measured' if copy_ms is None else f'{copy_ms:.4f} ms'}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms, plain_device_ms=plain_dev_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None, copy_ms=copy_ms)


def time_sort(ids, values, label):
    """sort_by_id's kernel against its plain version, torch.sort(stable=True)
    and take_along_dim (the library call here too), on the card: one launch a
    call, ids and every value word equal, both clocks, TB/s and the share of
    the bytes bound (each slot's id and values read once and written once)."""
    before = _build.launches(id_sort.sort_by_id)
    got = id_sort.sort_by_id(ids, *values)
    torch.cuda.synchronize()
    require(_build.launches(id_sort.sort_by_id) == before + 1, f"sort_by_id: not one kernel launch at {label}")
    want = id_sort.sort_by_id_plain(ids, *values)
    require(torch.equal(got[0], want[0]) and all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                                                 for g, w in zip(got[1:], want[1:])),
            f"sort_by_id differs from torch.sort(stable=True) + take_along_dim at {label}")
    kernel = lambda: id_sort.sort_by_id(ids, *values)  # noqa: E731
    plain = lambda: id_sort.sort_by_id_plain(ids, *values)  # noqa: E731
    ms, plain_ms = timed_pair(kernel, plain)
    dev_ms, plain_dev_ms = device_pair(kernel, plain, "id_sort")
    moved = 2 * sum(t.numel() * t.element_size() for t in (ids, *values))
    bound = bound_ms(moved)
    (Q, W), k = ids.shape, len(values)
    print(f"kernel sort_by_id: {label} [{Q}, {W}] k={k}, {moved / 1e6:.2f} MB moved, bit-equal to the stable sort; "
          f"device {dev_ms:.4f} ms ({moved / dev_ms / 1e9:.2f} TB/s, {100 * bound / dev_ms:.1f}% of its {bound:.4f} ms "
          f"bound) vs torch.sort + take_along_dim {plain_dev_ms:.4f} ms; events {ms:.4f} ms vs {plain_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, device_ms=dev_ms, plain_device_ms=plain_dev_ms, bound_ms=bound,
                bound_by="bytes", library_ms=plain_dev_ms)


def phase_sort_kernel(shape, index, sources, cand):
    """The dedup's sort at each caller's shape whose rows the kernel takes:
    SANN's entries at the benchmark cell's Q = 1,024 (the batch's rows four
    times) and at Q = 256 (as the sharded merge's at world 1), one row (a
    Home or wrapper-source query), UTEG's and UTG's batches, and single rows
    of the Home UTEG and UTG widths. Returns the Q = 1,024 timing."""
    src = sparse.truncate(sources, shape.N)
    safe = torch.where(src.valid_mask(), src.ids, 0).reshape(-1).contiguous()
    rows = tuple(r.reshape(shape.Q, shape.N, shape.M)
                 for r in gather.row_gather(safe, index.tweet_ids, index.scores, index.timestamps))
    entries = retrieval.scan_entries(*rows, src)  # [Q, N·M] each, unsorted
    wide = tuple(torch.cat([e] * (SORT_Q // shape.Q)).contiguous() for e in entries)
    timed = time_sort(wide[0], wide[1:], f"SANN entries x{SORT_Q // shape.Q}")
    time_sort(entries[0], entries[1:], "SANN batch's entries")
    time_sort(entries[0][:1].contiguous(), tuple(e[:1].contiguous() for e in entries[1:]), "one SANN query's entries")
    world, _, graph, right = cand
    s = world.shape
    seeds = torch.from_numpy(world.seeds[np.arange(CAND_R) % s.num_users]).to(index.scores.device)
    uteg_entries = uteg.engagement_entries(graph, seeds, torch.ones(seeds.shape, device=seeds.device))
    time_sort(uteg_entries[0], uteg_entries[1:], "UTEG batch's entries")
    flat, ones, _ = graphjet.cooccurrence_entries(graph, right, torch.from_numpy(world.utg_sources).to(seeds.device))
    time_sort(flat, (ones,), "UTG batch's entries")
    for W, k in ((512, 2), (1536, 2), (2048, 2), (4096, 1)):  # Home's UTEG family and UTG at R = 1
        row = flat[:1, :W].contiguous()
        time_sort(row, (ones[:1, :W].contiguous(),) * k, "one UTG row's first entries")
    torch.cuda.empty_cache()
    return timed


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


# run_collapse_rows' run-length sweep at D=128: (n slots, N rows, draw). 4,096
# slots (a B=4,096 training step) into TwHIN's 6-row relation table (runs of
# ~680), 64 rows, and a 4,096-row, a 16,384-row user and a 2,000,000-row item
# table (distinct ids where N >= n); 100,000 slots into one row (one run over
# every resident CTA) and into 1,000 rows at random (runs of ~100)
ROWS_SWEEP = [(4096, 6, "uniform"), (4096, 64, "uniform"), (4096, 4096, "distinct"), (4096, 16_384, "distinct"),
              (4096, 65_536, "distinct"), (4096, 262_144, "distinct"), (4096, 2_000_000, "distinct"),
              (100_000, 1, "uniform"), (100_000, 1000, "uniform")]
ROWS_D = 128


def phase_collapse_rows_sweep(dev):
    """run_collapse_rows at each ROWS_SWEEP shape on seeded ids and dy rows
    (standard normal, as gradients of both signs) through
    :func:`time_collapse_rows`; at the tables of 16,384 rows and more also
    the zero fill by ``torch.zeros`` with the kernel writing only the
    touched rows against the kernel's own zeros, in device time: the
    measurement behind ``seg_scan.FILL_BYTES``. Run in a child process
    (``chip_smoke.py --collapse-rows``): its ~30 profiler sessions would
    shorten the main process's later ones."""
    g = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for n, N, draw in ROWS_SWEEP:
        if draw == "distinct":
            ids = torch.randperm(N, generator=g, device=dev)[:n].int()
        else:
            ids = torch.randint(0, N, (n,), generator=g, device=dev, dtype=torch.int32)
        ids, perm = torch.sort(ids, stable=True)
        dy = torch.randn((n, ROWS_D), generator=g, device=dev)
        label = f"sweep {n} slots into [{N}, {ROWS_D}] ({draw})"
        out[label] = time_collapse_rows(ids, perm, dy, N, label, hold_to_plain=False)
        if N >= 16_384:  # the kernel writing every row against torch.zeros + the touched rows
            kernel = lambda: seg_scan.run_collapse_rows(ids, perm, dy, N)  # noqa: E731
            chosen, times, results = seg_scan.FILL_BYTES, {}, {}
            try:
                for fill in (None, 0, 0, None):
                    seg_scan.FILL_BYTES = fill
                    results[fill] = kernel()
                    times.setdefault(fill, []).append(device_ms(kernel, 50))
            finally:
                seg_scan.FILL_BYTES = chosen
            torch.cuda.synchronize()
            require(torch.equal(results[None], results[0]),
                    f"run_collapse_rows after a torch.zeros fill differs at {label}")
            print(f"kernel run_collapse_rows: {label}: device {sum(times[None]) / 2:.4f} ms writing every row, "
                  f"{sum(times[0]) / 2:.4f} ms as torch.zeros + the touched rows (bit-equal; each the mean of two, "
                  f"in turns); the plan fills above {chosen} bytes: "
                  f"{'fill' if seg_scan._rows_plan(n, N, ROWS_D, 1).fill else 'every row'} here")
            del results
        del ids, perm, dy
        torch.cuda.empty_cache()
    collapse_rows_beside_a_busy_stream(dev)
    return {label: {k: r[k] for k in ("device_ms", "cold_device_ms", "bound_ms", "plain_device_ms",
                                      "library_device_ms")}
            for label, r in out.items()}


def busy_stream(dev, ms: float = 50.0):
    """Another stream of this process kept busy with f32 products over every
    SM for about ``ms``; returns it and its work (kept alive)."""
    side = torch.cuda.Stream(dev)
    a = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize()
    work = []
    with torch.cuda.stream(side):
        for _ in range(max(1, int(ms / 2))):  # ~2 ms a 4,096³ f32 product on an H100
            work.append(a @ a)
    return side, work


def collapse_rows_beside_a_busy_stream(dev):
    """Fault 6: run_collapse_rows' CTAs wait on earlier CTAs' flags, so its
    grid must be resident at once; the cooperative launch guarantees it. At
    the item- and user-table shapes, launched while another stream of the
    process keeps the card busy, the call finishes with a quiet run's bits."""
    g = torch.Generator(device=dev).manual_seed(19)
    for N in (2_000_000, 16_384):
        ids, perm = torch.sort(torch.randperm(N, generator=g, device=dev)[:4096].int(), stable=True)
        dy = torch.randn((4096, ROWS_D), generator=g, device=dev)
        quiet = seg_scan.run_collapse_rows(ids, perm, dy, N)
        torch.cuda.synchronize()
        side, work = busy_stream(dev)
        t0 = time.perf_counter()
        busy = seg_scan.run_collapse_rows(ids, perm, dy, N)
        still = not side.query()
        torch.cuda.synchronize()
        require(torch.equal(busy.view(torch.int32), quiet.view(torch.int32)),
                f"run_collapse_rows beside a busy stream differs at [{N}, {ROWS_D}]")
        print(f"kernel run_collapse_rows: 4096 slots into [{N}, {ROWS_D}] launched cooperatively while another stream "
              f"{'was still busy' if still else 'had finished'} ({len(work)} 4,096³ products): finished in "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms of host clock with a quiet run's bits")
        del work, quiet, busy


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
    # the main path, counted: one batch through the three kernels
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    id_sort.sort_by_id.launches = 0
    out_ids, out_scores = ann.get_tweet_candidates_batch(index, sources, cfg)
    torch.cuda.synchronize()
    launches = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                "row_gather": _build.launches(gather.row_gather),
                "sort_by_id": _build.launches(id_sort.sort_by_id)}
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
        id_sort.sort_by_id.launches = 0
        outs[name] = fn()
        torch.cuda.synchronize()
        launches[name] = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                          "row_gather": _build.launches(gather.row_gather),
                          "sort_by_id": _build.launches(id_sort.sort_by_id)}
    print(f"candidates: launches per batch {launches}")
    # the dedup's sort is the kernel wherever its rule takes the batch's shape
    sorts = {name: int(id_sort.engages(dev.type, q, w, k))
             for name, q, w, k in (("uteg", CAND_R, s.seeds * s.uteg_width, 2),
                                   ("utg", s.utg_sources, s.utg_width * s.uteg_width, 1))}
    require(launches["uteg"] == {"run_collapse": 1, "row_gather": 1, "sort_by_id": sorts["uteg"]},
            f"UTEG launches {launches['uteg']}")
    require(launches["utg"] == {"run_collapse": 1, "row_gather": 2, "sort_by_id": sorts["utg"]},
            f"UTG launches {launches['utg']}")

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


def pct(xs, q):
    """The ``q`` quantile of ``xs``: the value at rank ceil(q (n - 1))."""
    xs = np.sort(xs)
    return float(xs[min(len(xs) - 1, int(np.ceil(q * (len(xs) - 1))))])


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
    launches = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                "row_gather": _build.launches(gather.row_gather)}
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
    front_lat = []

    def ask(i):
        t0a = time.perf_counter()
        out = front.serve(queries(1, base=300 + i)[0], timeout=300)
        front_lat.append(1e3 * (time.perf_counter() - t0a))
        return out

    try:
        with ThreadPoolExecutor(FY_FRONT) as pool:
            t0f = time.perf_counter()
            answers = list(pool.map(ask, range(FY_FRONT)))
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
    front_rate = (FY_FRONT / front_s, pct(front_lat, 0.5), pct(front_lat, 0.99))
    print(f"foryou: 2-worker front (max batch {FY_R}, 10 ms) answered {FY_FRONT} concurrent requests, each a "
          f"non-empty list, in {front_s:.2f} s ({front_rate[0]:.1f} requests/s, p50 {front_rate[1]:.1f} ms, p99 "
          f"{front_rate[2]:.1f} ms; batches of {sizes})")

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
    # the live phase's freshness probe: the serving engine with small creation times
    probe = engine(served.scorer, lift=spread_lift(lift), max_age_s=10 ** 9)
    return launches, dict(served=served, sources=sources, lift=lift, queries=queries, probe=probe, world=world,
                          spread=spread, ref=ref, m16=m16, follows=follows, index=index, front_rate=front_rate,
                          host_select=host_select, make_scorer=scorer, tables=tables, cfg32=cfg32)


# the per-request For You product (home_pipeline): the JAX package's product
# surface, home_mixer.build_for_you_pipeline → home_products.build_for_you_mixer
# → urt.marshal_timeline, over the For You phase's world, sources and models
HP_USERS = 8  # users served; run B serves them twice (the second pass reads the Phoenix loop's store)
HP_BASE = 600  # their ids
HP_SEEN = 3  # seen ids a query carries: its user's first SANN ids (the seen filter has work)
HP_CPU = 2  # users whose f32 product (both passes) is held against the port on the CPU
HP_EVENTS = 400  # raw Phoenix action events a user: after aggregation the history fills all 256 slots
HP_SEED = 13
# kernel launches of one request, from the code: UTEG's seed fetch and dedup
# (1 row_gather + 1 run_collapse; earlybird and the SANN rows launch none);
# the hydrator catalog's keyed tables, one multiget a key group (viewer,
# author, tweet: three 16-byte-row tables each, one launch each); run B adds
# Phoenix's author_emb read (history and candidates in one launch)
HP_LAUNCHES_A = {"run_collapse": 1, "row_gather": 4}
HP_WTF = frs_world.flow_launches(fc.DisplayLocation.HOME_TIMELINE)  # the who-to-follow flow's sources: 5 + 8
HP_LAUNCHES_B = {"run_collapse": 1 + HP_WTF["run_collapse"], "row_gather": 5 + HP_WTF["row_gather"]}
HP_WTF_ITEMS = 5  # the For You mixer's cap on a who-to-follow module (DropMaxModuleItemCandidates(5))
# run A against the batched engine: the JAX test's bounds
# (tests/test_batched_foryou.py:147-157): each shared id's score within 1e-5,
# ranks apart only among scores within 2e-6
HP_PAIR_TOL, HP_TIE_TOL = 1e-5, 2e-6
# the host catalog's matrix against the device assembly, family by family:
# the JAX test's bound (tests/test_device_hydration.py:93-103)
HP_ASSEMBLE_TOL = 2e-3
# bf16 against f32 on the card, on the inputs the served requests gave the
# models: MaskNet's head probabilities move by at most a quarter of its
# logits' LOGIT_ATOL (a sigmoid's slope is at most 1/4); Phoenix's by 3e-2:
# its logits ride a bf16 residual stream through 4 blocks and the
# cross-attention (about 20 roundings of 2^-8 relative on values of a few
# units: up to ~0.1 on a logit), times the same 1/4
HP_HEAD_ATOL = LOGIT_ATOL / 4
HP_PHOENIX_ATOL = 3e-2
HP_ADS = ((7_000_001, 55), (7_000_002, 56))  # (ad id, advertiser)


class StepClock:
    """Per-request host-clock split of the product, in ms: each wrapped
    component adds its time to its step; the caller opens and closes a
    request."""

    STEPS = ("sources", "hydration", "MaskNet", "Phoenix")

    def __init__(self):
        self.rows, self.cur, self.mark = [], None, 0.0

    def begin(self):
        self.cur, self.t0 = dict.fromkeys(self.STEPS, 0.0), time.perf_counter()

    def end(self):
        self.cur["total"] = 1e3 * (time.perf_counter() - self.t0)
        self.rows.append(self.cur)
        self.cur = None

    def add(self, step, t0):
        if self.cur is not None:  # a request outside begin/end is not timed
            self.cur[step] += 1e3 * (time.perf_counter() - t0)

    def summary(self, rest: str) -> str:
        cols = {s: [r[s] for r in self.rows] for s in self.STEPS}
        cols[rest] = [r["total"] - sum(r[s] for s in self.STEPS) for r in self.rows]
        cols["total"] = [r["total"] for r in self.rows]
        return ", ".join(f"{s} p50 {pct(v, 0.5):.1f} / p99 {pct(v, 0.99):.1f} ms" for s, v in cols.items())


class Timed:
    """A hydrator, query hydrator or scorer whose calls add to a step of a
    :class:`StepClock` (the engine only calls ``name`` and the method)."""

    def __init__(self, inner, clock, step):
        self.inner, self.clock, self.step = inner, clock, step

    @property
    def name(self):
        return self.inner.name

    def hydrate(self, *args):
        t0 = time.perf_counter()
        try:
            return self.inner.hydrate(*args)
        finally:
            self.clock.add(self.step, t0)

    def score(self, *args):
        t0 = time.perf_counter()
        try:
            return self.inner.score(*args)
        finally:
            self.clock.add(self.step, t0)


class SourcesStart(QueryFeatureHydrator):
    """The last query hydrator: marks where the candidate pipelines start."""

    def __init__(self, clock):
        self.clock = clock

    def hydrate(self, query, params):
        self.clock.mark = time.perf_counter()
        return {}


class SourcesDone(Selector):
    """The first post-candidate selector: the candidate pipelines' wall time."""

    def __init__(self, clock):
        self.clock = clock

    def select(self, query, candidates, params):
        self.clock.add("sources", self.clock.mark)
        return candidates


class PerRequestSource(CandidateSource):
    """A batch source asked for one query, as the JAX package's test wraps
    one (tests/test_batched_foryou.py:89-106): ``get_batch([query])[0]``,
    lifted, as Candidates; with the in-network flag the engine sets at
    retrieval (batched_foryou.py:194-195), which that wrapper leaves out.
    ``record`` keeps each answer for :class:`ReplaySource`."""

    def __init__(self, batch_source, lift, record=None):
        self.bs, self.lift, self.record = batch_source, lift, record

    @property
    def name(self):
        return self.bs.name

    def get(self, query, params):
        cc = self.bs.get_batch([query], params)[0]
        if self.bs.name in ("EarlybirdInNetwork", "FollowingEarlybird"):
            cc.cols["is_in_network"] = np.ones(len(cc), np.float32)
        cc = self.lift(cc)
        cols = {n: np.asarray(v).tolist() for n, v in cc.cols.items()}
        out = [Candidate(id=int(t), source=self.bs.name, features={n: v[i] for n, v in cols.items()})
               for i, t in enumerate(cc.ids.tolist())]
        if self.record is not None:
            self.record[(self.bs.name, int(query.user_id))] = [(c.id, dict(c.features)) for c in out]
        return out


class ReplaySource(CandidateSource):
    """What a :class:`PerRequestSource` answered for a user, as new Candidates."""

    def __init__(self, name, record):
        self._name, self.record = name, record

    @property
    def name(self):
        return self._name

    def get(self, query, params):
        return [Candidate(id=i, source=self._name, features=dict(f))
                for i, f in self.record[(self._name, int(query.user_id))]]


class CheckedPipeline:
    """The scored pipeline behind the mixer, its results kept:
    ``ScoredTweetsSource`` passes on only the candidates, and a failure the
    pipeline fails open on (a hydrator, a scorer) would not show."""

    def __init__(self, pipe):
        self.pipe, self.results = pipe, []

    def run(self, query, params=None):
        result = self.pipe.run(query, params if params is not None else Params())
        self.results.append(result)
        return result


class PhoenixScored(ps.PhoenixScorer):
    """The Phoenix scorer, keeping each request's scored ids (the first
    ``MAX_CANDIDATES`` of a request with a history)."""

    def __init__(self, predict_fn):
        super().__init__(predict_fn)
        self.scored = []

    def score(self, query, candidates, params):
        self.scored.append(frozenset(c.id for c in candidates[:ps.MAX_CANDIDATES]) if self.only_if(query)
                           else frozenset())
        super().score(query, candidates, params)


def recording(fn, sink, limit):
    """``fn``, keeping its first ``limit`` calls' arguments in ``sink``."""
    def call(*args):
        if len(sink) < limit:
            sink.append(args)
        return fn(*args)
    return call


def hp_events(user_id):
    """A user's raw Phoenix action events, (ts_ms, action id, author hash):
    HP_EVENTS over the last 7 days, the 22 actions after PAD, the world's
    authors, drawn with numpy from (HP_SEED, user)."""
    rng = np.random.default_rng([HP_SEED, int(user_id)])
    ts = foryou_world.NOW * 1000 - rng.integers(0, 7 * 86400 * 1000, HP_EVENTS)
    return list(zip(ts.tolist(), rng.integers(1, phoenix.NUM_ACTIONS, HP_EVENTS).tolist(),
                    rng.integers(0, FY_WORLD["num_authors"], HP_EVENTS).tolist()))


def to_cpu(x):
    """The world on the CPU: tensors copied, named tuples, tuples and dicts
    mapped; a closure's results copied as it returns them."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_cpu(v) for v in x))
    if isinstance(x, tuple):
        return tuple(to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if callable(x) and not isinstance(x, type):
        return lambda *a, _f=x: to_cpu(_f(*a))
    return x


def home_queries(fy):
    """HP_USERS For You queries, each with HP_SEEN of its SANN ids as seen,
    and the follow and block sets the who-to-follow flow reads (the FRS
    world's request for that user)."""
    sann = fy["sources"][0]
    out = []
    for u in range(HP_BASE, HP_BASE + HP_USERS):
        q = ForYouQuery(user_id=u, followed_authors=fy["follows"][u % len(fy["follows"])], max_results=FY_TOP_K,
                        now=foryou_world.NOW)
        q.seen_tweet_ids = frozenset(sann.get_batch([q], None)[0].ids[:HP_SEEN].tolist())
        r = fy["frs"].request(u)
        q.followed_set, q.blocked_set = r.followed_set, r.blocked_set
        out.append(q)
    return out


def fresh(q):
    """A copy of query ``q`` with empty features (a request's own store),
    keeping the attributes set on it beyond its fields."""
    out = dataclasses.replace(q, features={})
    names = {f.name for f in dataclasses.fields(q)}
    out.__dict__.update({k: v for k, v in vars(q).items() if k not in names})
    return out


def home_pipeline(world, sources, predict, clock, phoenix_predict=None, store=None, device=None):
    """``build_for_you_pipeline`` over the wide catalog of ``world``
    (WIDE_SCHEMA), MaskNet's ``predict``, ``sources`` (candidate sources),
    with Phoenix and its loop when given ``phoenix_predict`` and ``store``;
    the age filter opened for creation times below SPREAD_TS. Returns the
    pipeline and its Phoenix scorer (None without)."""
    phx = None
    kw = {}
    if phoenix_predict is not None:
        phx = PhoenixScored(phoenix_predict)
        actions = fh.UserActionsQueryHydrator(hp_events, max_length=phoenix.PhoenixConfig().max_history,
                                              device=device)
        kw = dict(query_hydrators=[Timed(actions, clock, "Phoenix")], phoenix_scorer=phx,
                  phoenix_rescoring_store=store)
    pipe = hm.build_for_you_pipeline(
        candidate_pipelines=[CandidatePipeline(s) for s in sources],
        hydrators=[Timed(h, clock, "hydration") for h in wh.build_wide_hydrators(**world)],
        predict_fn=predict, feature_schema=fs.WIDE_SCHEMA, max_tweet_age_s=10 ** 9, **kw)
    pipe.query_hydrators_phase2.append(SourcesStart(clock))
    pipe.post_candidate_selectors.insert(0, SourcesDone(clock))
    pipe.scorers = [Timed(s, clock, "MaskNet" if i == 0 else "Phoenix") for i, s in enumerate(pipe.scorers)]
    return pipe, phx


def wtf_flow(frs):
    """The FRS world's HOME_TIMELINE flow: the who-to-follow module's."""
    return frs.catalog().flow(fc.DisplayLocation.HOME_TIMELINE)


def for_you_product(pipe, stats, frs):
    """The For You mixer over ``pipe`` (kept as a :class:`CheckedPipeline`)
    with the FRS world's HOME_TIMELINE flow as its who-to-follow module and
    two ads."""
    checked = CheckedPipeline(pipe)
    ads = [Candidate(id=i, features={"advertiser_id": a}) for i, a in HP_ADS]
    return hp.build_for_you_mixer(scored_tweets_pipeline=checked, wtf_flow=wtf_flow(frs), ads=ads,
                                  stats=stats), checked


def serve_product(mixer, clock, queries, passes):
    """Each query through the mixer and URT, ``passes`` times: [(served
    candidates, timeline, URT JSON)]."""
    out = []
    for _ in range(passes):
        for q in queries:
            q = fresh(q)
            clock.begin()
            tl = mixer.run(q)
            doc = urt.marshal_timeline(tl).to_json()
            clock.end()
            out.append((tl, doc))
    return out


def product_checks(served, checked, stats, phx, what, frs=None, queries=()):
    """Run B's checks on each served request: no failure at any level, every
    served tweet with MaskNet's 15 heads and (where Phoenix scored it) its
    head features, a who-to-follow module and ads in the timeline; with
    ``frs``, each module's items the HOME_TIMELINE flow's own answer for
    that user (``queries``, in serving order), cut to HP_WTF_ITEMS."""
    failed = {k: v for k, v in stats.counters().items() if "failed" in k}
    require(not failed, f"{what}: the mixer failed open: {failed}")
    for r in checked.results:
        require(not r.failures, f"{what}: the scored pipeline failed open: {r.failures}")
    heads = [f"predicted_{h}" for h in masknet.DEFAULT_HEAD_NAMES]
    require(len(phx.scored) == len(served), f"{what}: Phoenix scored {len(phx.scored)} of {len(served)} requests")
    for (tl, doc), scored in zip(served, phx.scored):
        tweets = [e.candidate for e in tl.entries if e.kind == EntryKind.TWEET]
        require(0 < len(tweets) <= FY_TOP_K, f"{what}: {len(tweets)} tweets served")
        for c in tweets:
            require(all(h in c.features for h in heads), f"{what}: tweet {c.id} lacks MaskNet's heads")
            if c.id in scored:
                want = {f"phoenix_{h.name}" for h in ps.PHOENIX_HEADS if h.eligible(c)}
                require(want <= set(c.features), f"{what}: tweet {c.id} lacks Phoenix's {want - set(c.features)}")
        entries = json.loads(doc)["timeline"]["instructions"][0]["addEntries"]["entries"]
        require(any(e["entryId"].startswith("module-who_to_follow-") for e in entries),
                f"{what}: no who-to-follow module")
        require(sum(e["entryId"].startswith("promoted-tweet-") for e in entries) >= 1, f"{what}: no ad")
    if frs is not None:
        flow = wtf_flow(frs)
        for (tl, _), q in zip(served, list(queries) * (len(served) // max(len(queries), 1))):
            items = [[c.id for c in e.module.items] for e in tl.entries if e.kind == EntryKind.MODULE
                     and e.module.kind == "who_to_follow"]
            direct = [c.id for c in flow.run(fresh(q))][:HP_WTF_ITEMS]
            require(items == [direct], f"{what}: user {q.user_id}'s who-to-follow module {items}, the flow's "
                                       f"own answer {direct}")


def scoreless(doc):
    """A URT JSON document: (each entry by id with its item scores taken
    out, the entry ids in order, {tweet id: score})."""
    entries = json.loads(doc)["timeline"]["instructions"][0]["addEntries"]["entries"]
    scores = {}
    for e in entries:
        content = e["content"]
        items = ([content["item"]] if content["kind"] == "item"
                 else content["module"]["items"] if content["kind"] == "module" else [])
        for it in items:
            if "score" in it.get("metadata", {}):
                scores[it["id"]] = it["metadata"].pop("score")
    return {e["entryId"]: e for e in entries}, [e["entryId"] for e in entries], scores


def same_timelines(got, want, what):
    """Two products' answers to the same requests: the tweets ranked alike
    (:func:`check_same_ranking` at FY_RTOL/FY_ATOL), every other entry in
    the same place, entries in both equal but for their scores. Returns the
    ranks holding another id."""
    moved = 0
    for (gtl, gdoc), (wtl, wdoc) in zip(got, want):
        g_ids = np.asarray([e.candidate.id for e in gtl.entries if e.kind == EntryKind.TWEET])
        w_ids = np.asarray([e.candidate.id for e in wtl.entries if e.kind == EntryKind.TWEET])
        g_sc = np.asarray([e.candidate.score for e in gtl.entries if e.kind == EntryKind.TWEET])
        w_sc = np.asarray([e.candidate.score for e in wtl.entries if e.kind == EntryKind.TWEET])
        k = max(len(g_ids), len(w_ids))
        pad = lambda a, v: np.concatenate([a, np.full(k - len(a), v)])  # noqa: E731
        moved += check_same_ranking(pad(g_ids, PAD_ID)[None], pad(g_sc, 0.0)[None], pad(w_ids, PAD_ID)[None],
                                    pad(w_sc, 0.0)[None], FY_RTOL, FY_ATOL, what)
        (g, g_order, g_s), (w, w_order, w_s) = scoreless(gdoc), scoreless(wdoc)
        for i, (a, b) in enumerate(zip(g_order, w_order)):
            require(a == b or (a.startswith("tweet-") and b.startswith("tweet-")),
                    f"{what}: entry {i} is {a} here and {b} there")
        for eid in g.keys() & w.keys():
            if eid.startswith("module-who_to_follow-"):  # near-tied recommendations may trade places
                gi, wi = g[eid]["content"]["module"]["items"], w[eid]["content"]["module"]["items"]
                for a, b in zip(gi, wi):
                    sa, sb = g_s.get(a["id"], 0.0), w_s.get(b["id"], 0.0)
                    require(a == b or abs(sa - sb) <= 2 * (FY_ATOL + FY_RTOL * abs(sb)),
                            f"{what}: module {eid} item {a['id']} against {b['id']}, not a near-tie")
                require(len(gi) == len(wi) and {k: v for k, v in g[eid]["content"]["module"].items() if k != "items"}
                        == {k: v for k, v in w[eid]["content"]["module"].items() if k != "items"},
                        f"{what}: module {eid} differs")
            elif not eid.startswith("cursor-"):  # a cursor is the top or last tweet id, which near-ties may move
                require(g[eid] == w[eid], f"{what}: entry {eid} differs")
        for t in g_s.keys() & w_s.keys():
            require(abs(g_s[t] - w_s[t]) <= FY_ATOL + FY_RTOL * abs(w_s[t]), f"{what}: tweet {t} scored apart")
    return moved


def phase_home_pipeline(dev, fy):
    """The per-request For You product on the card, over what the foryou
    phase built (its world, sources, MaskNets and spread-lift engine).

    Run A: ``build_for_you_pipeline`` with the wide catalog and the f32
    MaskNet, the four batch sources each asked per request, HP_USERS users
    with creation times below SPREAD_TS, held against the f32 batched engine
    on the same queries (the JAX test's bounds) and each request's matrix
    against ``DeviceHydrationScorer.assemble_features``. Run B: the product,
    with the bf16 MaskNet, Phoenix at ``PhoenixConfig()``'s full width in
    bf16 and its loop, inside ``build_for_you_mixer`` with a who-to-follow
    stand-in and two ads, registered beside the Following product, every
    timeline marshalled to URT; the users served twice. Launches counted and
    held exactly; the f32 product on the card against the port on the CPU;
    bf16 against f32; host-clock splits; the device's busy share; the new
    row_gather launches against index_select. Returns one request's
    launches, and for the edge phase run B's product registry, stats,
    checked pipeline and queries, and the first EDGE_ROWS_A_REQUEST rows of
    each run-A request's host-catalog matrix."""
    t_phase = time.perf_counter()
    world, sources, lift = fy["world"], fy["sources"], spread_lift(fy["lift"])
    queries = home_queries(fy)
    pcfg = phoenix.PhoenixConfig()  # d_model 256, 4 layers, 8 heads, 256 history, 65,536 author buckets, bf16
    px16 = phoenix.PhoenixModel(pcfg, device=dev, generator=torch.Generator(device=dev).manual_seed(HP_SEED))
    px32 = phoenix.PhoenixModel(dataclasses.replace(pcfg, dtype="float32"), device=dev)
    px32.load_state_dict(px16.state_dict())
    print(f"home_pipeline: {card_line()}; Phoenix at full width (d_model {pcfg.d_model}, {pcfg.n_layers} layers, "
          f"{pcfg.n_heads} heads, history {pcfg.max_history}, {pcfg.author_buckets} author buckets, {pcfg.dtype}); "
          f"{HP_USERS} users, {HP_EVENTS} raw action events each")

    # run A: the per-request pipeline against the batched engine, f32
    clock_a = StepClock()
    matrices = []
    pipe_a, _ = home_pipeline(world, [PerRequestSource(s, lift) for s in sources], masknet.predict_fn(fy["ref"]),
                              clock_a)
    assembler = pipe_a.scorers[0].inner.assembler
    pipe_a.scorers[0].inner.assembler = lambda q, c: matrices.append((q, list(c), assembler(q, c))) or matrices[-1][2]
    warm = pipe_a.run(fresh(queries[0]))  # builds lazy state (host mirrors are made at build time; the pool starts)
    require(not warm.failures, f"run A failed open: {warm.failures}")
    matrices.clear()
    torch.cuda.synchronize()
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    results_a = []
    for q in queries:
        clock_a.begin()
        results_a.append(pipe_a.run(fresh(q)))
        clock_a.end()
    torch.cuda.synchronize()
    launches_a = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                  "row_gather": _build.launches(gather.row_gather)}
    want_a = {k: HP_USERS * v for k, v in HP_LAUNCHES_A.items()}
    require(launches_a == want_a, f"run A launches {launches_a}, want {want_a} ({HP_LAUNCHES_A} a request)")
    engine_out = fy["spread"].serve_batch(queries)
    worst_pair, moved, n_served = 0.0, 0, 0
    for q, got, res in zip(queries, engine_out, results_a):
        require(not res.failures, f"run A failed open: {res.failures}")
        want = res.candidates
        require(0 < len(want) <= FY_TOP_K and len(got) == len(want), "run A: not the engine's number of results")
        require(not {c.id for c in want} & set(q.seen_tweet_ids), "run A served a seen id")
        require(all(q.now - c.features["created_ts"] <= 10 ** 9 for c in want), "run A served past the max age")
        got_s, want_s = {c.id: c.score for c in got}, {c.id: c.score for c in want}
        for i in got_s.keys() & want_s.keys():
            worst_pair = max(worst_pair, abs(got_s[i] - want_s[i]))
        require(worst_pair < HP_PAIR_TOL, f"run A: a shared id's score {worst_pair:.3g} from the engine's")
        for r, (g, w) in enumerate(zip([c.id for c in got], [c.id for c in want])):
            if g != w:
                moved += 1
                require(abs(want_s[w] - want_s.get(g, got_s[g])) < HP_TIE_TOL,
                        f"run A rank {r}: {g} against the engine's {w}, not a near-tie")
        n_served += len(want)
    worst = {}
    for q, cands, x in matrices:
        d = fy["spread"].scorer.assemble_features(q, cands)
        require(d.shape == x.shape == (len(cands), fs.total_width(fs.WIDE_SCHEMA)), f"matrices of {x.shape}, {d.shape}")
        col = 0
        for spec in fs.WIDE_SCHEMA:
            a, b = x[:, col:col + spec.width], d[:, col:col + spec.width]
            fam = spec.name.split("_")[0]
            err = float(np.abs(a - b).max()) if len(cands) else 0.0
            require(np.allclose(b, a, atol=HP_ASSEMBLE_TOL, rtol=HP_ASSEMBLE_TOL),
                    f"{spec.name}: host catalog and device assembly {err:.3g} apart")
            if err >= worst.get(fam, (0.0, ""))[0]:
                worst[fam] = (err, spec.name)
            col += spec.width
    n_cands = [len(c) for _, c, _ in matrices]
    print(f"home_pipeline: run A, {HP_USERS} requests ({min(n_cands)}-{max(n_cands)} candidates each, creation times "
          f"below {SPREAD_TS} s): launches {launches_a} ({HP_LAUNCHES_A} a request, as derived); the batched f32 engine's "
          f"{n_served} served ids, {moved} ranks apart among near-ties (within {HP_TIE_TOL}); shared ids' scores within "
          f"{worst_pair:.3g} (bound {HP_PAIR_TOL}); no seen id, none past the max age; each request's "
          f"{fs.total_width(fs.WIDE_SCHEMA)}-column matrix against the device assembly within {HP_ASSEMBLE_TOL}, worst "
          f"|diff| by family: " + ", ".join(f"{f} {e:.3g}" for f, (e, n) in worst.items() if e > 0))
    edge_rows = np.concatenate([x[:EDGE_ROWS_A_REQUEST] for _, _, x in matrices])  # the edge phase's model inputs
    del matrices

    # run B: the product, bf16, Phoenix and its loop, twice
    clock_b, stats_b = StepClock(), StatsReceiver()
    phx_inputs, head_inputs, record = [], [], {}
    pipe_b, phx_b = home_pipeline(world, [PerRequestSource(s, lift, record) for s in sources],
                                  recording(masknet.predict_fn(fy["m16"]), head_inputs, 2), clock_b,
                                  recording(phoenix.scorer_predict_fn(px16), phx_inputs, 2), pl.PhoenixScoreStore(),
                                  device=dev)
    mixer, checked = for_you_product(pipe_b, stats_b, fy["frs"])
    registry = hp.HomeProductPipelineRegistry()
    registry.register("for_you", mixer)
    registry.register("following", hp.build_following_pipeline(index=fy["index"], stats=stats_b))
    require(registry.products() == ["following", "for_you"], f"products {registry.products()}")
    torch.cuda.synchronize()
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    served_b = serve_product(registry.get("for_you"), clock_b, queries, 2)
    torch.cuda.synchronize()
    launches_b = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                  "row_gather": _build.launches(gather.row_gather)}
    want_b = {k: 2 * HP_USERS * v for k, v in HP_LAUNCHES_B.items()}
    require(launches_b == want_b, f"run B launches {launches_b}, want {want_b} ({HP_LAUNCHES_B} a request)")
    product_checks(served_b, checked, stats_b, phx_b, "run B", fy["frs"], queries)
    reranked = sum(bool(e.candidate.features.get("phoenix_reranked")) for tl, _ in served_b[HP_USERS:]
                   for e in tl.entries if e.kind == EntryKind.TWEET)
    require(reranked > 0, "run B's second pass reranked nothing from the Phoenix store")
    following = urt.marshal_timeline(registry.get("following").run(hp.TimelineQuery(
        user_id=queries[0].user_id, followed_authors=queries[0].followed_authors, now=foryou_world.NOW)))
    require(len(following.entries()) > 0, "the Following product served nothing")
    print(f"home_pipeline: run B, {2 * HP_USERS} requests through build_for_you_mixer and URT: launches {launches_b} "
          f"({HP_LAUNCHES_B} a request, as derived: the who-to-follow flow's sources {HP_WTF}); no failure in the "
          f"scored pipeline or the mixer; every served tweet with MaskNet's 15 heads and Phoenix's features; each "
          f"timeline a who-to-follow module holding the HOME_TIMELINE flow's own first {HP_WTF_ITEMS} for its user, "
          f"and ads; the "
          f"second pass reranked {reranked} served tweets from the loop's store; Following served "
          f"{len(following.entries())} entries from the same registry")

    # one counted request: the path's launches
    torch.cuda.synchronize()
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    serve_product(mixer, StepClock(), queries[:1], 1)
    torch.cuda.synchronize()
    launches = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                "row_gather": _build.launches(gather.row_gather)}
    require(launches == HP_LAUNCHES_B, f"one request's launches {launches}, want {HP_LAUNCHES_B}")

    # bf16 against f32 on the card, on the inputs the served requests gave the models
    head_err = max(float(np.abs(masknet.predict_fn(fy["m16"])(x) - masknet.predict_fn(fy["ref"])(x)).max())
                   for (x,) in head_inputs)
    px_err = max(float(np.abs(phoenix.scorer_predict_fn(px16)(*a) - phoenix.scorer_predict_fn(px32)(*a)).max())
                 for a in phx_inputs)
    require(head_err <= HP_HEAD_ATOL, f"bf16 MaskNet heads {head_err:.3g} from f32 (bound {HP_HEAD_ATOL})")
    require(px_err <= HP_PHOENIX_ATOL, f"bf16 Phoenix probabilities {px_err:.3g} from f32 (bound {HP_PHOENIX_ATOL})")
    hist = phx_inputs[0][3]
    print(f"home_pipeline: bf16 against f32 on the card over {len(head_inputs)} requests' inputs: MaskNet heads within "
          f"{head_err:.3g} (bound {HP_HEAD_ATOL:.3g}), Phoenix probabilities of {len(phx_inputs[0][0])} candidates "
          f"within {px_err:.3g} (bound {HP_PHOENIX_ATOL}); a history holds {int(hist.valid.sum())} of "
          f"{pcfg.max_history} slots")

    # the f32 product on the card against the port on the CPU, the same candidates
    cpu_world = to_cpu(world)
    ref_cpu = masknet.MaskNet(fy["ref"].config, device="cpu")
    ref_cpu.load_state_dict(fy["ref"].state_dict())
    px_cpu = phoenix.PhoenixModel(px32.config, device="cpu")
    px_cpu.load_state_dict(px32.state_dict())
    answers = {}
    frs_cpu = fy["frs"].to("cpu")
    for where, w, mn, px, d, frs in (("card", world, fy["ref"], px32, dev, fy["frs"]),
                                     ("cpu", cpu_world, ref_cpu, px_cpu, "cpu", frs_cpu)):
        replay = [ReplaySource(s.name, record) for s in sources]
        pipe, phx = home_pipeline(w, replay, masknet.predict_fn(mn), StepClock(), phoenix.scorer_predict_fn(px),
                                  pl.PhoenixScoreStore(), device=d)
        stats = StatsReceiver()
        mx, chk = for_you_product(pipe, stats, frs)
        answers[where] = serve_product(mx, StepClock(), queries[:HP_CPU], 2)
        product_checks(answers[where], chk, stats, phx, f"the f32 product on the {where}")
    moved = same_timelines(answers["card"], answers["cpu"], "the f32 product, card against CPU")
    print(f"home_pipeline: the f32 product on the card against the port on the CPU, {HP_CPU} users x 2 passes: "
          f"tweets ranked alike ({moved} ranks hold another id, within near-ties), scores within rtol {FY_RTOL} / atol "
          f"{FY_ATOL}, every other URT entry equal")
    del cpu_world, ref_cpu, px_cpu, frs_cpu

    # the host clock, the device's busy share, the new row_gather launches
    print(f"home_pipeline: host clock (not a benchmark; {card_line()}; taken after the main process's profiler "
          f"sessions), run A, {HP_USERS} requests: {clock_a.summary('filters and selection')}")
    print(f"home_pipeline: host clock, run B, {2 * HP_USERS} requests: {clock_b.summary('mixer and URT')}")
    busy_qs = queries[:2]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_product(mixer, StepClock(), busy_qs, 1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1000
    print(f"home_pipeline: device busy {dev_ms:.2f} ms of {wall_ms:.1f} ms over {len(busy_qs)} run-B requests "
          f"({100 * dev_ms / wall_ms:.1f}%; torch.profiler, CUDA activity only)")
    calls = []
    real = gather.row_gather

    def keep(ids, *tables):
        calls.append((ids.clone(), tuple(t.detach() for t in tables)))  # Phoenix's table is a parameter
        return real(ids, *tables)

    keep.launches = 0  # the counters name the wrapper they run in
    gather.row_gather = keep
    try:
        serve_product(mixer, StepClock(), queries[1:2], 1)
    finally:
        gather.row_gather = real
    torch.cuda.synchronize()
    names = {world["twhin_user"].data_ptr(): "viewer group (twhin_user, twhin_user_negative, user_interests_emb)",
             world["twhin_author"].data_ptr(): "author group (twhin_author, twhin_author_follow, author_agg_emb)",
             world["twhin_tweet"].data_ptr(): "tweet group (twhin_tweet, media_clip_clusters, text_emb)",
             px16.author_emb.embedding.data_ptr(): "Phoenix author_emb (history + candidates)"}
    times = {}
    for ids, tables in calls:
        label = next((n for t in tables for p, n in names.items() if t.data_ptr() == p), None)
        if label is not None:
            times[label] = time_gather(ids.reshape(-1).contiguous(), tables,
                                       f"home_pipeline {label}: {ids.numel()} rows x "
                                       f"{'+'.join(str(t.shape[1] * t.element_size()) for t in tables)} B")
    require(len(times) == 4, f"the new path's row_gather launches seen: {sorted(times)}")
    print(f"home_pipeline: {card_line()}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(registry=registry, stats=stats_b, checked=checked, queries=queries, rows=edge_rows)


# the serving edge (edge): the HTTP timeline endpoint over the batched engine
# and over run B's product, segdense records, the native front, warmup and the
# aggregation catalog, over what the foryou and home_pipeline phases built
EDGE_ROWS_A_REQUEST = 128  # rows kept of each run-A request's host-catalog matrix: 8 x 128 = 1,024
EDGE_REQUESTS = 64  # concurrent timeline requests through BatchedTimelineFront
EDGE_CLIENTS = 32  # their client threads
EDGE_BASE = 800  # their user ids
EDGE_MIXER_USERS = 4  # run-B users sent to the per-request product, each twice
EDGE_RECORDS = (4, 16)  # records requests x rows each
NATIVE_REQUESTS, NATIVE_CLIENTS, NATIVE_ROWS = 64, 16, 16  # of 1,024 rows: run A's kept rows
NATIVE_MAX_ROWS, NATIVE_DELAY_MS = 256, 2.0
WARM_BUCKETS = (1, 8, 64, 256)
AGG_EVENTS = 4096
AGG_CAPACITY = 4096  # rows a config's store holds: every key of the batch fits
AGG_KEYS = {"user_id": 16_384, "author_id": 4_096, "engager_id": 16_384, "mentioned_user_id": 16_384,
            "original_author_id": 4_096, "topic_id": 1_024, "list_id": 1_024, "day_of_week": 7, "hour_of_day": 24,
            "tweet_id": 1 << 17}  # the For You world's users, authors and tweets
# the f32 MaskNet served through records and the native front against its
# direct forward: the same rows in other batches (cuBLAS may sum in another
# order for another batch size; TF32 is off)
EDGE_RTOL, EDGE_ATOL = 1e-5, 1e-6
HTTP_TIMEOUT = 300  # seconds an HTTP call may take
SOCKET_TIMEOUT = 120  # seconds a native client's socket operation may take
EDGE_MODEL = "masknet_f32"


class BatchRecorder:
    """``engine``'s ``serve_batch``, each batch's queries, answers and host
    seconds kept."""

    def __init__(self, engine):
        self.engine, self.batches, self.seconds, self.lock = engine, [], [], threading.Lock()

    def serve_batch(self, queries, params=None):
        t0 = time.perf_counter()
        out = self.engine.serve_batch(queries, params)
        with self.lock:
            self.batches.append((list(queries), out))
            self.seconds.append(time.perf_counter() - t0)
        return out


class RunRecorder:
    """``product``'s ``run``, each (user, timeline) kept."""

    def __init__(self, product):
        self.product, self.timelines = product, []

    def run(self, query, params=None):
        tl = self.product.run(query, params)
        self.timelines.append((int(query.user_id), tl))
        return tl


def http_post(port, path, payload):
    """POST JSON: the answer's body and the host seconds. A status other
    than 200, or no answer within HTTP_TIMEOUT, raises."""
    body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
        require(r.status == 200, f"HTTP {r.status} from {path}")
        out = r.read()
    return out, time.perf_counter() - t0


def reset_launches():
    torch.cuda.synchronize()
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0


def read_launches():
    torch.cuda.synchronize()
    return {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
            "row_gather": _build.launches(gather.row_gather)}


def latency(seconds):
    """p50 / p99 of host seconds, in ms."""
    ms = [1e3 * s for s in seconds]
    return f"p50 {pct(ms, 0.5):.1f} ms, p99 {pct(ms, 0.99):.1f} ms"


def as_records(rows, names, ids):
    """Each row's non-zero columns as a record: string names for the even
    rows, precomputed feature ids for the odd ones."""
    return [{(names if b % 2 == 0 else ids)[j]: float(row[j]) for j in np.flatnonzero(row)}
            for b, row in enumerate(rows)]


def agg_events(seed):
    """AGG_EVENTS seeded engagement events over AGG_KEYS: every label of the
    catalog, non-negative engagement values, non-decreasing timestamps."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(1, n, AGG_EVENTS) for k, n in AGG_KEYS.items()}
    batch["user_id"][::16] = 0  # logged-out events: the user-keyed configs drop them
    batch["is_in_network"] = rng.integers(0, 2, AGG_EVENTS)
    for label in ac.LABELS_V2 + ac.NEGATIVE_LABELS:
        batch[label] = (rng.random(AGG_EVENTS) < 0.3).astype(np.float32)
    batch["engagement"] = rng.exponential(size=AGG_EVENTS).astype(np.float32)
    batch["timestamp"] = np.sort(foryou_world.NOW - rng.integers(0, 86_400, AGG_EVENTS)).astype(np.int32)
    return batch


def phase_edge(dev, fy, home):
    """The serving edge on the card, over the foryou phase's world, engines
    and f32 MaskNet and the home_pipeline phase's run-B product registry:
    the HTTP timeline endpoint over ``BatchedTimelineFront`` and over the
    per-request product, segdense records and the native front onto the f32
    MaskNet, warmup, and the aggregation catalog folded on the card against
    the CPU. Returns the launches of the two timeline runs together."""
    t_phase = time.perf_counter()
    F = fs.total_width(fs.WIDE_SCHEMA)
    ref = fy["ref"]
    rows = home["rows"]
    require(rows.shape == (8 * EDGE_ROWS_A_REQUEST, F) and bool(np.isfinite(rows).all()), f"run A's rows {rows.shape}")

    def build(arrays):
        model = masknet.MaskNet(ref.config, device=dev)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in arrays.items()})
        return masknet.predict_fn(model)

    recorder = BatchRecorder(fy["served"])
    front = BatchedTimelineFront(recorder, BatcherConfig(max_batch_size=FY_R, max_delay_ms=10.0),
                                 timeout_s=HTTP_TIMEOUT)
    mixer = RunRecorder(home["registry"].get("for_you"))
    products = hp.HomeProductPipelineRegistry()
    products.register("for_you", front)
    products.register("for_you_mixer", mixer)
    home_q = {int(q.user_id): q for q in home["queries"]}

    def query_builder(product, payload):
        u = int(payload["user_id"])
        return fy["queries"](1, base=u)[0] if product == "for_you" else fresh(home_q[u])

    densifier = sd.RequestDensifier(sd.spec_from_schema(fs.WIDE_SCHEMA))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        save_params_npz(os.path.join(root, EDGE_MODEL, "1"), {k: v.cpu().numpy() for k, v in ref.state_dict().items()})
        reg = ModelRegistry(root)
        reg.scan_once()
        srv = InferenceServer(reg, build, batcher_config=BatcherConfig(max_batch_size=NATIVE_MAX_ROWS, max_delay_ms=2.0),
                              densifiers={EDGE_MODEL: densifier}, products=products, query_builder=query_builder)
        srv.start()
        try:
            launches = edge_timelines(srv, recorder, mixer, home, fy)
            edge_records(srv, densifier, ref, rows)
            edge_native(srv, ref, rows)
            edge_warmup(reg, build, rows)
            counters = srv.stats.counters()
            require(counters.get("errors", 0) == 0, f"the server counted {counters.get('errors')} errors")
        finally:
            srv.close()
            front.close()
    edge_aggregation(dev)
    print(f"edge: {card_line()}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def concurrent_rate(serve):
    """EDGE_REQUESTS calls of ``serve(user)`` from EDGE_CLIENTS threads:
    (requests/s, each call's host seconds)."""
    secs = [0.0] * EDGE_REQUESTS

    def one(i):
        t0 = time.perf_counter()
        require(len(serve(EDGE_BASE + i)) > 0, f"user {EDGE_BASE + i}: an empty answer")
        secs[i] = time.perf_counter() - t0

    with ThreadPoolExecutor(EDGE_CLIENTS) as pool:
        t0 = time.perf_counter()
        list(pool.map(one, range(EDGE_REQUESTS)))
        return EDGE_REQUESTS / (time.perf_counter() - t0), secs


def edge_timelines(srv, recorder, mixer, home, fy):
    """Steps 1-2: EDGE_REQUESTS concurrent ``/v1/timelines/for_you`` through
    the batched front, then run B's users through ``for_you_mixer``; each
    answer byte-equal to its own recorded timeline's URT JSON, launches
    exact, no server error, no failure in the product. Beside the first, in
    this process just before it: the same requests through a 2-worker
    ``RequestBatcher`` and through ``BatchedTimelineFront`` called without
    HTTP. Returns the launches of both counted runs together."""
    config = BatcherConfig(max_batch_size=FY_R, max_delay_ms=10.0)
    rates = {}
    pair = RequestBatcher(fy["served"].serve_batch, config, n_workers=2)
    try:
        rates["2-worker RequestBatcher"] = concurrent_rate(lambda u: pair.serve(fy["queries"](1, base=u)[0],
                                                                               timeout=HTTP_TIMEOUT))
    finally:
        pair.close()
    direct = BatchedTimelineFront(fy["served"], config, timeout_s=HTTP_TIMEOUT)
    try:
        rates["BatchedTimelineFront without HTTP"] = concurrent_rate(
            lambda u: direct.run(fy["queries"](1, base=u)[0]).entries)
    finally:
        direct.close()
    reset_launches()
    users = list(range(EDGE_BASE, EDGE_BASE + EDGE_REQUESTS))
    with ThreadPoolExecutor(EDGE_CLIENTS) as pool:
        t0 = time.perf_counter()
        answers = list(pool.map(lambda u: http_post(srv.port, "/v1/timelines/for_you", {"user_id": u}), users))
        wall = time.perf_counter() - t0
    batched = read_launches()
    nb = len(recorder.batches)
    want = {k: nb * v for k, v in FY_LAUNCHES.items()}
    require(batched == want, f"timeline edge launches {batched}, want {want} ({FY_LAUNCHES} a batch, {nb} batches)")
    sizes = [len(qs) for qs, _ in recorder.batches]
    require(sum(sizes) == EDGE_REQUESTS and max(sizes) > 1, f"the front's batches {sizes}")
    served = {int(q.user_id): (q, out) for qs, outs in recorder.batches for q, out in zip(qs, outs)}
    marshal = []
    for u, (body, _) in zip(users, answers):
        q, cands = served[u]
        require(0 < len(cands) <= FY_TOP_K, f"user {u}: {len(cands)} candidates")
        t0 = time.perf_counter()
        want = urt.marshal_timeline(default_timeline_builder(q, cands)).to_json().encode()
        marshal.append(time.perf_counter() - t0)
        require(body == want, f"user {u}: the endpoint's URT is not its batch answer's")
    counters = srv.stats.counters()
    require(counters.get("errors", 0) == 0, f"the server counted {counters.get('errors')} errors")
    require(counters.get("timeline_requests/for_you") == EDGE_REQUESTS, f"counters {counters}")
    print(f"edge: {EDGE_REQUESTS} concurrent POST /v1/timelines/for_you from {EDGE_CLIENTS} threads -> 200, each "
          f"byte-equal to the URT of its own batch answer; the front's batches {sizes}; launches {batched} "
          f"({FY_LAUNCHES} a batch, as derived); server errors 0")
    front_rate = fy["front_rate"]
    print(f"edge: host clock (not a benchmark; {card_line()}): the timeline endpoint over BatchedTimelineFront (max "
          f"batch {FY_R}, 10 ms) {EDGE_REQUESTS / wall:.1f} requests/s, {latency([s for _, s in answers])}; just "
          f"before it, the same {EDGE_REQUESTS} requests from {EDGE_CLIENTS} threads: "
          + "; ".join(f"{name} {r:.1f} requests/s, {latency(secs)}" for name, (r, secs) in rates.items())
          + f"; the foryou phase's 2-worker front (before its profiler sessions) {front_rate[0]:.1f} requests/s, p50 "
          f"{front_rate[1]:.1f} ms, p99 {front_rate[2]:.1f} ms; the engine's serve_batch "
          + ", ".join(f"{1e3 * t:.1f}" for t in recorder.seconds) + f" ms a batch over {1e3 * wall:.1f} ms of "
          f"wall; a timeline's Timeline + URT JSON alone {1e3 * np.mean(marshal):.2f} ms, "
          f"{len(answers[0][0])} B")

    # step 2: the per-request product behind the same endpoint, sequential requests
    stats, checked = home["stats"], home["checked"]
    n_before = len(checked.results)
    mixer_users = [int(q.user_id) for q in home["queries"][:EDGE_MIXER_USERS]]
    reset_launches()
    answers = [(u, *http_post(srv.port, "/v1/timelines/for_you_mixer", {"user_id": u}))
               for _ in range(2) for u in mixer_users]
    product = read_launches()
    want = {k: len(answers) * v for k, v in HP_LAUNCHES_B.items()}
    require(product == want, f"per-request product launches {product}, want {want} ({HP_LAUNCHES_B} a request)")
    require([u for u, _ in mixer.timelines] == [u for u, _, _ in answers], "the product ran other users")
    for (u, body, _), (_, tl) in zip(answers, mixer.timelines):
        tweets = [e for e in tl.entries if e.kind == EntryKind.TWEET]
        require(0 < len(tweets) <= FY_TOP_K, f"user {u}: {len(tweets)} tweets")
        require(body == urt.marshal_timeline(tl).to_json().encode(), f"user {u}: the endpoint's URT is not its run's")
    failed = {k: v for k, v in stats.counters().items() if "failed" in k}
    require(not failed, f"the mixer failed open: {failed}")
    require(len(checked.results) - n_before == len(answers), "the scored pipeline ran another number of times")
    for r in checked.results[n_before:]:
        require(not r.failures, f"the scored pipeline failed open: {r.failures}")
    counters = srv.stats.counters()
    require(counters.get("errors", 0) == 0 and counters.get("timeline_requests/for_you_mixer") == len(answers),
            f"counters {counters}")
    print(f"edge: {len(answers)} POST /v1/timelines/for_you_mixer ({EDGE_MIXER_USERS} run-B users twice) -> 200, each "
          f"byte-equal to its run's URT; launches {product} ({HP_LAUNCHES_B} a request, as derived); no failure in the "
          f"scored pipeline or the mixer; host clock {latency([s for _, _, s in answers])}")
    return {k: batched[k] + product[k] for k in batched}


def edge_records(srv, densifier, ref, rows):
    """Step 3: run A's rows as sparse records (names and precomputed ids)
    densified bit for bit, and POSTed as records and as instances, both
    within EDGE_RTOL / EDGE_ATOL of the direct f32 forward."""
    n_req, per = EDGE_RECORDS
    x = rows[:n_req * per]
    spec = densifier.spec
    names, ids = spec.feature_names, [int(i) for i in spec.feature_ids()]
    by_name = [{names[j]: float(row[j]) for j in np.flatnonzero(row)} for row in x]
    by_id = [{ids[j]: float(row[j]) for j in np.flatnonzero(row)} for row in x]
    t0 = time.perf_counter()
    dense_name, _ = densifier.densify(by_name)
    t1 = time.perf_counter()
    dense_id, _ = densifier.densify(by_id)
    t2 = time.perf_counter()
    require(np.array_equal(dense_name, x) and np.array_equal(dense_id, x), "the densified rows are not the source rows")
    want = masknet.predict_fn(ref)(x)
    got = {"records": [], "instances": []}
    secs = {"records": [], "instances": []}
    for r in range(n_req):
        part = x[r * per:(r + 1) * per]
        for form, payload in (("records", {"records": as_records(part, names, ids)}),
                              ("instances", {"instances": part.tolist()})):
            body, s = http_post(srv.port, f"/v1/models/{EDGE_MODEL}:predict", payload)
            got[form].append(np.asarray(json.loads(body)["predictions"], np.float32))
            secs[form].append(s)
    for form, parts in got.items():
        pred = np.concatenate(parts)
        require(pred.shape == want.shape and bool(np.isfinite(pred).all()), f"{form}: predictions {pred.shape}")
        err = float(np.abs(pred - want).max())
        require(np.allclose(pred, want, rtol=EDGE_RTOL, atol=EDGE_ATOL),
                f"{form}: {err:.3g} from the direct forward (rtol {EDGE_RTOL}, atol {EDGE_ATOL})")
        print(f"edge: {n_req} POST {EDGE_MODEL}:predict of {per} rows as {form} -> 200, within {err:.3g} of the "
              f"direct f32 forward (rtol {EDGE_RTOL}, atol {EDGE_ATOL}); host clock {latency(secs[form])} a request")
    nz = int(np.count_nonzero(x))
    print(f"edge: segdense densify of {len(x)} run-A rows ({nz / len(x):.0f} non-zero of {x.shape[1]} columns a row) "
          f"bit-equal to the rows: {1e3 * (t1 - t0):.1f} ms with string keys (one feature_id a key), "
          f"{1e3 * (t2 - t1):.1f} ms with precomputed ids (host clock)")


def edge_native(srv, ref, rows):
    """Step 4: the native front onto the f32 MaskNet: NATIVE_REQUESTS of
    NATIVE_ROWS rows from NATIVE_CLIENTS clients, coalesced, each answer
    within EDGE_RTOL / EDGE_ATOL of the direct forward; the same rows as
    JSON instances beside it."""
    F, heads = rows.shape[1], ref.config.num_heads
    want = masknet.predict_fn(ref)(rows)
    parts = [rows[i * NATIVE_ROWS:(i + 1) * NATIVE_ROWS] for i in range(NATIVE_REQUESTS)]
    answers, secs = [None] * NATIVE_REQUESTS, [0.0] * NATIVE_REQUESTS
    front = NativePredictFront(masknet.predict_fn(ref), NativeFrontConfig(
        feature_width=F, out_width=heads, max_batch_rows=NATIVE_MAX_ROWS, max_delay_ms=NATIVE_DELAY_MS))
    try:
        def client(c):
            cl = NativeClient(front.port, F, heads, timeout=SOCKET_TIMEOUT)
            try:
                for i in range(c, NATIVE_REQUESTS, NATIVE_CLIENTS):
                    t0 = time.perf_counter()
                    answers[i] = cl.predict(parts[i])
                    secs[i] = time.perf_counter() - t0
            finally:
                cl.close()

        with ThreadPoolExecutor(NATIVE_CLIENTS) as pool:
            t0 = time.perf_counter()
            list(pool.map(client, range(NATIVE_CLIENTS)))  # a client's error or timeout raises here
            wall = time.perf_counter() - t0
        st = front.stats()
        if front.error is not None:
            raise front.error
    finally:
        front.close()
    pred = np.concatenate(answers)
    err = float(np.abs(pred - want).max())
    require(np.allclose(pred, want, rtol=EDGE_RTOL, atol=EDGE_ATOL), f"native front {err:.3g} from the direct forward")
    require(st["requests"] == NATIVE_REQUESTS and st["http_errors"] == 0 and st["avg_batch_rows"] > NATIVE_ROWS,
            f"native front stats {st}")

    def instances(i):
        body, s = http_post(srv.port, f"/v1/models/{EDGE_MODEL}:predict", {"instances": parts[i].tolist()})
        return np.asarray(json.loads(body)["predictions"], np.float32), s

    with ThreadPoolExecutor(NATIVE_CLIENTS) as pool:
        t0 = time.perf_counter()
        json_answers = list(pool.map(instances, range(NATIVE_REQUESTS)))
        json_wall = time.perf_counter() - t0
    jpred = np.concatenate([a for a, _ in json_answers])
    require(np.allclose(jpred, want, rtol=EDGE_RTOL, atol=EDGE_ATOL), "JSON instances off the direct forward")
    json_bytes = len(json.dumps({"instances": parts[0].tolist()}).encode())
    print(f"edge: native front (feature width {F}, {heads} heads, max {NATIVE_MAX_ROWS} rows, {NATIVE_DELAY_MS} ms): "
          f"{NATIVE_REQUESTS} requests of {NATIVE_ROWS} rows from {NATIVE_CLIENTS} clients, within {err:.3g} of the "
          f"direct f32 forward (rtol {EDGE_RTOL}, atol {EDGE_ATOL}); {st['batches']} batches, avg "
          f"{st['avg_batch_rows']:.1f} rows, avg queue {st['avg_queue_us']:.0f} us, http_errors 0; held error None")
    print(f"edge: host clock (not a benchmark; {card_line()}): native front {NATIVE_REQUESTS / wall:.1f} requests/s, "
          f"{latency(secs)} ({4 + NATIVE_ROWS * F * 4} B a request body); JSON instances through the HTTP server "
          f"{NATIVE_REQUESTS / json_wall:.1f} requests/s, {latency([s for _, s in json_answers])} ({json_bytes} B a "
          f"request body)")


def edge_warmup(reg, build, rows):
    """Step 5: warmup over the registry at WARM_BUCKETS, every report ok; a
    spec of the wrong width reports not ready with a reason and raises
    nothing."""
    stats = StatsReceiver()
    specs = wu.registry_warmup_specs(reg, predict_builder=lambda name, params: build(params),
                                     input_makers={EDGE_MODEL: lambda b: rows[:b]}, batch_buckets=WARM_BUCKETS)
    reports = wu.run_warmup(specs, repeats=2, stats=stats)
    require([r.model_name for r in reports] == [EDGE_MODEL] and all(r.ok for r in reports),
            f"warmup: {[(r.model_name, r.ok, r.error) for r in reports]}")
    bad = wu.WarmupSpec(f"{EDGE_MODEL}_wrong_width", specs[0].predict_fn,
                        lambda b: np.zeros((b, rows.shape[1] - 1), np.float32), batch_buckets=(1, 8))
    (broken,) = wu.run_warmup([bad], stats=stats)
    require(not broken.ok and broken.error and not broken.bucket_seconds, f"the broken spec reported {broken}")
    require(stats.counters() == {f"warmup/{EDGE_MODEL}/ok": 1, f"warmup/{EDGE_MODEL}_wrong_width/failed": 1},
            f"warmup counters {stats.counters()}")
    print(f"edge: warmup of {EDGE_MODEL} (a fresh model from the registry), repeats 2: ok; seconds by bucket "
          + ", ".join(f"{b}: {s:.4f}" for b, s in reports[0].bucket_seconds.items())
          + f" (host clock, the first bucket with the model's first use); the wrong-width spec not ready: "
          f"{broken.error[:120]!r}")


def edge_aggregation(dev):
    """Step 6: the aggregation catalog's stores on the card and on the CPU,
    one seeded batch folded through every config: within FOLD_RTOL,
    timestamps exact, the same rows allocated."""
    catalog = ac.build_catalog()
    batch = agg_events(HP_SEED)
    card, cpu = ac.init_stores(catalog, AGG_CAPACITY), ac.init_stores(catalog, AGG_CAPACITY, device="cpu")
    require(all(s.values.device.type == "cuda" for s, _ in card.values()), "init_stores did not build on the card")
    secs = {}
    for where, stores in (("card", card), ("cpu", cpu)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in catalog:
            store, resolver = stores[c.name]
            stores[c.name] = (ac.apply_events(c, store, resolver, batch), resolver)
        torch.cuda.synchronize()
        secs[where] = time.perf_counter() - t0
    worst, n_rows, n_cols = 0.0, 0, 0
    for c in catalog:
        (got, gres), (want, wres) = card[c.name], cpu[c.name]
        require(gres._map == wres._map, f"{c.name}: other rows allocated")
        g = got.values.cpu()
        require(torch.allclose(g, want.values, rtol=FOLD_RTOL, atol=0), f"{c.name}: beyond rtol {FOLD_RTOL} of the CPU")
        require(torch.equal(got.last_ts.cpu(), want.last_ts), f"{c.name}: last_ts differs from the CPU's")
        rel = (g - want.values).abs() / want.values.abs().clamp_min(1e-30)
        worst = max(worst, float(rel.max()))
        n_rows += len(gres._map)
        n_cols += c.n_outputs
    print(f"edge: aggregation catalog, {len(catalog)} configs ({n_cols} columns), {AGG_EVENTS} seeded events folded "
          f"through apply_events into {n_rows} rows: card within rel {worst:.3g} of the CPU (rtol {FOLD_RTOL}), "
          f"last_ts exact, the same rows; host clock of the fold over every config: card {1e3 * secs['card']:.1f} ms, "
          f"CPU {1e3 * secs['cpu']:.1f} ms")


# the other products (products): follow recommendations, push notifications
# with their rankers and the T&S gate, the T&S classifiers and their k-fold
# recipe, the timeline ranker, topic social proof and the action feed, over
# the For You, candidate and SANN worlds the earlier phases built
PR_BASE = 1000  # the users the FRS sources are called for
PR_USERS = 32
PR_ORACLE = 4  # users whose SALSA and triangular lists are held against float64 numpy
PR_RTOL, PR_ATOL = 1e-5, 1e-6  # card against CPU: f32 sums in another order
SIMS_RTOL = 1e-6
PR_TARGETS = 64  # push targets
# rows of each recorded ranker and gate call held against the CPU (the first two calls of each; the gate's check
# once took every one of its 128 calls, 25.8 s at 128 rows on an H100 machine's host: 1.6 ms a text)
PR_CPU_ROWS = 32
PR_TEXTS = 256  # T&S texts served (one empty)
PR_IMAGES = 64  # 224 x 224 media
PR_TRAIN_N = 4096  # the k-fold pool
PR_TOXIC_BAND = 65  # tokens 1-64 are the planted toxic ones
PR_GRAD_TOL = 1e-4  # first-step gradients, card against CPU: of each parameter's largest entry
PR_AUC_OOF, PR_AUC_MEAN = 0.8, 0.7  # tests/test_trust_safety_train.py:76-77
PR_TLR_USERS = 16
PR_TWEETS, PR_TOPICS = 256, 1024  # TSPS
PR_TOPIC_K = 20
PR_EVENTS = 4096  # raw action events


def counts():
    """The three kernels' launch counters, read under their lock."""
    torch.cuda.synchronize()
    return {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
            "row_gather": _build.launches(gather.row_gather),
            "run_collapse_rows": _build.launches(seg_scan.run_collapse_rows)}


def zero_counts():
    torch.cuda.synchronize()
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    seg_scan.run_collapse_rows.launches = 0


def candidate_rows(lists, width):
    """Candidate lists → (ids [R, width], scores [R, width]) numpy, PAD / 0 padded."""
    ids = np.full((len(lists), width), PAD_ID, np.int64)
    scores = np.zeros((len(lists), width), np.float32)
    for r, cands in enumerate(lists):
        ids[r, :len(cands)] = [c.id for c in cands]
        scores[r, :len(cands)] = [c.score for c in cands]
    return ids, scores


def salsa_oracle(frs, followed, k):
    """SALSA's walk in float64 dicts: (ids, masses) ranked by mass, then id."""
    mass = {}
    for s in followed:
        fol = [int(u) for u in frs.followers[s] if u != PAD_ID]
        for u in fol:
            fw_ = [int(p) for p in frs.follows[u] if p != PAD_ID]
            for p in fw_:
                mass[p] = mass.get(p, 0.0) + 1.0 / len(fol) / len(fw_)
    top = sorted(mass.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    return [t for t, _ in top], [m for _, m in top]


def triangular_oracle(frs, followed, k):
    """Triangular closure's path counts (exact): ranked by count, then id."""
    n = Counter(int(p) for s in followed for p in frs.follows[s] if p != PAD_ID)
    top = sorted(n.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    return [t for t, _ in top], [float(c) for _, c in top]


def products_frs(dev, frs):
    """The device sources called directly for PR_USERS users (card against
    the port on the CPU, launches exact, SALSA and triangular against
    float64 oracles), each display-location flow, the sims graph against
    the CPU. Returns the direct calls' launches."""
    t0 = time.perf_counter()
    frs_cpu = frs.to("cpu")
    card, cpu = frs.device_sources(), frs_cpu.device_sources()
    reqs = [frs.request(u) for u in range(PR_BASE, PR_BASE + PR_USERS)]
    zero_counts()
    got = {}
    for name, src in card.items():
        got[name] = []
        for r in reqs:
            before = counts()
            out = src(r)
            after = counts()
            rg, rc = frs_world.SOURCE_LAUNCHES[name]
            require(after["row_gather"] - before["row_gather"] == rg and
                    after["run_collapse"] - before["run_collapse"] == rc,
                    f"FRS {name} launches {after}, {before} before; want {rg} + {rc} a call")
            require(len(out) > 0, f"FRS {name}: no candidate for user {r.user_id}")
            got[name].append(out)
    launches = counts()
    want = frs_world.expected_launches(list(card))
    require(launches == {"run_collapse": PR_USERS * want["run_collapse"], "row_gather": PR_USERS * want["row_gather"],
                         "run_collapse_rows": 0}, f"FRS launches {launches}")
    t_card = time.perf_counter() - t0
    t_cpu = time.perf_counter()
    moved = {}
    for name, src in cpu.items():
        want_lists = [src(r) for r in reqs]
        width = max(len(c) for c in got[name] + want_lists)
        moved[name] = check_same_ranking(*candidate_rows(got[name], width), *candidate_rows(want_lists, width),
                                         PR_RTOL, PR_ATOL, f"FRS {name}, card against CPU")
    for r in reqs[:PR_ORACLE]:
        followed = sorted(r.followed_set)
        k = frs.shape.top_k
        for name, oracle in (("salsa", salsa_oracle), ("triangular", triangular_oracle)):
            w_ids, w_s = oracle(frs, followed, k)
            out = card[name](r)
            g_ids, g_s = candidate_rows([out], k)
            if name == "triangular":  # whole-number counts: the list exactly, ties by id
                require(g_ids[0].tolist()[:len(w_ids)] == w_ids and np.array_equal(g_s[0][:len(w_s)], w_s),
                        f"triangular closure for user {r.user_id} differs from the oracle")
            else:
                wi, ws = candidate_rows([[Candidate(id=i, score=s) for i, s in zip(w_ids, w_s)]], k)
                check_same_ranking(g_ids, g_s, wi, ws, PR_RTOL, 0.0, f"SALSA for user {r.user_id} against float64")
    flows = {}
    for loc in fc.DisplayLocation:
        flow = frs.catalog().flow(loc)
        per = frs_world.flow_launches(loc)
        n_items = []
        for r in reqs:
            before = counts()
            out = flow.run(r)
            after = counts()
            require({k: after[k] - before[k] for k in per} == per, f"flow {loc.name}: launches, want {per}")
            ids = {c.id for c in out}
            require(out and not ids & (r.followed_set | r.blocked_set | {r.user_id}),
                    f"flow {loc.name} for user {r.user_id}: empty, or a followed, blocked or self id")
            n_items.append(len(out))
        flows[loc.name] = (min(n_items), max(n_items), per)
    t_cpu, t_sims = time.perf_counter() - t_cpu, time.perf_counter()
    # the sims graph on the card against the CPU
    fm = sims_graph.follow_matrix_from_adjacency(frs_cpu.follow_adj, frs.shape.num_authors)
    sims_cpu = sims_graph.symmetrize(sims_graph.cosine_similarity_graph(fm, top_k=frs.shape.sims_top_k))
    del fm
    sims_moved = check_same_ranking(frs.sims_ids, frs.sims_weights, sims_cpu.nbr_ids.numpy(),
                                    sims_cpu.nbr_weights.numpy(), SIMS_RTOL, 1e-7, "the sims graph, card against CPU")
    print(f"products: FRS over {frs.shape.num_users} users' follows ({frs.shape.follows} of "
          f"{frs.shape.num_authors} authors each, followers padded to {frs.followers.shape[1]}): the six device "
          f"sources called directly for {PR_USERS} users, none empty, launches {launches} "
          f"({ {n: frs_world.SOURCE_LAUNCHES[n] for n in card} } (row_gather, run_collapse) a call, as derived); card "
          f"against the port on the CPU, ranks apart among near-ties {moved}; SALSA within rtol {PR_RTOL} of float64 "
          f"and triangular closure equal to its exact oracle for {PR_ORACLE} users; the four flows, each non-empty "
          f"with no followed, blocked or self id, (min, max items, launches a request) {flows}; the sims graph "
          f"[{frs.shape.num_authors}, {frs.shape.sims_top_k}] card against CPU within rtol {SIMS_RTOL}, "
          f"{sims_moved} places among near-ties; host clock (not a benchmark): the direct calls {t_card:.2f} s, the "
          f"CPU's, the oracles and the flows {t_cpu:.2f} s, the sims graph on the CPU {time.perf_counter() - t_sims:.2f} s")
    return launches


class ForTarget(CandidateSource):
    """A For You batch source asked for a push target: its ForYouQuery, the
    source's candidates with their columns as features (lifted)."""

    def __init__(self, batch_source, lift, query_of):
        self.inner = PerRequestSource(batch_source, lift)
        self.query_of = query_of

    @property
    def name(self):
        return self.inner.name

    def get(self, target, params):
        return self.inner.get(self.query_of(target.user_id), params)


class Hydrated(CandidateSource):
    """An adaptor whose candidates carry their row of the For You hydration
    tier (``assemble_features``: the 6,823 columns MaskNet reads)."""

    def __init__(self, adaptor, scorer, query_of):
        self.adaptor, self.scorer, self.query_of = adaptor, scorer, query_of

    @property
    def name(self):
        return self.adaptor.name

    def get(self, target, params):
        out = self.adaptor.get(target, params)
        rows = self.scorer.assemble_features(self.query_of(target.user_id), out) if out else []
        for c, row in zip(out, rows):
            c.features["push_row"] = row
        return out


def tweet_texts(index_tokens, tweet_ids, cfg):
    """Each tweet's doc tokens (the earlybird slot of an external id, else
    the id itself) mod the vocabulary, PAD → 0, padded to max_len: (ids, mask)."""
    slots = np.where(tweet_ids >= foryou_world.TWEET_ID_BASE, tweet_ids - foryou_world.TWEET_ID_BASE, tweet_ids)
    toks = index_tokens[slots % index_tokens.shape[0]]
    valid = toks != PAD_ID
    ids = np.zeros((len(tweet_ids), cfg.max_len), np.int32)
    mask = np.zeros((len(tweet_ids), cfg.max_len), np.float32)
    ids[:, :toks.shape[1]] = np.where(valid, toks % cfg.vocab_size, 0)
    mask[:, :toks.shape[1]] = valid
    return ids, mask


def safety_fn(model, index_tokens, record=None, limit=0):
    """The health predicate's score function over a text model: tweet ids
    → {"toxicity", "nsfw", "abuse"} probabilities (tensors on the model's
    device), keeping its first ``limit`` calls' (tokens, mask) in
    ``record``."""
    dev = next(model.parameters()).device

    def scores(ids):
        tok, mask = tweet_texts(index_tokens, np.asarray(ids), model.config)
        if record is not None and len(record) < limit:
            record.append((tok, mask))
        with torch.no_grad():
            p = torch.sigmoid(model(torch.from_numpy(tok).to(dev), torch.from_numpy(mask).to(dev)))
        return {h: p[:, i] for i, h in enumerate(model.heads)}

    return scores


def products_push(dev, fy, cand, frs, ts_model):
    """PR_TARGETS targets through PushPipeline: the EarlybirdFirstDegree and
    ContentRecommenderMixer adaptors over the For You sources, each
    candidate's hydration-tier row, the light ranker and ClemNet in f32,
    the health predicate over the trained T&S model, NTab and fatigue.
    Returns the counted run's launches."""
    F = fs.total_width(fs.WIDE_SCHEMA)
    scorer = fy["spread"].scorer
    index_tokens = cand[0].eb_tokens

    def query_of(u):
        return ForYouQuery(user_id=u, followed_authors=[int(a) for a in frs.follows[u] if a != PAD_ID],
                           max_results=FY_TOP_K, now=foryou_world.NOW)

    adaptors = pc.build_push_adaptors(earlybird_source=ForTarget(fy["sources"][1], fy["lift"], query_of),
                                      content_mixer_source=ForTarget(fy["sources"][2], fy["lift"], query_of))
    targets = [pushsvc.PushTarget(user_id=u) for u in range(PR_BASE, PR_BASE + PR_TARGETS)]
    derived = {"EarlybirdFirstDegree": {"run_collapse": 0, "row_gather": 0},
               "ContentRecommenderMixer": {"run_collapse": 1, "row_gather": 1}}  # earlybird none; UTEG 1 + 1
    sizes = {}
    for a in adaptors:
        before = counts()
        out = a.get(targets[0], None)
        after = counts()
        require(out and all(c.features["crt"] in (pc.CRT.IN_NETWORK_TWEET, pc.CRT.OON_TWEET) for c in out),
                f"push adaptor {a.name}: no candidate")
        got = {k: after[k] - before[k] for k in derived[a.name]}
        require(got == derived[a.name], f"push adaptor {a.name} launches {got}, want {derived[a.name]}")
        sizes[a.name] = len(out)
    before = counts()
    scorer.assemble_features(query_of(PR_BASE), out)
    after = counts()
    assemble = {k: after[k] - before[k] for k in ("run_collapse", "row_gather")}

    gen = torch.Generator(device=dev)
    light = push_rankers.LightRankingMLP(F, hidden=(200, 100), device=dev, generator=gen.manual_seed(31)).eval()
    heavy = push_rankers.ClemNet(F, num_heads=3, device=dev, generator=gen.manual_seed(32)).eval()
    light_in, heavy_in, health_in = [], [], []
    with torch.no_grad():
        lp = recording(lambda x: light(torch.from_numpy(x).to(dev))[:, 0], light_in, 2)
        hp_ = recording(lambda x: torch.sigmoid(heavy(torch.from_numpy(x).to(dev))), heavy_in, 2)
    ntab = pc.NTabStore()
    pipe = pushsvc.PushPipeline(
        sources=[Hydrated(a, scorer, query_of) for a in adaptors], light_predict=lp, heavy_predict=hp_,
        featurize=lambda t, c: c.features["push_row"], heavy_head_weights=np.asarray([1.0, 0.5, 0.25], np.float32),
        candidate_predicates=[pc.not_already_sent(ntab)],
        batch_candidate_predicates=[pc.health_model_predicate(safety_fn(ts_model, index_tokens, health_in, 2))],
        ntab=ntab, fatigue_config=pc.PushFatigueConfig())
    zero_counts()
    t1 = time.perf_counter()
    with torch.no_grad():
        winners = [pipe.run(t, foryou_world.NOW) for t in targets]
    t_run = time.perf_counter() - t1
    launches = counts()
    per = {"run_collapse": 1 + 2 * assemble["run_collapse"], "row_gather": 1 + 2 * assemble["row_gather"] + 1}
    want = {k: PR_TARGETS * v for k, v in per.items()} | {"run_collapse_rows": 0}
    require(launches == want, f"push launches {launches}, want {want} ({per} a target: UTEG 1 + 1, two "
                              f"hydrations {assemble} each, the health model's table read)")
    for t, w in zip(targets, winners):
        require(w is not None, f"push: no winner for target {t.user_id}")
        sent = ntab.history(t.user_id)
        require([n.tweet_id for n in sent] == [w.id] and sent[0].crt == w.features["crt"],
                f"push: NTab holds {sent} for target {t.user_id}")
    t2 = time.perf_counter()
    with torch.no_grad():
        again = [pipe.run(t, foryou_world.NOW + 60) for t in targets]
    t_again = time.perf_counter() - t2
    require(all(a is None for a in again), "push: a second run inside the minimum interval sent something")
    # card against CPU on the recorded inputs
    light_cpu = push_rankers.LightRankingMLP(F, hidden=(200, 100), device="cpu").eval()
    light_cpu.load_state_dict(light.state_dict())
    heavy_cpu = push_rankers.ClemNet(F, num_heads=3, device="cpu").eval()
    heavy_cpu.load_state_dict(heavy.state_dict())
    ts_cpu = ts.TextSafetyModel(ts_model.config, device="cpu").eval()
    ts_cpu.load_state_dict(ts_model.state_dict())
    errs, cpu_secs = {}, {}
    checks = (("light", light_in, lambda x: light(torch.from_numpy(x).to(dev)),
               lambda x: light_cpu(torch.from_numpy(x))),
              ("ClemNet", heavy_in, lambda x: torch.sigmoid(heavy(torch.from_numpy(x).to(dev))),
               lambda x: torch.sigmoid(heavy_cpu(torch.from_numpy(x)))),
              ("health", health_in,
               lambda t, m: torch.sigmoid(ts_model(torch.from_numpy(t).to(dev), torch.from_numpy(m).to(dev))),
               lambda t, m: torch.sigmoid(ts_cpu(torch.from_numpy(t), torch.from_numpy(m)))))
    with torch.no_grad():
        for name, sink, card_fn, cpu_fn in checks:
            t4 = time.perf_counter()
            for args in sink:  # what the pipeline reads: the light logit, the heavy and health probabilities
                args = tuple(a[:PR_CPU_ROWS] for a in args)  # the first rows of each recorded call
                g, w = card_fn(*args).cpu(), cpu_fn(*args)
                errs[name] = max(errs.get(name, 0.0), float((g - w).abs().max()))
                require(torch.allclose(g, w, rtol=PR_RTOL, atol=PR_ATOL),
                        f"push {name}: card against CPU, max |diff| {errs[name]:.3g}")
            cpu_secs[name] = round(time.perf_counter() - t4, 2)
    crts = Counter(w.features["crt"].name for w in winners)
    print(f"products: push, {PR_TARGETS} targets (adaptors called directly: {sizes} candidates for the first, "
          f"launches as derived: {derived}); every target a winner ({dict(crts)}), each recorded in NTab; a second "
          f"run {60} s later sent nothing (fatigue); launches {launches} ({per} a target, as derived); the light "
          f"ranker (hidden (200, 100)), ClemNet (default blocks, 3 heads) over each candidate's {F} hydration "
          f"columns and the health model, card against CPU on the first {PR_CPU_ROWS} rows of two recorded calls "
          f"each within rtol {PR_RTOL} / atol "
          f"{PR_ATOL} (max |diff| {errs}); host clock (not a benchmark) {1e3 * t_run / PR_TARGETS:.1f} ms a target, "
          f"the second run {t_again:.1f} s, the CPU's checks {cpu_secs} s on {torch.get_num_threads()} CPU threads")
    return launches


def seeded_texts(n, seed):
    """``n`` seeded texts of 1-60 made-up words, the first empty."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(5000)]
    out = [""]
    for _ in range(n - 1):
        out.append(" ".join(words[j] for j in rng.integers(0, len(words), int(rng.integers(1, 61)))))
    return out


def products_ts_serving(dev):
    """TextSafetyModel(TextEncoderConfig()) on PR_TEXTS texts (one empty)
    and MediaSafetyModel() on PR_IMAGES 224 x 224 images, card against CPU;
    one row_gather launch a text forward."""
    cfg = ts.TextEncoderConfig()
    gen = torch.Generator(device=dev)
    model = ts.TextSafetyModel(cfg, device=dev, generator=gen.manual_seed(41)).eval()
    toks, masks = zip(*(ts.tokenize_text(t, cfg) for t in seeded_texts(PR_TEXTS, 43)))
    tok, mask = torch.stack(toks), torch.stack(masks)
    require(float(mask[0].sum()) == 0.0, "the empty text has a token")
    zero_counts()
    with torch.no_grad():
        got = model(tok.to(dev), mask.to(dev))
    launches = counts()
    require(launches == {"run_collapse": 0, "row_gather": 1, "run_collapse_rows": 0},
            f"T&S text forward launches {launches}, want one row_gather")
    cpu = ts.TextSafetyModel(cfg, device="cpu").eval()
    cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = cpu(tok, mask)
    require(bool(torch.isfinite(got).all()) and torch.allclose(got.cpu(), want, rtol=PR_RTOL, atol=PR_ATOL),
            "T&S text model: card against CPU")
    text_err = float((got.cpu() - want).abs().max())
    media = ts.MediaSafetyModel(device=dev, generator=gen.manual_seed(42)).eval()
    images = torch.from_numpy(np.random.default_rng(44).random((PR_IMAGES, 224, 224, 3), np.float32))
    media_cpu = ts.MediaSafetyModel(device="cpu").eval()
    media_cpu.load_state_dict(media.state_dict())
    with torch.no_grad():
        mg, mw = media(images.to(dev)).cpu(), media_cpu(images)
    require(mg.shape == (PR_IMAGES, 1) and torch.allclose(mg, mw, rtol=PR_RTOL, atol=PR_ATOL),
            "T&S media model: card against CPU")
    print(f"products: T&S serving, TextSafetyModel(TextEncoderConfig()) ({cfg.vocab_size} x {cfg.dim} tokens, "
          f"L={cfg.max_len}, {cfg.layers} layers) on {PR_TEXTS} texts, one empty: one row_gather launch a forward, "
          f"card against CPU within {text_err:.3g} (rtol {PR_RTOL}, atol {PR_ATOL}), all finite; MediaSafetyModel() "
          f"on {PR_IMAGES} images 224 x 224 within {float((mg - mw).abs().max()):.3g}")
    return launches


def ts_pool(seed):
    """The k-fold pool: PR_TRAIN_N token rows of 16-64 tokens from
    [PR_TOXIC_BAND, vocab); in toxic rows (15%) each token is replaced by
    one of the PR_TOXIC_BAND - 1 toxic tokens [1, PR_TOXIC_BAND) with
    probability one half; nsfw and abuse labels correlated."""
    cfg = ts.TextEncoderConfig()
    rng = np.random.default_rng(seed)
    n, L = PR_TRAIN_N, cfg.max_len
    lengths = rng.integers(16, min(65, L + 1), n)
    tokens = rng.integers(PR_TOXIC_BAND, cfg.vocab_size, (n, L)).astype(np.int32)
    toxic = rng.random(n) < 0.15
    plant = toxic[:, None] & (rng.random((n, L)) < 0.5)
    tokens = np.where(plant, rng.integers(1, PR_TOXIC_BAND, (n, L)), tokens)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    tokens = np.where(mask > 0, tokens, 0).astype(np.int32)
    nsfw = (toxic & (rng.random(n) < 0.6)) | (rng.random(n) < 0.02)
    abuse = toxic & (rng.random(n) < 0.8)
    return tokens, mask, np.stack([toxic, nsfw, abuse], 1).astype(np.float32)


def products_ts_training(dev):
    """train_kfold at RecipeConfig() on the card over the planted pool: JAX's
    AUC bounds, launches exact a step, the first step's gradients against
    the CPU. Returns the recipe's launches and fold 0's trained model."""
    t0 = time.perf_counter()
    cfg, rc = ts.TextEncoderConfig(), tst.RecipeConfig()
    tokens, mask, labels = ts_pool(47)
    template = ts.TextSafetyModel(cfg, device=dev)
    splits = tst.kfold_indices(PR_TRAIN_N, rc.folds, rc.seed, stratify=labels[:, 0])
    spe = [max(len(tr) // rc.batch_size, 1) for tr, _ in splits]
    first = {}
    steps = [0]

    measured = Counter()

    def on_step(fold, step, m):
        c = counts()
        want = {"run_collapse": 0, "run_collapse_rows": 1,
                "row_gather": 1 + (step > 0 and step % spe[fold] == 0 and rc.rescore) + (step == 0 and fold > 0)}
        require(c == want, f"T&S fold {fold} step {step}: launches {c}, want {want} (a step 1 + 1; a rescoring or "
                           f"the previous fold's validation forward one gather before it)")
        measured.update(c)
        zero_counts()
        steps[0] += 1
        if fold == 0 and step == 0:
            first["grads"] = {n: p.grad.detach().cpu().clone() for n, p in m.named_parameters()}
            first["params"] = {n: t.detach().cpu().clone() for n, t in m.state_dict().items()}

    zero_counts()
    res = tst.train_kfold(template, tokens, mask, labels, rc, on_step=on_step)
    measured.update(counts())  # the last fold's validation forward
    t_fit = time.perf_counter() - t0
    total = steps[0]
    require(total == rc.epochs * sum(spe), f"T&S: {total} steps")
    oof, mean = res.oof_auc_per_head, res.mean_auc
    require(oof[0] > PR_AUC_OOF and mean > PR_AUC_MEAN, f"T&S AUCs: out-of-fold {oof}, mean {mean:.3f}")
    # the first step's gradients on the CPU, from the same params and batch
    tr = splits[0][0]
    perm = np.random.default_rng(rc.seed).permutation(len(tr))
    (tok_b, msk_b, y_b), _ = tst._pad_batch([tokens[tr][perm], mask[tr][perm], labels[tr][perm]], 0,
                                            rc.batch_size)
    cpu = ts.TextSafetyModel(cfg, device="cpu")
    cpu.load_state_dict(first["params"])
    loss = tst.weighted_bce(cpu(torch.from_numpy(tok_b), torch.from_numpy(msk_b)), torch.from_numpy(y_b),
                            torch.from_numpy(tst.class_pos_weights(labels[tr])), torch.ones(rc.batch_size))
    loss.backward()
    worst = 0.0
    overall = max(float(p.grad.abs().max()) for p in cpu.parameters())
    for n, p in cpu.named_parameters():
        # an attention key bias's exact gradient is 0 (a softmax does not move when every logit of a query
        # moves by q·b): both sides are rounding noise, held to the model's largest entry instead
        scale = overall if n.endswith("attn.key_bias") else float(p.grad.abs().max())
        d = float((first["grads"][n] - p.grad).abs().max())
        require(d <= PR_GRAD_TOL * max(scale, 1e-30), f"T&S first-step gradient of {n}: {d:.3g} apart, largest "
                                                      f"entry {scale:.3g}")
        worst = max(worst, d / max(scale, 1e-30))
    trained = ts.TextSafetyModel(cfg, device=dev).eval()
    trained.load_state_dict(res.folds[0].params)
    launches = dict(measured)
    want = {"run_collapse": 0, "row_gather": total + rc.folds * (rc.epochs - 1) + rc.folds, "run_collapse_rows": total}
    require(launches == want, f"T&S recipe launches {launches}, want {want}")
    print(f"products: T&S recipe, train_kfold at RecipeConfig() ({rc.folds} folds, {rc.epochs} epochs, batch "
          f"{rc.batch_size}, {rc.schedule}, rescoring) on {PR_TRAIN_N} texts, toxic tokens 1-{PR_TOXIC_BAND - 1} planted: "
          f"{total} steps, each 1 row_gather + 1 run_collapse_rows (held every step); out-of-fold AUC "
          f"{np.round(oof, 4).tolist()} (head 0 bound {PR_AUC_OOF}), mean fold AUC {mean:.4f} (bound "
          f"{PR_AUC_MEAN}); first step's gradients on the card within {worst:.3g} of each parameter's largest "
          f"entry on the CPU (the key biases, whose exact gradient is 0, of the model's largest; bound "
          f"{PR_GRAD_TOL}); host clock {t_fit:.1f} s (not a benchmark)")
    return launches, trained


def products_tlr_tsps(dev, cand, frs, world):
    """Both timeline-ranker forms for PR_TLR_USERS users over the candidate
    world's earlybird index and UTEG graph, card against CPU, 1 + 1
    launches a call; TSPS for PR_TWEETS SANN-world tweets against
    PR_TOPICS seeded topics with every gate, card against CPU, the batch
    equal to the single form for 4 tweets. Returns the TLR launches."""
    t0 = time.perf_counter()
    index, graph = cand[1], cand[2]
    index_cpu, graph_cpu = to_cpu(index), to_cpu(graph)
    split = foryou_world.NOW - 12 * 3600

    def roots(ix):
        return search_root.SuperRoot([search_root.Tier("realtime", ix, split, foryou_world.NOW),
                               search_root.Tier("archive", ix, 0, split - 1)])

    card_root, cpu_root = roots(index), roots(index_cpu)
    cfg = tlr.TimelineRankerConfig()
    zero_counts()
    got, want = [], []
    for u in range(PR_BASE, PR_BASE + PR_TLR_USERS):
        follows = [int(a) for a in frs.follows[u] if a != PAD_ID]
        kw = dict(followed_authors=follows, seed_weights=[1.0] * len(follows), min_ts=foryou_world.NOW - 86400,
                  max_ts=foryou_world.NOW, config=cfg)
        got += [tlr.get_ranked_timeline(index, graph, **kw), tlr.get_ranked_timeline_multitier(card_root, graph, **kw)]
    launches = counts()
    want_l = {"run_collapse": 2 * PR_TLR_USERS, "row_gather": 2 * PR_TLR_USERS, "run_collapse_rows": 0}
    require(launches == want_l, f"timeline ranker launches {launches}, want {want_l}")
    for u in range(PR_BASE, PR_BASE + PR_TLR_USERS):
        follows = [int(a) for a in frs.follows[u] if a != PAD_ID]
        kw = dict(followed_authors=follows, seed_weights=[1.0] * len(follows), min_ts=foryou_world.NOW - 86400,
                  max_ts=foryou_world.NOW, config=cfg)
        want += [tlr.get_ranked_timeline(index_cpu, graph_cpu, **kw),
                 tlr.get_ranked_timeline_multitier(cpu_root, graph_cpu, **kw)]
    moved = 0
    for g, w in zip(got, want):
        require((g.in_network_ids != PAD_ID).sum() > 0 and (g.oon_ids != PAD_ID).sum() > 0, "TLR: an empty stream")
        for a, b, sa, sb in ((g.in_network_ids, w.in_network_ids, g.in_network_scores, w.in_network_scores),
                             (g.oon_ids, w.oon_ids, g.oon_scores, w.oon_scores)):
            fin = lambda x: np.where(np.isfinite(x), x, 0.0)[None]  # noqa: E731
            moved += check_same_ranking(a[None], fin(sa), b[None], fin(sb), PR_RTOL, PR_ATOL, "TLR, card against CPU")
    t_tlr = time.perf_counter() - t0

    # TSPS over SANN-world tweets
    t1 = time.perf_counter()
    rng = np.random.default_rng(53)
    t_ids, t_sc = world[1][:PR_TWEETS], world[2][:PR_TWEETS]
    pool = np.unique(t_ids[t_ids != PAD_ID])
    topic_ids = np.stack([rng.choice(pool, PR_TOPIC_K, False) for _ in range(PR_TOPICS)]).astype(np.int32)
    topic_sc = (rng.random((PR_TOPICS, PR_TOPIC_K)) + 0.1).astype(np.float32)
    gates = dict(followed_topics=rng.choice(PR_TOPICS, 16, False).astype(np.int32),
                 not_interested_topics=rng.choice(PR_TOPICS, 16, False).astype(np.int32),
                 topic_allowed=rng.random(PR_TOPICS) < 0.9, quality_scores=rng.random(PR_TOPICS).astype(np.float32))
    tcfg = tsps.TopicSocialProofConfig(min_relevance=0.01)

    def run(d, n=PR_TWEETS):
        tw = SparseEmbedding(torch.from_numpy(t_ids[:n]).to(d), torch.from_numpy(t_sc[:n]).to(d))
        tp = SparseEmbedding(torch.from_numpy(topic_ids).to(d), torch.from_numpy(topic_sc).to(d))
        g = {k: torch.from_numpy(v).to(d) for k, v in gates.items()}
        return tw, tp, g, tsps.topic_social_proof_batch(tw, tp, min_quality=0.2, config=tcfg, **g)

    *_, card_out = run(dev)
    *_, cpu_out = run("cpu")
    ids, rel, fol = (x.cpu().numpy() for x in card_out)
    require((ids != PAD_ID).sum() > PR_TWEETS, "TSPS assigned almost no topics")
    ts_moved = check_same_ranking(ids, rel, cpu_out[0].numpy(), cpu_out[1].numpy(), PR_RTOL, PR_ATOL,
                                  "TSPS, card against CPU")
    same = ids == cpu_out[0].numpy()
    require(np.array_equal(fol[same], cpu_out[2].numpy()[same]), "TSPS followed masks differ from the CPU's")
    tw, tp, g, _ = run(dev, 4)
    nb = {k: v for k, v in g.items() if k in ("followed_topics", "not_interested_topics")}
    batch = tsps.topic_social_proof_batch(tw, tp, config=tcfg, **nb)
    for b in range(4):
        one = tsps.topic_social_proof(SparseEmbedding(tw.ids[b], tw.scores[b]), tp, config=tcfg, **nb)
        require(torch.equal(one[0], batch[0][b]) and torch.allclose(one[1], batch[1][b], rtol=1e-6, atol=0)
                and torch.equal(one[2], batch[2][b]), f"TSPS tweet {b}: the batch form is not the single form")
    print(f"products: timeline ranker, {PR_TLR_USERS} users x (get_ranked_timeline, the two-tier SuperRoot form) "
          f"over the {cand[0].shape.eb_docs}-doc index and the UTEG graph: launches {launches} (1 + 1 a call, as "
          f"derived), card against the port on the CPU, {moved} ranks apart among near-ties; TSPS, {PR_TWEETS} SANN "
          f"tweets (K={t_ids.shape[1]}) against {PR_TOPICS} topics (K={PR_TOPIC_K}) with every gate, "
          f"{int((ids != PAD_ID).sum())} assignments, card against CPU ({ts_moved} ranks among near-ties), the batch "
          f"equal to the single form for 4 tweets; host clock TLR {t_tlr:.2f} s, TSPS {time.perf_counter() - t1:.2f} "
          f"s (not a benchmark)")
    return launches


def products_actions(dev, cand, frs):
    """PR_EVENTS raw events over every adapter, a planted fav burst and a
    follow, through adapt → run_staged → route; the feeds folded into a copy
    of the candidate world's UTEG graph and of the FRS world's RealGraph
    table, card against CPU; the planted tweet retrieved by uteg.recommend
    (1 + 1 launches) and the follow among top_edges. Returns the launches."""
    t0 = time.perf_counter()
    fyw, graph = cand[0], cand[2]
    user = PR_BASE
    seeds = fyw.seeds[user % fyw.shape.num_users]
    planted = fyw.shape.tweet_space - 1
    now_ms = foryou_world.NOW * 1000
    events = frs_world.raw_events(59, PR_EVENTS, frs.shape)
    events += [("tls_favs", {"fav_type": "fav", "user_id": int(s), "tweet_id": planted, "ts_ms": now_ms - 500})
               for s in seeds]
    row = set(frs.realgraph.neighbor_ids[user].cpu().tolist())
    followee = next(a for a in range(frs.shape.num_authors) if a not in row and a != user)
    events.append(("social_graph", {"op": "follow", "source_id": user, "target_id": followee, "ts_ms": now_ms - 400}))

    def feed():
        acts = [a for k, e in events for a in ua.adapt(k, e)]
        res = en.run_staged(acts, frs_world.ENRICH_PLAN, frs_world.AuthorHydrator(frs.shape.num_authors,
                                                                                  frs.shape.tweet_space))
        return acts, res, ri.route([e.action for e in res.final])

    acts, res, feeds = feed()
    _, _, again = feed()
    for name in ("uteg", "simclusters_favs", "realgraph"):
        for k, v in getattr(feeds, name).items():
            require(np.array_equal(v, getattr(again, name)[k]), f"actions: the {name} feed is not deterministic")
    u = feeds.uteg
    g_card = uteg.record_engagements(graph, u["user_ids"], u["tweet_ids"], u["types"], u["timestamps"])
    g_cpu = uteg.record_engagements(to_cpu(graph), u["user_ids"], u["tweet_ids"], u["types"], u["timestamps"])
    require(all(torch.equal(a.cpu(), b) for a, b in zip(g_card, g_cpu)), "actions: UTEG folded apart on the card")
    r = feeds.realgraph
    args = (r["src"], r["dst"], r["interaction_type"], r["timestamps"])
    t_card = realgraph.apply_interactions(frs.realgraph, *args)
    t_cpu = realgraph.apply_interactions(frs.to("cpu").realgraph, *args)
    require(all(torch.equal(a.cpu(), b) for a, b in zip(t_card, t_cpu)), "actions: RealGraph folded apart")
    s = torch.from_numpy(seeds[None]).to(dev)
    zero_counts()
    ids, scores, proof = uteg.recommend(g_card, s, torch.ones(s.shape, device=dev), max_results=UTEG_RESULTS)
    launches = counts()
    require(launches == {"run_collapse": 1, "row_gather": 1, "run_collapse_rows": 0},
            f"actions: recommend launches {launches}")
    require(int(ids[0, 0]) == planted, f"actions: the planted tweet {planted} is not the top of {ids[0, :4].tolist()}")
    cpu_ids, cpu_scores, _ = uteg.recommend(g_cpu, s.cpu(), torch.ones(s.shape), max_results=UTEG_RESULTS)
    check_same_ranking(ids.cpu().numpy(), np.where(torch.isfinite(scores).cpu().numpy(), scores.cpu().numpy(), 0),
                       cpu_ids.numpy(), np.where(torch.isfinite(cpu_scores).numpy(), cpu_scores.numpy(), 0),
                       PR_RTOL, PR_ATOL, "actions: recommend, card against CPU")
    top, _ = realgraph.top_edges(t_card, frs.rg_params, user, foryou_world.NOW, frs.shape.realgraph_degree)
    require(followee in top.tolist(), f"actions: the injected follow {user} -> {followee} is not among top_edges")
    print(f"products: actions, {len(events)} raw events over {len({k for k, _ in events})} adapters -> {len(acts)} "
          f"actions -> {len(res.final)} enriched ({len(res.dead_letters)} dead letters, {res.partitioned_batches} "
          f"partitioned batches) -> feeds UTEG {len(u['user_ids'])}, SimClusters favs "
          f"{len(feeds.simclusters_favs['user_ids'])}, RealGraph {len(r['src'])} (the same on a second pass); folded "
          f"on the card and on the CPU alike; user {user}'s {len(seeds)} seeds' injected favs put tweet {planted} "
          f"first of uteg.recommend (proof {float(proof[0, 0]):.0f}; launches {launches}); the injected follow "
          f"{user} -> {followee} among top_edges; host clock {time.perf_counter() - t0:.2f} s (not a benchmark)")
    return launches


def recorded(module, name, call):
    """The arguments of every call of ``module.name`` while ``call()`` runs."""
    real, seen = getattr(module, name), []

    def rec(*args):
        seen.append(args)
        return real(*args)

    rec.launches = 0
    setattr(module, name, rec)
    try:
        call()
    finally:
        setattr(module, name, real)
    torch.cuda.synchronize()
    return seen


def products_kernel_times(dev, frs):
    """The kernels at the products' new shapes against their plain versions
    (device time over warm calls, plain and kernel in one profiler session):
    SALSA's collapse [1, 1,048,576] and its second-hop gather, the sims
    expansion's collapse, the T&S embedding gather and its gradient."""
    r = frs.request(PR_BASE)
    card = frs.device_sources()
    salsa_rc = recorded(retrieval, "run_collapse_sorted", lambda: card["salsa"](r))
    salsa_rg = recorded(fc, "row_gather", lambda: card["salsa"](r))
    exp_rc = recorded(retrieval, "run_collapse_sorted", lambda: card["sims_expansion"](r))
    out = {}
    e = salsa_rc[0]
    out["salsa collapse"] = time_collapse(e, "SALSA's sorted walk entries", copy_yardstick=False)
    out["sims expansion collapse"] = time_collapse(exp_rc[0], "the sims expansion's sorted entries",
                                                   copy_yardstick=False)
    ids, table = salsa_rg[1][0], salsa_rg[1][1]
    out["salsa hop 2"] = time_gather(ids.reshape(-1).contiguous(), (table,),
                                     f"SALSA's second hop: {ids.numel()} rows x {table.shape[1] * 4} B")
    cfg, rc = ts.TextEncoderConfig(), tst.RecipeConfig()
    model = ts.TextSafetyModel(cfg, device=dev)
    tokens, mask, labels = ts_pool(61)
    tok = torch.from_numpy(tokens[:rc.batch_size]).to(dev)
    msk = torch.from_numpy(mask[:rc.batch_size]).to(dev)

    def step():
        model.zero_grad()
        tst.weighted_bce(model(tok, msk), torch.from_numpy(labels[:rc.batch_size]).to(dev),
                         torch.ones(3, device=dev), torch.ones(rc.batch_size, device=dev)).backward()

    seen_rg = recorded(gather, "row_gather", step)  # the table read's forward
    seen_rcr = recorded(gather, "run_collapse_rows", step)  # and its gradient
    ids, table = seen_rg[0][0], seen_rg[0][1].detach()
    out["T&S embedding"] = time_gather(ids.reshape(-1).contiguous(), (table,),
                                       f"the T&S token embedding: {ids.numel()} ids x {table.shape[1] * 4} B")
    sid, perm, dy, n = seen_rcr[0]
    out["T&S embedding gradient"] = time_collapse_rows(sid, perm, dy.detach(), n,
                                                       f"the T&S embedding gradient ({sid.numel()} ids into "
                                                       f"[{n}, {dy.shape[1]}])")
    return out


def phase_products(dev, fy, cand, world):
    """The other products on the card over the For You, candidate and SANN
    worlds (``fy["frs"]`` the FRS world built before run B). Returns the
    launches by path."""
    t_phase = time.perf_counter()
    frs = fy["frs"]
    print(f"products: {card_line()}; FRS world {frs.shape.num_users} users, {frs.shape.num_authors} authors, sims "
          f"top {frs.shape.sims_top_k}")
    clock = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        clock[name] = time.perf_counter() - t0
        return out

    by_path = {"frs": step("FRS", products_frs, dev, frs)}
    by_path["trust_safety"], trained = step("T&S recipe", products_ts_training, dev)
    step("T&S serving", products_ts_serving, dev)
    by_path["push"] = step("push", products_push, dev, fy, cand, frs, trained)
    by_path["timeline_ranker"] = step("TLR and TSPS", products_tlr_tsps, dev, cand, frs, world)
    by_path["actions"] = step("actions", products_actions, dev, cand, frs)
    times = step("kernel times", products_kernel_times, dev, frs)
    print("products: host clock by step (not a benchmark): " + ", ".join(f"{k} {v:.1f} s" for k, v in clock.items()))
    print("products: new kernel shapes (device time; " + card_line() + "): " + "; ".join(
        f"{k} {v['device_ms']:.4f} ms (plain {v['plain_device_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms)"
        for k, v in times.items()))
    print(f"products: {card_line()}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return by_path


# the write path: tweetypie's write service wired by ingester_fanout
# to an earlybird ingester at the For You world's index capacity, every step
# held column by column against the same events replayed through the port on
# the CPU (documents built on the host alike, ingested there as micro-batches:
# while a batch fits the ring, the ring makes the two indexes equal); then
# persistence, and the served paths over the ingested index
WP_CAPACITY = foryou_world.FULL.eb_docs  # 262,144 docs, the For You world's index
WP_TOKENS = foryou_world.FULL.eb_tokens
WP_POSTS, WP_EDITS, WP_DELETES, WP_UNDELETES, WP_TAKEDOWNS = 4096, 64, 64, 16, 16
WP_ENGAGEMENTS = 16_384  # UUA actions
WP_SUSPENDED = 32  # authors
WP_T0 = 100_000  # creation times from here, 8 posts a second: ids (now << 12) | seq stay below 2**31
WP_DEPTH = 4  # reply chains up to this depth
WP_TAIL = 256  # posts ingested while the Following product serves, then replayed onto the flushed snapshot
WP_CHUNK = 32  # the tail's posts between two served batches
WP_UPDATES = 4096  # ids of the feature-update batches
WP_FOLLOWING = 8  # Following timelines held against the CPU
WP_R = 32  # the For You batch over the ingested index
WP_CPU_R = 4  # its requests whose f32 scores are held against the CPU
WP_LAUNCHES = {"run_collapse": 1, "row_gather": 16}  # that batch's (FY_LAUNCHES): the write path itself launches none
WP_WORDS = ("hello", "timeline", "earlybird", "ranking", "write", "path", "tweet", "graph", "news", "sports")
WP_LATE = foryou_world.NOW  # fault 10: a post at bench.py's clock gets an id past 2**31


class RecordingIngester(ing.EarlybirdIngester):
    """The ingester, recording every write call in order, so the same
    events can be replayed through the port on the CPU."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = []

    def ingest_tweets(self, tweets, *, now=0):
        self.calls.append(("ingest", list(tweets), now))
        return super().ingest_tweets(tweets, now=now)

    def delete_tweets(self, tweet_ids):
        self.calls.append(("delete", list(tweet_ids)))
        return super().delete_tweets(tweet_ids)

    def apply_engagements(self, actions):
        self.calls.append(("engage", list(actions)))
        return super().apply_engagements(actions)


def replay_on_cpu(cpu, calls):
    """``calls`` through the port on the CPU: each ingest call's documents
    built as the card's were (same tweets, same ``now``), consecutive ones
    ingested as one micro-batch; consecutive deletes as one call."""
    docs, dels = [], []

    def flush():
        if docs:
            cpu.index = earlybird.ingest(cpu.index, *(torch.cat(c) for c in zip(*docs)))
            cpu.log_offset += sum(d[0].shape[0] for d in docs)
            docs.clear()
        if dels:
            cpu.delete_tweets(dels)
            dels.clear()

    for call in calls:
        if call[0] == "ingest":
            try:
                ing.check_tweet_ids(t.tweet_id for t in call[1])
            except ValueError:
                continue  # refused on the card before anything was built
            if dels:
                flush()
            docs.append(earlybird.build_documents(call[1], cpu.config, ui_language=cpu.ui_language,
                                                  now=call[2])[:5])
        elif call[0] == "delete":
            if docs:
                flush()
            dels.extend(call[1])
        else:
            flush()
            cpu.apply_engagements(call[1])
    flush()
    calls.clear()


def same_index(card, cpu, what):
    """Every column of the card's index equal to the CPU's (ints bit-equal;
    features too: documents are built on the host and increments pre-summed
    in one order)."""
    for name in ("tokens", "author", "created_ts", "features", "tweet_ids"):
        a, b = getattr(card, name).cpu(), getattr(cpu, name)
        require(torch.equal(a, b), f"write path, {what}: the card's {name} column differs from the CPU's "
                                   f"at {int((a != b).reshape(a.shape[0], -1).any(1).sum())} slots")
    require(card.write_pos == cpu.write_pos, f"write path, {what}: write_pos {card.write_pos} against {cpu.write_pos}")


def wp_text(rng):
    words = [WP_WORDS[i] for i in rng.integers(0, len(WP_WORDS), int(rng.integers(3, 9)))]
    if rng.random() < 0.3:
        words.append(f"#{WP_WORDS[int(rng.integers(len(WP_WORDS)))]}")
    if rng.random() < 0.2:
        words.append(f"https://t.co/{int(rng.integers(1 << 20)):x}")
    return " ".join(words)


def wp_posts(svc, rng, n, t0, authors):
    """``n`` posts, 8 a second from ``t0``: roots, replies (chains up to
    WP_DEPTH), quotes and media. Returns the new tweets."""
    depth, out = {}, []
    live = [t for t in svc.store._tweets.values() if not t.deleted]
    for i in range(n):
        pool = live + out
        kw = {}
        r = rng.random()
        if pool and r < 0.35:
            parent = pool[int(rng.integers(len(pool)))]
            if depth.get(parent.tweet_id, 0) < WP_DEPTH and not parent.deleted:
                kw["reply_to"] = parent.tweet_id
        elif pool and r < 0.45:
            q = pool[int(rng.integers(len(pool)))]
            if not q.deleted:
                kw["quoted_tweet_id"] = q.tweet_id
        if rng.random() < 0.2:
            kw["media"] = (("img.jpg",), ("clip.mp4",), ("a.png", "b.m3u8"))[int(rng.integers(3))]
        t = svc.post_tweet(int(authors[int(rng.integers(len(authors)))]), wp_text(rng), now=t0 + i // 8, **kw)
        depth[t.tweet_id] = depth.get(kw.get("reply_to"), -1) + 1 if "reply_to" in kw else 0
        out.append(t)
    return out


def conversation_chain(store):
    """The Following product's conversation resolver: a candidate's reply
    chain walked up the store's ``reply_to`` links, root first (as the JAX
    test's stand-in, tests/test_home_products.py:150-159)."""
    def chain(c):
        out, t = [c], store._tweets.get(int(c.id))
        while t is not None and t.reply_to is not None:
            t = store._tweets.get(t.reply_to)
            if t is None:
                break
            out.insert(0, Candidate(id=t.tweet_id, features={"author_id": t.author_id}))
        return out
    return chain


def following_json(index, svc, q):
    """The Following product over ``index`` (one version), marshalled."""
    pipe = hp.build_following_pipeline(index=index, conversation_resolver=conversation_chain(svc.store),
                                       edit_chains=svc.edits)
    tl = pipe.run(copy.deepcopy(q))
    return tl, urt.marshal_timeline(tl).to_json()


def store_lift(lift, store, t0=0):
    """``lift``, with an ingested tweet's author and creation time less
    ``t0`` from the store (bench.py's metadata lift for every other id,
    creation times below SPREAD_TS)."""
    ids = np.fromiter(store._tweets.keys(), np.int64, len(store._tweets))
    order = np.argsort(ids)
    ids = ids[order]
    authors = np.asarray([t.author_id for t in store._tweets.values()], np.int64)[order]
    created = np.asarray([t.created_ts for t in store._tweets.values()], np.int64)[order]

    def attach(c):
        pos = np.clip(np.searchsorted(ids, c.ids), 0, len(ids) - 1)
        hit = ids[pos] == c.ids
        c.cols.setdefault("author_id", np.where(hit, authors[pos], c.ids % FY_WORLD["num_authors"]))
        c.cols.setdefault("created_ts", np.where(hit, created[pos] - t0, c.ids % SPREAD_TS))
        return lift(c)
    return attach


def ingested_rank(scorer, cols, ingested):
    """The ingested candidates' mean rank among their request's candidates
    by ``scorer``'s combined score, as a share (0 the top, 1 the bottom),
    and how many of them make their request's top FY_TOP_K."""
    shares, top = [], 0
    for (_, c, n), (_, combined) in zip(cols, scorer.score_columnar(cols)):
        n = min(n, combined.shape[0])  # the slots the scorer pads to
        rank = np.argsort(np.argsort(-combined[:n], kind="stable"), kind="stable")
        hit = np.isin(c["ids"][:n], np.fromiter(ingested, np.int64, len(ingested)))
        shares.extend(rank[hit] / max(n - 1, 1))
        top += int((rank[hit] < FY_TOP_K).sum())
    return float(np.mean(shares)), top


def wp_script(dev, svc, card, cpu, rng, authors):
    """The write steps, each held card against CPU. Returns the posts, the
    edits and the suspended authors."""
    t0 = time.perf_counter()
    posts = wp_posts(svc, rng, WP_POSTS, WP_T0, authors)
    torch.cuda.synchronize()
    t_posts = time.perf_counter() - t0
    require(not svc.hook_failures and card.log_offset == WP_POSTS, f"write path: {svc.hook_failures} hook errors")
    replay_on_cpu(cpu, card.calls)
    same_index(card.index, cpu.index, f"after {WP_POSTS} posts")
    roots = [t for t in posts if t.reply_to is None]
    edited = [roots[int(i)] for i in rng.choice(len(roots), WP_EDITS, replace=False)]
    t_edit = posts[-1].created_ts + 1  # ids are time-ordered: a write at an earlier second could repeat one
    versions = [svc.edit_tweet(t.tweet_id, wp_text(rng) + " (edited)", now=t_edit + i // 8)
                for i, t in enumerate(edited)]
    replay_on_cpu(cpu, card.calls)
    same_index(card.index, cpu.index, f"after {WP_EDITS} edits")
    live = [t for t in posts if t.tweet_id not in {e.tweet_id for e in edited}]
    gone = [live[int(i)] for i in rng.choice(len(live), WP_DELETES - 8, replace=False)] + edited[:8]
    deleted = [v for t in gone for v in svc.delete_tweet(t.tweet_id)]  # an edited tweet: every version
    replay_on_cpu(cpu, card.calls)
    same_index(card.index, cpu.index, f"after {len(gone)} deletes ({len(deleted)} versions)")
    back = gone[-WP_UNDELETES:]
    restored = [v for t in back for v in svc.undelete_tweet(t.tweet_id)]
    replay_on_cpu(cpu, card.calls)
    same_index(card.index, cpu.index, f"after {len(back)} undeletes ({len(restored)} versions)")
    for t in edited[8:8 + WP_TAKEDOWNS]:
        svc.takedown(t.tweet_id, ["de"])
        require(all(svc.takedowns.is_withheld(v, "DE") for v in svc.edits.versions(t.tweet_id)),
                "write path: a takedown missed a version of its edit chain")
    same_index(card.index, cpu.index, f"after {WP_TAKEDOWNS} takedowns (the index untouched)")
    A = ing.ActionType
    kinds = (A.CLIENT_TWEET_FAV, A.SERVER_TWEET_FAV, A.CLIENT_TWEET_UNFAV, A.CLIENT_TWEET_RETWEET,
             A.SERVER_TWEET_REPLY, A.CLIENT_TWEET_QUOTE, A.CLIENT_PROFILE_VISIT)
    targets = [t.tweet_id for t in posts + versions]
    actions = [ing.UnifiedUserAction(user_id=int(u), action_type=kinds[int(k)],
                                     item_id=int(targets[int(i)]) if i < len(targets) else 12345 + int(i),
                                     timestamp_ms=0)
               for u, k, i in zip(rng.integers(0, FY_WORLD["num_users"], WP_ENGAGEMENTS),
                                  rng.integers(0, len(kinds), WP_ENGAGEMENTS),
                                  rng.integers(0, len(targets) + 64, WP_ENGAGEMENTS))]
    touched = card.apply_engagements(actions)
    replay_on_cpu(cpu, card.calls)
    same_index(card.index, cpu.index, f"after {WP_ENGAGEMENTS} UUA actions ({touched} (id, column) cells)")
    suspended = [int(a) for a in rng.choice(authors, WP_SUSPENDED, replace=False)]
    for g in (card, cpu):
        g.apply_user_updates({a: ing.AuthorState.SUSPENDED for a in suspended})
    mask = card.visible_author_mask()
    require(torch.equal(mask.cpu(), cpu.visible_author_mask()) and not bool(mask.all()),
            "write path: the author masks differ, or no doc is masked")
    print(f"write_path: {WP_POSTS} posts ({len(roots)} roots, {sum(t.reply_to is not None for t in posts)} replies "
          f"up to depth {WP_DEPTH}, {sum(t.quoted_tweet_id is not None for t in posts)} quotes, "
          f"{sum(bool(t.media) for t in posts)} with media; creation times {WP_T0}-{posts[-1].created_ts} s), "
          f"{WP_EDITS} edits, {len(gone)} deletes ({len(deleted)} versions), {len(back)} undeletes "
          f"({len(restored)} versions), {WP_TAKEDOWNS} chain-scoped takedowns, {WP_ENGAGEMENTS} UUA actions "
          f"({touched} (id, column) cells), {WP_SUSPENDED} authors suspended: after each step the card's "
          f"[{WP_CAPACITY}]-doc index equal to the CPU's, every column (features bit-equal); per-event fanout "
          f"{WP_POSTS / t_posts:.0f} posts/s on the host clock (store, documents, one ingest each)")
    return posts, versions, suspended


def wp_serving(dev, fy, svc, card, cpu, posts, versions, suspended):
    """The Following product, the For You batch and search over the ingested
    index, card against CPU. Returns the batch's launches."""
    # the Following product: conversation modules and edited-tweet instructions
    follows = fy["follows"]
    authors_of = {}
    for t in posts:
        authors_of.setdefault(t.author_id, []).append(t)
    stale = [t.tweet_id for t in posts if svc.edits.is_stale(t.tweet_id)]
    modules = replaced = 0
    for u in range(WP_FOLLOWING):
        q = hp.TimelineQuery(user_id=FY_WORLD["num_users"] - 1 - u, followed_authors=follows[u],
                             served_tweet_ids=stale[:8], max_results=40, last_polling_ts=WP_T0 + 256)
        tl, got = following_json(card.index, svc, q)
        _, want = following_json(cpu.index, svc, q)
        require(got == want, f"write path: user {u}'s Following timeline differs between the card and the CPU")
        modules += sum(e.kind == EntryKind.MODULE and e.module.kind == "conversation" for e in tl.entries)
        replaced += sum(i.op == "replace_entry" for i in tl.instructions)
    require(modules > 0 and replaced > 0, f"write path: {modules} conversation modules, {replaced} replace_entry")

    # search with the author mask
    q = earlybird.SearchQuery(tokens=torch.from_numpy(earlybird.tokenize("hello tweet", WP_TOKENS)),
                              require_all=False, min_ts=0, max_ts=WP_LATE)
    ids, scores = card.search(q.to(dev), max_results=EB_RESULTS)
    want_ids, want_scores = cpu.search(q, max_results=EB_RESULTS)
    moved = check_same_ranking(ids.cpu().numpy()[None], scores.cpu().numpy()[None], want_ids.numpy()[None],
                               want_scores.numpy()[None], EB_RTOL, EB_ATOL, "write path: masked search")
    author = {t.tweet_id: t.author_id for t in svc.store._tweets.values()}
    served = [author[int(i)] for i in ids.cpu().tolist() if i != PAD_ID]
    bare, _ = earlybird.search(card.index, q.to(dev), max_results=2 * WP_POSTS)  # every matching doc
    unmasked = {author[int(i)] for i in bare.cpu().tolist() if i != PAD_ID}
    require(served and not set(served) & set(suspended) and unmasked & set(suspended),
            "write path: the masked search served a suspended author, or the mask hid nothing")

    # one R=32 For You batch whose earlybird source scans the ingested index. The posts are dated from WP_T0
    # (their ids stay below 2**31: fault 10) and every other candidate below SPREAD_TS; created_ts is a raw ranker
    # input, so the lift moves the posts onto the others' clock (WP_T0 earlier: below SPREAD_TS too, in order)
    s = fy["sources"]
    eb_card = bf.EarlybirdBatchSource(card.index, foryou_world.NOW, max_results=EB_RESULTS)
    eb_cpu = bf.EarlybirdBatchSource(cpu.index, foryou_world.NOW, max_results=EB_RESULTS)
    sources = [s[0], eb_card, s[2], s[3]]

    def engine(scorer, lift=store_lift(fy["lift"], svc.store, WP_T0)):
        return bf.BatchedForYouEngine(batch_sources=sources, scorer=scorer, head_names=masknet.DEFAULT_HEAD_NAMES,
                                      lift=lift, max_age_s=10 ** 9)

    batch = [ForYouQuery(user_id=u, followed_authors=follows[u], max_results=FY_TOP_K, now=foryou_world.NOW)
             for u in range(WP_R)]
    served_engine = engine(fy["served"].scorer)
    served_engine.serve_batch(batch)  # warm
    torch.cuda.synchronize()
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    out = served_engine.serve_batch(batch)
    torch.cuda.synchronize()
    launches = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                "row_gather": _build.launches(gather.row_gather)}
    require(launches == WP_LAUNCHES, f"write path: the For You batch launched {launches}, want {WP_LAUNCHES}")
    require(len(out) == WP_R and all(0 < len(o) <= FY_TOP_K for o in out), "write path: a For You list empty")
    got_eb, want_eb = eb_card.collect(eb_card.dispatch(batch, None)), eb_cpu.collect(eb_cpu.dispatch(batch, None))
    width = max(len(c.ids) for c in want_eb)

    def padded(cols):
        i = np.full((len(cols), width), PAD_ID, np.int32)
        v = np.zeros((len(cols), width), np.float32)
        for r, c in enumerate(cols):
            i[r, :len(c.ids)], v[r, :len(c.ids)] = c.ids, c.scores
        return i, v

    eb_moved = check_same_ranking(*padded(got_eb), *padded(want_eb), EB_RTOL, EB_ATOL,
                                  "write path: the ingested index's in-network leg")
    ingested = {t.tweet_id for t in posts + versions}
    merged, _ = served_engine.columns(batch)
    n_ingested = sum(len(set(c.ids.tolist()) & ingested) for c in got_eb)
    scored_ingested = sum(len(set(c.ids.tolist()) & ingested) for c in merged)
    served_ingested = sum(c.id in ingested for o in out for c in o)
    require(n_ingested > 0 and scored_ingested == n_ingested and served_ingested > 0,
            f"write path: {n_ingested} ingested candidates from the in-network leg, {scored_ingested} scored, "
            f"{served_ingested} served")
    f32 = engine(fy["host_select"].scorer)
    _, cols = f32.columns(batch[:WP_CPU_R])
    # the lift's part: the same requests ranked with the posts at the store's own creation times
    _, cols_store = engine(fy["host_select"].scorer, store_lift(fy["lift"], svc.store)).columns(batch[:WP_CPU_R])
    rank_redated, rank_store = (ingested_rank(fy["host_select"].scorer, c, ingested) for c in (cols, cols_store))
    cpu_scorer = fy["make_scorer"](masknet.MaskNet(fy["cfg32"], device="cpu"), torch.float32, None,
                                   fy["tables"].to("cpu"))
    cpu_scorer.model.load_state_dict(fy["ref"].state_dict())
    err, f_moved, gap = card_against_cpu(fy["host_select"].scorer, cpu_scorer, cols)
    del cpu_scorer
    print(f"write_path: the Following product over the ingested index ({WP_FOLLOWING} users, edit chains and a "
          f"reply-chain resolver over the store): URT JSON equal to the CPU's, {modules} conversation modules and "
          f"{replaced} replace_entry instructions; EarlybirdIngester.search with the author mask: "
          f"{len(served)} results, none by the {WP_SUSPENDED} suspended authors (the bare scan serves "
          f"{len(unmasked & set(suspended))} of them), the CPU's ranking ({moved} ranks apart among near-ties); one "
          f"R={WP_R} For You batch over it: launches {launches} (as derived: the write path launches none), "
          f"its in-network leg the CPU's ({eb_moved} ranks apart among near-ties; {n_ingested} ingested "
          f"candidates, all scored, {served_ingested} in the served top-{FY_TOP_K}s; over {WP_CPU_R} requests in "
          f"f32 the ingested candidates' mean rank share {rank_redated[0]:.3f} (0 the top), {rank_redated[1]} in the "
          f"top-{FY_TOP_K}s, against {rank_store[0]:.3f} and {rank_store[1]} at the store's creation times, "
          f"~{WP_T0} s), f32 scores of {WP_CPU_R} requests within rel {err:.3g} of the CPU's (rtol {FY_RTOL}; "
          f"top-{FY_TOP_K} {f_moved} ranks apart among near-ties)")
    return launches


def wp_persistence(dev, svc, card, cpu, rng, authors, root):
    """Flush and load; a tail posted while the Following product serves
    from another thread, each served batch held against the CPU on the index
    version it read, then replayed onto the snapshot; roll-off; feature
    updates at B = WP_UPDATES."""
    path = os.path.join(root, "segment.npz")
    t0 = time.perf_counter()
    pers.flush_index(card.index, path, card.log_offset)
    t_flush = time.perf_counter() - t0
    loaded, offset = pers.load_index(path, device=dev)
    same_index(loaded, cpu.index, "flushed and loaded")
    require(offset == card.log_offset, "write path: the snapshot's log offset")

    # the tail, ingested per event while another thread serves Following timelines
    q = hp.TimelineQuery(user_id=0, followed_authors=list(authors[:64]), max_results=40)
    seen, done = [], threading.Event()

    def serve():
        while not done.is_set() or not seen:
            v = card.index  # one version a batch
            seen.append((v, following_json(v, svc, q)[1]))

    reader = threading.Thread(target=serve)
    reader.start()
    tail = []
    try:
        for c in range(WP_TAIL // WP_CHUNK):  # a chunk after each batch the reader finishes
            n = len(seen)
            while len(seen) == n and reader.is_alive():
                time.sleep(0.001)
            tail += wp_posts(svc, rng, WP_CHUNK, WP_T0 + WP_POSTS // 8 + 60 + c * WP_CHUNK // 8, authors[:64])
    finally:
        done.set()
        reader.join()
    calls = list(card.calls)
    replay_on_cpu(cpu, card.calls)
    same_index(card.index, cpu.index, f"after the {WP_TAIL}-post tail")
    versions = {}
    for v, got in seen:
        if id(v) not in versions:
            versions[id(v)] = earlybird.EarlybirdIndex(*(to_cpu(x) for x in v[:5]), v.write_pos)
        require(got == following_json(versions[id(v)], svc, q)[1],
                "write path: a Following batch served during ingest differs from the CPU on its index version")
    require(len(versions) >= 2, f"write path: the served batches read {len(versions)} index version(s)")
    docs = [earlybird.build_documents(c[1], card.config, now=c[2])[:5] for c in calls if c[0] == "ingest"]
    tail_docs = tuple(torch.cat(c) for c in zip(*docs))
    replayed, new_offset = pers.load_index(path, replay=lambda off: (*tail_docs, off + len(tail)), device=dev)
    same_index(replayed, cpu.index, f"the snapshot with the {WP_TAIL}-post tail replayed")
    require(new_offset == card.log_offset, "write path: the replayed log offset")

    # roll-off: the older half into an archive tier
    live = cpu.index.author != PAD_ID
    cut = int(cpu.index.created_ts[live].float().median())
    arch_cfg = earlybird.EarlybirdConfig(capacity=WP_CAPACITY, max_tokens=WP_TOKENS)
    rolled = pers.roll_expired(card.index, earlybird.init_index(arch_cfg, dev), now=cut + 3600, retention_s=3600)
    want = pers.roll_expired(cpu.index, earlybird.init_index(arch_cfg, "cpu"), now=cut + 3600, retention_s=3600)
    same_index(rolled[0], want[0], "the realtime tier after roll-off")
    same_index(rolled[1], want[1], "the archive tier after roll-off")
    require(rolled[2] == want[2] and abs(rolled[2] - int(live.sum()) / 2) < 0.1 * int(live.sum()),
            f"write path: {rolled[2]} docs rolled of {int(live.sum())}")

    # feature updates at B = WP_UPDATES: ids in the ring (some twice), misses; small whole deltas sum exactly
    ids = cpu.index.tweet_ids[live].numpy()
    pick = np.r_[rng.choice(ids, WP_UPDATES - 512), rng.integers(1, 1 << 20, 512)].astype(np.int32)
    cols = rng.integers(0, len(earlybird.DOC_FEATURES), WP_UPDATES).astype(np.int32)
    vals = rng.integers(-4, 5, WP_UPDATES).astype(np.float32)
    for name, fn in (("increment_feature", pers.increment_feature), ("apply_feature_updates",
                                                                     pers.apply_feature_updates)):
        if name == "apply_feature_updates":  # one value a (slot, column): a set with repeats is unspecified
            _, first = np.unique(np.stack([pick, cols], 1), axis=0, return_index=True)
            pick, cols, vals = pick[np.sort(first)], cols[np.sort(first)], vals[np.sort(first)]
        got = fn(card.index, *(torch.from_numpy(a).to(dev) for a in (pick, cols, vals)))
        same_index(got, fn(cpu.index, *(torch.from_numpy(a) for a in (pick, cols, vals))), name)
    print(f"write_path: flushed ({t_flush:.1f} s, {os.path.getsize(path) / 1e6:.1f} MB .npz) and loaded equal; "
          f"{WP_TAIL} posts ingested per event while {len(seen)} Following batches served from another thread, "
          f"each equal to the CPU's on the index version it read ({len(versions)} versions); the tail replayed onto "
          f"the snapshot equal to the live index; roll_expired moved {rolled[2]} of {int(live.sum())} live docs "
          f"into an archive index, both tiers equal to the CPU's; increment_feature ({WP_UPDATES} ids, 512 misses) "
          f"and apply_feature_updates ({len(pick)} distinct cells) equal to the CPU's")


def phase_write_path(dev, fy):
    """The write path on the card (see WP_*). Returns its launches."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(16)
    authors = np.arange(FY_WORLD["num_authors"], dtype=np.int64)
    cfg = earlybird.EarlybirdConfig(capacity=WP_CAPACITY, max_tokens=WP_TOKENS)
    svc = tweetypie.TweetWriteService()
    card = RecordingIngester(cfg, store=svc.store, device=dev)
    cpu = ing.EarlybirdIngester(cfg, store=svc.store, device="cpu")
    tweetypie.ingester_fanout(svc, card)
    posts, versions, suspended = wp_script(dev, svc, card, cpu, rng, authors)

    # the same posts as one batch on a fresh ingester: the micro-batch rate
    raws = [tweetypie.to_raw_tweet(svc.store, t, now=t.created_ts) for t in posts]
    batched = ing.EarlybirdIngester(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched.ingest_tweets(raws, now=WP_T0 + WP_POSTS // 8)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    del batched
    print(f"write_path: the same {WP_POSTS} tweets as one ingest_tweets batch: {WP_POSTS / t_batch:.0f} tweets/s "
          f"on the host clock (documents built on the host, one ingest)")

    launches = wp_serving(dev, fy, svc, card, cpu, posts, versions, suspended)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        wp_persistence(dev, svc, card, cpu, rng, authors, root)

    # fault 10: a post whose id passes int32 is refused by the ingester, recorded by the service
    before, errors = card.index, svc.hook_failures
    late = svc.post_tweet(1, "posted at bench.py's clock", now=WP_LATE)
    torch.cuda.synchronize()
    require(late.tweet_id >= 2 ** 31 and late.tweet_id in svc.store._tweets, "write path: the late post")
    require(svc.hook_failures == errors + 1 and isinstance(svc.hook_errors[-1][1], ValueError)
            and str(late.tweet_id) in str(svc.hook_errors[-1][1]),
            f"write path: fault 10 not recorded ({svc.hook_failures - errors} new hook errors)")
    require(card.index is before, "write path: the refused post changed the index")
    print(f"write_path: fault 10: a post at now={WP_LATE} (id {late.tweet_id}, past 2**31) was written to the "
          f"store and refused by the ingester; the service recorded \"{svc.hook_errors[-1][1]}\" and the index "
          f"is unchanged")
    print(f"write_path: {card_line()}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# the offline SimClusters jobs over a planted-community follow graph at
# the FRS world's user and author counts: the sims graph, KnownFor's
# iteration, InterestedIn, producer embeddings; and tweepcred over the FRS
# world's follow graph. Card against the port on the CPU on the same inputs.
OS_GRAPH = dict(num_users=16_384, num_producers=4_096, follows_per_user=48, num_communities=64, seed=16)
OS_SIMS_TOP = 64
OS_C = 256  # KnownFor clusters
OS_ITERS = 6
OS_MAX_CLUSTERS = 50  # InterestedIn's top clusters a user
OS_PRODUCER_K = (50, 100)  # top clusters a producer, top producers a cluster
OS_RECOVERY = 0.8  # assigned share and purity: the JAX test's bounds (tests/test_simclusters_offline.py:120-138)
OS_RTOL, OS_ATOL = 1e-5, 1e-6  # card against CPU: f32 sums in another order
OS_PR = dict(threshold=1e-6, max_iterations=50)  # tweepcred's PageRank
OS_PR_SUM = 1e-4
# run_collapse launches of the path, from the code: KnownFor 2 an iteration
# (cluster_stats' scatter, the [P, D] k = 4 row dedup) + 1 (final_scores'
# cluster_stats); InterestedIn 2 (the [U, D] k = 4 row dedup, the cluster
# norms' scatter); the producer matrix 1; tweepcred 1 an iteration
OS_LAUNCHES = {"known_for": 2 * OS_ITERS + 1, "interested_in": 2, "producer_embeddings": 1}
# k = 4 held against its plain version on every case of tests/test_torch_kernels.py's COLLAPSE_CASES
K4_CASES = [(5, 1, 0), (5, 3, 0), (5, 2048, 0), (5, 4095, 0), (5, 4096, 0), (5, 4097, 0),
            (5, seg_scan.MAX_CLUSTER * seg_scan.SHAPE.tile_max - 1, 0),
            (5, seg_scan.MAX_CLUSTER * seg_scan.SHAPE.tile_max + 1, 0), (5, 20_000, 0), (5, 200_000, 0),
            (1, 20_000, 0), (1000, 4097, 0), (5, 20_000, 1), (32, 256, 0), (256, 4096, 0)]


def k4_cases(dev):
    """run_collapse at k = 4 against its plain version on the kernel tests'
    cases (rows by q % 5: runs crossing every tile edge, a PAD tail, one
    run, random runs, all PAD; an offset of 1 slot off 16-byte alignment),
    both against float64 run totals: the kernel within rtol 1e-5 / atol
    1e-6, as tests/test_torch_kernels.py holds it; the plain version's
    scatter_add_ (atomics in no fixed order on the card) within m·2⁻²⁴·Σ|x|
    for a run of m terms, and the two within the sum of their bounds.
    Returns the largest |kernel - plain|."""
    worst = 0.0
    for Q, W, offset in K4_CASES:
        rng = np.random.default_rng(W + 4 + Q)
        tile = seg_scan._plan(Q, W, 4, torch.cuda.get_device_properties(dev).multi_processor_count).tile
        ids = np.sort(rng.integers(0, max(1, W // 5), size=(Q, W)).astype(np.int32), axis=1)
        for q in range(Q):
            kind = q % 5
            if kind == 0:
                ids[q] = (np.arange(W) + tile // 2) // tile
            elif kind == 1:
                ids[q, -(W // 5 + 1):] = PAD_ID
            elif kind == 2:
                ids[q] = 5
            elif kind == 4:
                ids[q] = PAD_ID
        vals = [rng.random((Q, W)).astype(np.float32) for _ in range(4)]
        args = []
        for a in (ids, *vals):
            t = torch.empty(a.size + offset, dtype=torch.from_numpy(a).dtype, device=dev)[offset:].view(a.shape)
            args.append(t.copy_(torch.from_numpy(a)))
        got = seg_scan.run_collapse_sorted(*args)
        want = seg_scan.run_collapse_sorted_plain(*args)
        require(torch.equal(got[0], want[0]), f"k=4 at [{Q}, {W}] offset {offset}: slots differ from plain")
        head = np.ones((Q, W), bool)
        head[:, 1:] = ids[:, 1:] != ids[:, :-1]
        last = np.ones((Q, W), bool)
        last[:, :-1] = head[:, 1:]
        last &= ids != PAD_ID
        run = np.cumsum(head.reshape(-1)) - 1
        terms = np.bincount(run)[run].reshape(Q, W)
        for g, w, v in zip(got[1:], want[1:], vals):
            v64 = v.reshape(-1).astype(np.float64)
            s64 = np.where(last, np.bincount(run, weights=v64)[run].reshape(Q, W), 0.0)
            mags = np.where(last, np.bincount(run, weights=np.abs(v64))[run].reshape(Q, W), 0.0)
            g, w = g.cpu().numpy(), w.cpu().numpy()
            kernel_bound = 1e-6 + 1e-5 * np.abs(s64)
            plain_bound = terms * 2.0 ** -24 * mags
            for x, bound, name in ((g, kernel_bound, "kernel"), (w, plain_bound, "plain")):
                err = np.abs(x - s64)
                require(bool((err <= bound).all()),
                        f"k=4 at [{Q}, {W}] offset {offset}: {name} sums off float64 by {err.max():.3g} "
                        f"(at most {bound.flat[np.argmax(err - bound)]:.3g} there)")
            diff = np.abs(g - w)
            require(bool((diff <= kernel_bound + plain_bound).all()),
                    f"k=4 at [{Q}, {W}] offset {offset}: kernel and plain apart by {diff.max():.3g}")
            worst = max(worst, float(diff.max()))
    return worst


def recovery(cluster, community):
    """(assigned share, mean purity of the clusters of 3 or more members)."""
    assigned = cluster >= 0
    purities = [np.bincount(community[cluster == c]).max() / (cluster == c).sum()
                for c in np.unique(cluster[assigned]) if (cluster == c).sum() >= 3]
    return float(assigned.mean()), float(np.mean(purities))


def counted_collapse(fn):
    """``fn()`` on the card with run_collapse_sorted's launches counted."""
    torch.cuda.synchronize()
    seg_scan.run_collapse_sorted.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, _build.launches(seg_scan.run_collapse_sorted)


def phase_offline_simclusters_alone(dev):
    """``chip_smoke.py --offline-simclusters``: the phase in a process of its
    own, over the FRS world built again from its seed. In the main process,
    after some 130 profiler sessions, the copy_ yardstick of the producer
    matrix's collapse saw 511 of 540 copies five times running (the limit is
    MIN_SEEN) and failed a whole run. Returns the launches."""
    return phase_offline_simclusters(dev, frs_world.build(device=dev))[0]


def phase_offline_simclusters(dev, frs):
    """The offline jobs on the card against the CPU (see OS_*), then the new
    k = 4 and one-row collapse shapes timed. Returns the launches and the
    kernel rows."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    world = synthetic.community_graph(synthetic.CommunityGraphConfig(**OS_GRAPH))
    U, P = OS_GRAPH["num_users"], OS_GRAPH["num_producers"]
    t_world = time.perf_counter() - t0
    pids = torch.from_numpy(world.producer_ids).to(dev)
    graph = sims_graph.symmetrize(sims_graph.cosine_similarity_graph(
        sims_graph.follow_matrix_from_adjacency(pids, P), top_k=OS_SIMS_TOP))
    graph_cpu = graph.to("cpu")
    init = known_for.initialize_random(torch.Generator(device=dev).manual_seed(OS_GRAPH["seed"]), P, OS_C)
    params = known_for.KnownForParams(num_clusters=OS_C)
    t0 = time.perf_counter()
    kf, n_kf = counted_collapse(lambda: known_for.iterate(graph, init, params, OS_ITERS))
    t_kf = time.perf_counter() - t0
    kf_cpu = known_for.iterate(graph_cpu, known_for.KnownFor(init.cluster.cpu(), init.score.cpu()), params, OS_ITERS)
    diff = int((kf.cluster.cpu() != kf_cpu.cluster).sum())
    require(diff == 0, f"offline: KnownFor's cluster ids differ between the card and the CPU at {diff} producers")
    require(torch.allclose(kf.score.cpu(), kf_cpu.score, rtol=OS_RTOL, atol=OS_ATOL), "offline: KnownFor scores")
    share, purity = recovery(kf.cluster.cpu().numpy(), world.producer_community)
    require(share > OS_RECOVERY and purity > OS_RECOVERY, f"offline: KnownFor recovered share {share:.3f}, "
                                                          f"purity {purity:.3f}")

    ff = interested_in.FollowFavGraph(*(torch.from_numpy(np.asarray(a)) for a in (
        world.producer_ids, world.followed, world.fav_score, world.log_fav_score)))
    ii_params = interested_in.InterestedInParams(num_clusters=OS_C, max_clusters_per_user=OS_MAX_CLUSTERS)
    t0 = time.perf_counter()
    ii, n_ii = counted_collapse(lambda: interested_in.interested_in_from_known_for(ff.to(dev), kf, ii_params))
    t_ii = time.perf_counter() - t0
    ii_cpu = interested_in.interested_in_from_known_for(ff, kf_cpu, ii_params)
    moved = check_same_ranking(ii.ids.cpu().numpy(), ii.fav_score.cpu().numpy(), ii_cpu.ids.numpy(),
                               ii_cpu.fav_score.numpy(), OS_RTOL, OS_ATOL, "offline: InterestedIn")
    same = ii.ids.cpu() == ii_cpu.ids  # the other scores, where the ranking put the same cluster
    for name in ("follow_score", "log_fav_score", "fav_cluster_normalized", "log_fav_cluster_normalized"):
        require(torch.allclose(getattr(ii, name).cpu()[same], getattr(ii_cpu, name)[same], rtol=OS_RTOL,
                               atol=OS_ATOL), f"offline: InterestedIn {name}")
    covered = float((ii.ids != PAD_ID).any(1).float().mean())

    kp, kc = OS_PRODUCER_K
    pe_args = (ff.producer_ids, ff.fav_score, ii_cpu.ids, ii_cpu.fav_cluster_normalized)
    t0 = time.perf_counter()
    emb, n_pe = counted_collapse(lambda: producer_embeddings.producer_embeddings_from_interested_in(
        *(a.to(dev) for a in pe_args), num_producers=P, num_clusters=OS_C, top_k_clusters=kp, top_k_producers=kc))
    t_pe = time.perf_counter() - t0
    dense = producer_embeddings.producer_cluster_matrix(*(a.to(dev) for a in pe_args), P, OS_C)
    dense_cpu = producer_embeddings.producer_cluster_matrix(*pe_args, P, OS_C)
    require(torch.allclose(dense.cpu(), dense_cpu, rtol=OS_RTOL, atol=OS_ATOL), "offline: the producer matrix")
    emb_cpu = producer_embeddings.producer_embeddings_from_interested_in(
        *pe_args, num_producers=P, num_clusters=OS_C, top_k_clusters=kp, top_k_producers=kc)
    pe_moved = check_same_ranking(emb.by_producer.ids.cpu().numpy(), emb.by_producer.scores.cpu().numpy(),
                                  emb_cpu.by_producer.ids.numpy(), emb_cpu.by_producer.scores.numpy(),
                                  OS_RTOL, OS_ATOL, "offline: producer embeddings")

    # tweepcred over the FRS world's follow graph, its prior from seeded account flags
    fl = frs.follow_adj
    N = fl.shape[0]
    g = torch.Generator().manual_seed(OS_GRAPH["seed"])
    flags = [torch.rand(N, generator=g) < p for p in (0.01, 0.02)]
    age = torch.randint(0, 2000, (N,), generator=g)
    device_ok, restricted = torch.rand(N, generator=g) < 0.7, torch.rand(N, generator=g) < 0.05
    prior = tweepcred.user_mass_prior(flags[0], flags[1], age, device_ok, restricted)
    edges = tweepcred.OutEdges(fl, (fl != PAD_ID).float())
    pr_params = tweepcred.PageRankParams(**OS_PR)
    t0 = time.perf_counter()
    (pr, iters), n_pr = counted_collapse(lambda: tweepcred.weighted_pagerank(edges, prior.to(dev), pr_params))
    t_pr = time.perf_counter() - t0
    pr_cpu, iters_cpu = tweepcred.weighted_pagerank(tweepcred.OutEdges(*(t.cpu() for t in edges)), prior, pr_params)
    require(iters == iters_cpu and n_pr == iters, f"offline: PageRank {iters} iterations ({n_pr} launches), "
                                                  f"{iters_cpu} on the CPU")
    require(abs(float(pr.double().sum()) - 1.0) < OS_PR_SUM, f"offline: PageRank sums to {float(pr.sum())}")
    require(torch.allclose(pr.cpu(), pr_cpu, rtol=OS_RTOL, atol=1e-9), "offline: PageRank, card against CPU")
    rep_apart = int((tweepcred.scaled_reputation(pr).cpu() != tweepcred.scaled_reputation(pr_cpu)).sum())
    require(rep_apart <= 2, f"offline: {rep_apart} reputations differ (a mass within rounding of a half step)")

    derived = dict(OS_LAUNCHES, tweepcred=iters)
    got = {"known_for": n_kf, "interested_in": n_ii, "producer_embeddings": n_pe, "tweepcred": n_pr}
    require(got == derived, f"offline: launches {got}, want {derived} (from the code)")
    print(f"offline_simclusters: {card_line()}; planted graph {U} users x {P} producers, {OS_GRAPH['num_communities']} "
          f"communities, {OS_GRAPH['follows_per_user']} follows a user (numpy, {t_world:.1f} s, set-up); sims graph "
          f"top {OS_SIMS_TOP} symmetrized on the card; KnownFor C={OS_C}, {OS_ITERS} iterations: cluster ids equal to "
          f"the CPU's, scores within rtol {OS_RTOL}, assigned share {share:.3f}, purity {purity:.3f} (limits "
          f"{OS_RECOVERY}), {t_kf * 1e3:.1f} ms; InterestedIn (top {OS_MAX_CLUSTERS}): {covered:.3f} of users with "
          f"a cluster, the CPU's ranking ({moved} places apart among near-ties), {t_ii * 1e3:.1f} ms; producer "
          f"embeddings over fav_norm ([{P}, {OS_C}] from {U * world.producer_ids.shape[1] * ii.ids.shape[1]} "
          f"triples, one sort and one collapse): the matrix within rtol {OS_RTOL} of the CPU's, top-{kp} clusters "
          f"a producer the CPU's ({pe_moved} apart among near-ties), {t_pe * 1e3:.1f} ms; tweepcred over the FRS "
          f"follow graph [{N}, {fl.shape[1]}]: {iters} iterations as on the CPU (threshold {OS_PR['threshold']}), "
          f"sum {float(pr.double().sum()):.7f}, within rtol {OS_RTOL} of the CPU, {t_pr * 1e3:.1f} ms (host clock, "
          f"not a benchmark); launches {got}, as derived")

    # the new shapes, timed: each collapse's inputs recorded from a path call
    k4_err = k4_cases(dev)
    print(f"offline_simclusters: run_collapse k=4 against its plain version on all {len(K4_CASES)} COLLAPSE_CASES: "
          f"same slots; the kernel within rtol 1e-5 / atol 1e-6 of float64, the plain version (scatter_add_'s "
          f"atomics) within m·2⁻²⁴·Σ|x| of it, the two within the sum (max |kernel - plain| {k4_err:.3g})")
    rows = {}
    seen = recorded(segment, "run_collapse_sorted", lambda: known_for.update_iteration(graph, init, params))
    rows["KnownFor row dedup k=4"] = time_collapse(seen[1], "KnownFor's per-producer cluster stats")
    rows["KnownFor cluster stats"] = time_collapse(seen[0], "KnownFor's cluster_stats scatter")
    seen = recorded(segment, "run_collapse_sorted",
                    lambda: interested_in.interested_in_from_known_for(ff.to(dev), kf, ii_params))
    rows["InterestedIn row dedup k=4"] = time_collapse(seen[0], "InterestedIn's per-user cluster sums")
    rows["InterestedIn cluster norms"] = time_collapse(seen[1], "InterestedIn's cluster norms scatter")
    seen = recorded(segment, "run_collapse_sorted",
                    lambda: producer_embeddings.producer_cluster_matrix(*(a.to(dev) for a in pe_args), P, OS_C))
    rows["producer matrix"] = time_collapse(seen[0], "the producer matrix's sorted (p, c) keys")
    seen = recorded(tweepcred, "run_collapse_sorted", lambda: tweepcred.InEdgeSum(
        fl, fl != PAD_ID, N)(torch.ones(fl.shape, device=dev)))
    rows["tweepcred in-edge sum"] = time_collapse(seen[0], "tweepcred's sorted in-edges")
    print(f"offline_simclusters: new kernel shapes (device time; {card_line()}): " + "; ".join(
        f"{k} {v['device_ms']:.4f} ms (plain {v['plain_device_ms']:.4f}, copy_ {v['copy_ms']:.4f}, bound "
        f"{v['bound_ms']:.4f} ms)" for k, v in rows.items()))
    print(f"offline_simclusters: {card_line()}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"run_collapse": sum(got.values()), "row_gather": 0}, rows


# offline SimClusters part 2 (a child process: ``--offline-simclusters-2``):
# the index job over sann_world.INDEX_JOB (C = 145,408, M = 400, Kt = 20,
# K = 50: bench.py's SANN widths; 65,536 users, 1,048,576 tweets, 524,288
# events: counts cut), RMS and the wrapper source over its index, the score
# facade, evaluation / clustering / entity embeddings over PR 16's offline
# world, the pair model, ann_lib
SC2_SEED = 17
SC2_RTOL, SC2_ATOL = 1e-5, 1e-6  # card against CPU, and scores against float64 sums
SC2_USERS = 32  # users the wrapper serves, twice (cache misses, then hits)
SC2_PARITY = 0.99  # SANN oracle parity over the generated index (as phase_retrieval)
SC2_PAIRS = 4096
SC2_BLEND = (("PairEmbeddingDotProduct", 0.3), ("PairEmbeddingCosineSimilarity", 0.7))
SC2_EIG = dict(k=8, iterations=50)
SC2_EIG_RTOL, SC2_PROJ_ATOL = 1e-4, 1e-3  # eigenvalues and the projector, card against CPU
SC2_CC_THRESHOLD = 0.5  # producers' cosine for connected components and Louvain
SC2_CPU_PRODUCERS = 256  # producers also clustered on the CPU
SC2_ENTITY_TOP = 50
SC2_ENTITY_SHARE = 0.8  # an entity's (a community's) top clusters in its own community
SC2_ANN = dict(n=1 << 18, dim=128, centers=512, cells=256, probes=8, queries=64, k=100)
SC2_HNSW_N = 8192  # vectors HNSW builds from on the host (32,768 took 40.2 s on the card machine)
SC2_HNSW_S = 15.0
SC2_AUC = 0.8  # the JAX test's bound (tests/test_tweet_similarity.py)
SC2_TSIM_STEPS = 200
USER_II = rmgr.EmbeddingId(rmgr.EmbeddingKind.FAV_BASED_USER_INTERESTED_IN, rmgr.EntityKind.USER)


def same_job_index(card, cpu, f64, args, what):
    """The card's index against the CPU's: ids equal and scores within
    SC2_RTOL, or, where ids differ, both held to float64 (``f64``: the
    card's report) with no more entries apart than their near-ties. Returns
    the entries apart."""
    a, b = card.tweet_ids.cpu().numpy(), cpu.tweet_ids.numpy()
    if np.array_equal(a, b):
        require(np.allclose(card.scores.cpu().numpy(), cpu.scores.numpy(), rtol=SC2_RTOL, atol=0),
                f"{what}: scores, card against CPU")
        return 0
    other = igen.compare_with_float64(cpu, *args, rtol=SC2_RTOL, device=card.tweet_ids.device)
    require(other["far"] == 0, f"{what}: the CPU's index off float64 {other}")
    keys = [np.sort((x.astype(np.int64) * x.shape[0] + np.arange(x.shape[0])[:, None])[x != PAD_ID]) for x in (a, b)]
    apart = int(np.setxor1d(*keys).shape[0])
    require(apart <= f64["near_tie"] + other["near_tie"], f"{what}: {apart} entries apart, card against CPU")
    return apart


def planted_vectors(n, dim, centers, seed):
    """Clustered unit-scale vectors (the ann_lib tests' corpus, grown)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, dim)).astype(np.float32) * 3
    return (c[rng.integers(0, centers, n)] + rng.normal(size=(n, dim)).astype(np.float32)).astype(np.float32)


def sc2_index_job(dev):
    """The index job on the card: launches, the card against the CPU, float64."""
    t0 = time.perf_counter()
    w = sann_world.build_index_job_world(sann_world.INDEX_JOB, SC2_SEED)
    t_world = time.perf_counter() - t0
    shape = sann_world.INDEX_JOB
    cfg = igen.IndexGenerationConfig(num_clusters=shape.sann.C, num_tweets=shape.tweets,
                                     tweets_per_cluster=shape.sann.M)
    events = igen.EventLog(*map(torch.from_numpy, (w.user_rows, w.tweet_ids, w.event_type, w.timestamps)))
    ii = tuple(torch.from_numpy(a) for a in (w.ii_ids, w.ii_scores))
    ev_dev, ii_dev = events.to(dev), tuple(t.to(dev) for t in ii)
    igen.generate_cluster_to_tweet_index(ev_dev, *ii_dev, cfg, w.now)  # warm
    zero_counts()
    t0 = time.perf_counter()
    index = igen.generate_cluster_to_tweet_index(ev_dev, *ii_dev, cfg, w.now)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    n = counts()
    require(n == {"run_collapse": 1, "row_gather": 1, "run_collapse_rows": 0},
            f"index job: launches {n}, want 1 row_gather (the join) + 1 run_collapse (the sum by key)")
    t0 = time.perf_counter()
    cpu = igen.generate_cluster_to_tweet_index(events, *ii, cfg, w.now)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    args = (events, w.ii_ids, w.ii_scores, cfg, w.now)
    f64 = igen.compare_with_float64(index, *args, rtol=SC2_RTOL, device=dev)
    t_f64 = time.perf_counter() - t0
    require(f64["unknown"] == 0 and f64["far"] == 0 and f64["out_of_order"] == 0
            and f64["max_rel_err"] <= SC2_RTOL, f"index job: the card's index off float64: {f64}")
    apart = same_job_index(index, cpu, f64, args, "index job")
    E, K = w.user_rows.shape[0], w.ii_ids.shape[1]
    print(f"offline_simclusters_2: {card_line()}; index job: {shape.users} users' InterestedIn rows (K={K} of "
          f"C={shape.sann.C}, one community each), {shape.tweets} tweets, {E} events ({E * K} slots; T·C = "
          f"{shape.tweets * shape.sann.C:.3e} ≥ 2³¹, where JAX's int32 keys wrap: fault 11a) built with numpy in "
          f"{t_world:.1f} s (set-up); launches {n['row_gather']} row_gather + {n['run_collapse']} run_collapse; "
          f"{f64['entries']} index entries held to float64 sums: max rel err {f64['max_rel_err']:.3g} (rtol "
          f"{SC2_RTOL}), {f64['far']} entries apart from the float64 cuts, {f64['near_tie']} near-ties, "
          f"{f64['out_of_order']} out of order ({t_f64:.1f} s: numpy sums, sorts on the card); the CPU's index {apart} entries apart; "
          f"the job {t_card * 1e3:.1f} ms on the card, {t_cpu:.1f} s on the CPU (host clock after a synchronize)")
    return w, cfg, index, ev_dev, ii_dev, {"index_job": dict(n)}


def sc2_wrapper(dev, w, index, ii_dev):
    """RMS holding the InterestedIn table (cached) and the wrapper source
    over the generated index: launches from the cache's own counters, the
    candidates against the SANN path, oracle parity."""
    shape = sann_world.INDEX_JOB.sann
    stats = StatsReceiver()
    store = rmgr.CachedEmbeddingStore(rmgr.TableEmbeddingStore(*ii_dev, {u: u for u in range(w.ii_ids.shape[0])}),
                                      stats=stats)
    rms = rmgr.RepresentationManager()
    rms.register(USER_II, store)
    ann_cfg = ann.SimClustersANNConfig(max_scan_clusters=shape.N, max_top_tweets_per_cluster=shape.M,
                                       max_num_results=shape.X)
    src = csrc.SimClustersANNWrapperCandidateSource(rms, index, csrc.SimClustersANNWrapperConfig(
        embedding=USER_II, ann_config=ann_cfg))
    users = np.random.default_rng(SC2_SEED).choice(w.ii_ids.shape[0], SC2_USERS, replace=False)
    zero_counts()
    t0 = time.perf_counter()
    served = [src.get({"user_id": int(u)}, Params()) for u in users]
    t_miss = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = [src.get({"user_id": int(u)}, Params()) for u in users]
    t_hit = time.perf_counter() - t0
    n = counts()
    c = stats.counters()
    gets = 2 * SC2_USERS
    derived = {"run_collapse": gets, "row_gather": gets + c["rms_cache/misses"], "run_collapse_rows": 0}
    require(c["rms_cache/misses"] == SC2_USERS and c["rms_cache/hits"] == SC2_USERS and n == derived,
            f"wrapper: launches {n}, cache {c}; want {derived} (a get: the SANN fetch and dedup, a miss's multiget)")
    require(all(len(a) == shape.X for a in served) and served == again, "wrapper: lists short or unstable")
    index_np = tuple(t.cpu().numpy() for t in index)
    k = min(K_RECALL, shape.X)
    hits = strict = total = 0
    for u, got in zip(users, served):
        emb = SparseEmbedding(torch.from_numpy(w.ii_ids[u]).to(dev), torch.from_numpy(w.ii_scores[u]).to(dev))
        ids, scores = ann.get_tweet_candidates(index, csrc.rank_clusters(emb, shape.N), ann_cfg)
        require([c.id for c in got] == ids.cpu().tolist() and
                np.array_equal([c.score for c in got], scores.cpu().numpy().astype(np.float64)),
                f"wrapper: user {u}'s candidates differ from ann.get_tweet_candidates")
        ranked = retrieval.approximate_cosine_similarity_reference(
            *index_np, w.ii_ids[u], w.ii_scores[u], max_results=len(got) * shape.N, algorithm=ScoringAlgorithm.COSINE)
        want, cut, score64 = {t for t, _ in ranked[:k]}, ranked[k - 1][1], dict(ranked)
        # a tweet engaged by one user scores as every other tweet of that
        # user's (cosine ignores the event's weight): ids tied at the cut
        # within f32 rounding count as the oracle's
        tied = {c.id for c in got[:k] if abs(score64.get(c.id, -np.inf) - cut) <= 4e-7 * abs(cut)}
        hits += len(({c.id for c in got[:k]} & want) | tied)
        strict += len({c.id for c in got[:k]} & want)
        total += len(want)
    parity = hits / max(total, 1)
    require(parity >= SC2_PARITY, f"wrapper: SANN oracle parity {parity} < {SC2_PARITY} (strict {strict / total})")
    print(f"offline_simclusters_2: {card_line()}; RMS (the [{w.ii_ids.shape[0]}, {w.ii_ids.shape[1]}] InterestedIn "
          f"table, cached) and the SANN wrapper source over the generated index (N={shape.N}, M={shape.M}, "
          f"X={shape.X}): {SC2_USERS} users twice, cache {c['rms_cache/misses']} misses / {c['rms_cache/hits']} "
          f"hits, launches {n} as derived; every list equal to ann.get_tweet_candidates on the RMS row; oracle "
          f"parity {parity:.4f} at {k} over {SC2_USERS} users, ids tied at the cut counted ({strict / total:.4f} "
          f"without); {t_miss / SC2_USERS * 1e3:.2f} ms a request "
          f"on a miss, {t_hit / SC2_USERS * 1e3:.2f} on a hit (host clock, not a benchmark)")
    return {"rms_wrapper": dict(n)}, src


def sc2_score_facade(dev, w, ii_dev):
    """4,096 user pairs through every pair algorithm and a blend, card
    against CPU, PairScoreStore beside the facade."""
    U = w.ii_ids.shape[0]
    rng = np.random.default_rng(SC2_SEED + 1)
    a = rng.integers(0, U, SC2_PAIRS)
    by_comm = np.argsort(w.user_comm, kind="stable")  # half the pairs within a community, half across
    size = np.bincount(w.user_comm, minlength=int(w.user_comm.max()) + 1)
    start = np.cumsum(size) - size
    peer = by_comm[start[w.user_comm[a]] + (rng.random(SC2_PAIRS) * size[w.user_comm[a]]).astype(np.int64)]
    b = np.where(rng.random(SC2_PAIRS) < 0.5, peer, rng.integers(0, U, SC2_PAIRS))
    rows = {u: u for u in range(U)}
    facades = []
    for d, tables in ((dev, ii_dev), (torch.device("cpu"), (torch.from_numpy(w.ii_ids), torch.from_numpy(w.ii_scores)))):
        rms = rmgr.RepresentationManager()
        rms.register(USER_II, rmgr.TableEmbeddingStore(*tables, rows))
        f = sfac.ScoreFacadeStore(rms)
        f.register_aggregate(sfac.WeightedSumSpec("blend", SC2_BLEND))
        facades.append(f)
    zero_counts()
    t0 = time.perf_counter()
    card = {alg: facades[0].pair_scores(alg, USER_II, a, USER_II, b) for alg in sfac.PAIR_ALGORITHMS}
    card["blend"] = facades[0].aggregate_scores("blend", USER_II, a, USER_II, b)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    n = counts()
    derived = {"run_collapse": 0, "row_gather": 2 * (len(sfac.PAIR_ALGORITHMS) + 1), "run_collapse_rows": 0}
    require(n == derived, f"score facade: launches {n}, want {derived} (two multigets a call)")
    worst = 0.0
    for alg, got in card.items():
        want = (facades[1].aggregate_scores("blend", USER_II, a, USER_II, b) if alg == "blend"
                else facades[1].pair_scores(alg, USER_II, a, USER_II, b))
        require(bool(torch.isfinite(got).all()) and torch.allclose(got.cpu(), want, rtol=SC2_RTOL, atol=SC2_ATOL),
                f"score facade: {alg}, card against CPU")
        worst = max(worst, float((got.cpu() - want).abs().max()))
    ea, eb = facades[0].rms.multiget(USER_II, a), facades[0].rms.multiget(USER_II, b)
    kinds = {"dot": "PairEmbeddingDotProduct", "cosine": "PairEmbeddingCosineSimilarity",
             "log_cosine": "PairEmbeddingLogCosineSimilarity", "exp_cosine": "PairEmbeddingExpScaledCosineSimilarity",
             "jaccard": "PairEmbeddingJaccardSimilarity", "euclidean": "PairEmbeddingEuclideanDistance",
             "manhattan": "PairEmbeddingManhattanDistance"}
    for kind, alg in kinds.items():
        require(torch.equal(rsx.PairScoreStore(kind)(ea, eb), card[alg]), f"PairScoreStore {kind} against the facade")
    blend = rsx.weighted_sum_score({alg: card[alg] for alg, _ in SC2_BLEND}, dict(SC2_BLEND))
    require(torch.allclose(blend, card["blend"], rtol=SC2_RTOL, atol=SC2_ATOL), "weighted_sum_score against the blend")
    same = float((card["PairEmbeddingCosineSimilarity"] > 0).float().mean())
    print(f"offline_simclusters_2: {card_line()}; score facade: {SC2_PAIRS} user pairs x {len(sfac.PAIR_ALGORITHMS)} "
          f"algorithms and a blend, launches {n} as derived, card against CPU within rtol {SC2_RTOL} / atol "
          f"{SC2_ATOL} (max |diff| {worst:.3g}); PairScoreStore's 7 kinds equal to the facade, weighted_sum_score to "
          f"the blend; {same:.3f} of pairs share a cluster; {t_card * 1e3:.1f} ms (host clock)")
    return {"score_facade": dict(n)}, (a, b)


def offline_world(dev):
    """PR 16's offline world (OS_GRAPH): the sims graph, KnownFor,
    InterestedIn and the producer embeddings, on the card."""
    world = synthetic.community_graph(synthetic.CommunityGraphConfig(**OS_GRAPH))
    P = OS_GRAPH["num_producers"]
    graph = sims_graph.symmetrize(sims_graph.cosine_similarity_graph(
        sims_graph.follow_matrix_from_adjacency(torch.from_numpy(world.producer_ids).to(dev), P), top_k=OS_SIMS_TOP))
    init = known_for.initialize_random(torch.Generator(device=dev).manual_seed(OS_GRAPH["seed"]), P, OS_C)
    kf = known_for.iterate(graph, init, known_for.KnownForParams(num_clusters=OS_C), OS_ITERS)
    ff = interested_in.FollowFavGraph(*(torch.from_numpy(np.asarray(a)).to(dev) for a in (
        world.producer_ids, world.followed, world.fav_score, world.log_fav_score)))
    ii = interested_in.interested_in_from_known_for(ff, kf, interested_in.InterestedInParams(
        num_clusters=OS_C, max_clusters_per_user=OS_MAX_CLUSTERS))
    emb = producer_embeddings.producer_embeddings_from_interested_in(
        ff.producer_ids, ff.fav_score, ii.ids, ii.fav_cluster_normalized, num_producers=P, num_clusters=OS_C,
        top_k_clusters=OS_PRODUCER_K[0], top_k_producers=OS_PRODUCER_K[1])
    return world, graph, kf, emb.by_producer


def sc2_evaluation(dev):
    """evaluate_clusters and top_eigenvectors over the offline world's
    KnownFor and sims graph; the clustering methods over its producer
    embeddings: card against CPU."""
    t0 = time.perf_counter()
    world, graph, kf, prod = offline_world(dev)
    torch.cuda.synchronize()
    t_world = time.perf_counter() - t0
    graph_cpu, kf_cpu = graph.to("cpu"), known_for.KnownFor(kf.cluster.cpu(), kf.score.cpu())
    zero_counts()
    q = evaluation.evaluate_clusters(graph, kf, OS_C)
    n_eval = counts()
    require(n_eval["run_collapse"] == 1 and n_eval["row_gather"] == 0, f"evaluate_clusters: launches {n_eval}")
    q_cpu = evaluation.evaluate_clusters(graph_cpu, kf_cpu, OS_C)
    for g, x, name in zip(q, q_cpu, q._fields):
        require(torch.allclose(g.cpu(), x, rtol=SC2_RTOL, atol=SC2_ATOL), f"evaluate_clusters {name}, card against CPU")
    zero_counts()
    t0 = time.perf_counter()
    vals, vecs = evaluation.top_eigenvectors(graph, **SC2_EIG)
    torch.cuda.synchronize()
    t_eig = time.perf_counter() - t0
    n_eig = counts()
    require(n_eig["row_gather"] == SC2_EIG["iterations"] + 1 and n_eig["run_collapse"] == 0,
            f"top_eigenvectors: launches {n_eig}, want {SC2_EIG['iterations'] + 1} row_gather (a matvec each)")
    vals_cpu, vecs_cpu = evaluation.top_eigenvectors(graph_cpu, **SC2_EIG)
    proj_err = float(((vecs @ vecs.T).cpu() - vecs_cpu @ vecs_cpu.T).abs().max())
    require(torch.allclose(vals.cpu(), vals_cpu, rtol=SC2_EIG_RTOL) and proj_err <= SC2_PROJ_ATOL,
            f"top_eigenvectors: card against CPU (eigenvalues {vals.tolist()} / {vals_cpu.tolist()}, projector "
            f"{proj_err:.3g})")
    resid = float((torch.einsum("ud,udk->uk", torch.where(graph.nbr_ids != PAD_ID, graph.nbr_weights, 0.0),
                                vecs[gather.jax_rows(torch.where(graph.nbr_ids != PAD_ID, graph.nbr_ids, 0),
                                                     vecs.shape[0])]) - vecs * vals).norm(dim=0).max())

    # clustering over the producer embeddings (its users' neighbourhoods, N ≤ a few thousand)
    t0 = time.perf_counter()
    sim = clustering.similarity_matrix(prod)
    labels = clustering.connected_components(sim, SC2_CC_THRESHOLD)
    torch.cuda.synchronize()
    t_cc = time.perf_counter() - t0
    t0 = time.perf_counter()
    louv = clustering.louvain(sim.cpu().numpy().astype(np.float64), SC2_CC_THRESHOLD)
    t_louv = time.perf_counter() - t0
    medoid = clustering.medoid_representative(prod, labels)
    pids = world.producer_ids[world.producer_ids != PAD_ID]
    followers = torch.from_numpy(np.bincount(pids, minlength=prod.ids.shape[0]).astype(np.float32))
    top = clustering.max_weight_representative(labels, followers.to(dev))
    comps = torch.unique(labels)
    require(bool(torch.isin(comps, labels[medoid]).all() and torch.isin(comps, labels[top]).all()),
            "clustering: a component without a medoid or a most-followed member")
    require(torch.equal(top.cpu(), clustering.max_weight_representative(labels.cpu(), followers)),
            "clustering: most-followed members, card against CPU")
    sub = SparseEmbedding(prod.ids[:SC2_CPU_PRODUCERS].cpu(), prod.scores[:SC2_CPU_PRODUCERS].cpu())
    sub_dev = SparseEmbedding(prod.ids[:SC2_CPU_PRODUCERS], prod.scores[:SC2_CPU_PRODUCERS])
    sim_sub, sim_sub_cpu = clustering.similarity_matrix(sub_dev), clustering.similarity_matrix(sub)
    require(torch.allclose(sim_sub.cpu(), sim_sub_cpu, rtol=SC2_RTOL, atol=SC2_ATOL), "clustering: similarity matrix")
    lab_sub, lab_sub_cpu = (clustering.connected_components(x, SC2_CC_THRESHOLD) for x in (sim_sub, sim_sub_cpu))
    require(torch.equal(lab_sub.cpu(), lab_sub_cpu), "clustering: connected components, card against CPU")
    require(np.array_equal(clustering.louvain(sim_sub.cpu().numpy().astype(np.float64), SC2_CC_THRESHOLD),
                           clustering.louvain(sim_sub_cpu.numpy().astype(np.float64), SC2_CC_THRESHOLD)),
            "clustering: Louvain over the card's and the CPU's similarities")
    # medoids: equal but where a member's in-cluster similarity sum ties its
    # cluster's best within rounding (near-duplicate embeddings)
    apart = clustering.medoid_representative(sub_dev, lab_sub).cpu() != clustering.medoid_representative(sub, lab_sub_cpu)
    score = torch.where(lab_sub_cpu[:, None] == lab_sub_cpu[None, :], sim_sub_cpu, 0.0).sum(1)
    best = clustering._best_of_cluster(lab_sub_cpu, score)
    require(bool((apart <= ((best - score).abs() <= SC2_RTOL * best.abs() + SC2_ATOL)).all()),
            "clustering: medoids, card against CPU, apart away from a tie")
    largest = clustering.largest_dimension(prod)
    print(f"offline_simclusters_2: {card_line()}; evaluation over PR 16's offline world (built again in "
          f"{t_world:.1f} s: sims graph, KnownFor C={OS_C}, InterestedIn, producer embeddings): evaluate_clusters "
          f"(1 run_collapse, k=3) within rtol {SC2_RTOL} of the CPU, mean in-cluster weight share "
          f"{float(q.in_cluster_weight_fraction[q.sizes > 0].mean()):.3f}; top_eigenvectors k={SC2_EIG['k']}, "
          f"{SC2_EIG['iterations']} iterations ({n_eig['row_gather']} row_gather launches), eigenvalues "
          f"{[round(v, 4) for v in vals.tolist()]} within rtol {SC2_EIG_RTOL} of the CPU, projector within "
          f"{proj_err:.2g}, residual max ‖Aq − λq‖ {resid:.3g}, {t_eig * 1e3:.1f} ms; clustering of the "
          f"{prod.ids.shape[0]} producer embeddings (K={prod.ids.shape[1]}): {comps.numel()} components at "
          f"cosine ≥ {SC2_CC_THRESHOLD} ({t_cc * 1e3:.1f} ms with the similarity matrix), Louvain "
          f"{int(louv.max()) + 1} communities in {t_louv:.1f} s (host), {int(medoid.sum())} medoids, "
          f"{torch.unique(largest).numel()} largest-dimension clusters; the first {SC2_CPU_PRODUCERS} producers "
          f"card against CPU (similarities, components, Louvain; medoids {int(apart.sum())} apart at near-ties)")
    return {"evaluation": {k: n_eval[k] + n_eig[k] for k in n_eval}}, graph, kf


def sc2_entity(dev, w, ev_dev, ii_dev):
    """Entity embeddings from the index job's events: entity = the engaged
    tweet's community (512 × 145,408 dense slots, 298 MB)."""
    shape = sann_world.INDEX_JOB
    entity = torch.from_numpy(w.tweet_comm[w.tweet_ids].astype(np.int32))
    weights = torch.tensor((1.0, 1.0, 1.0, 0.5, 0.5))[ev_dev.event_type.cpu().long()]
    n_ent, C = shape.sann.n_comm, shape.sann.C
    require(n_ent * C < 2**31, "entity embeddings: the dense array passes int32")
    interests = SparseEmbedding(*ii_dev)
    zero_counts()
    t0 = time.perf_counter()
    emb = entity_embeddings.entity_embeddings_from_engagements(
        entity.to(dev), ev_dev.user_rows, weights.to(dev), interests, num_entities=n_ent, num_clusters=C,
        top_k=SC2_ENTITY_TOP)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    n = counts()
    require(n == {"run_collapse": 1, "row_gather": 1, "run_collapse_rows": 0},
            f"entity embeddings: launches {n}, want 1 row_gather (the join) + 1 run_collapse (the scatter)")
    cpu = entity_embeddings.entity_embeddings_from_engagements(
        entity, ev_dev.user_rows.cpu(), weights, SparseEmbedding(*(t.cpu() for t in ii_dev)), num_entities=n_ent,
        num_clusters=C, top_k=SC2_ENTITY_TOP)
    moved = check_same_ranking(emb.ids.cpu().numpy(), emb.scores.cpu().numpy(), cpu.ids.numpy(), cpu.scores.numpy(),
                               SC2_RTOL, SC2_ATOL, "entity embeddings")
    comm_clusters = np.random.default_rng(0).permutation(C).reshape(n_ent, shape.sann.cpc)
    ids = emb.ids.cpu().numpy()
    share = float(np.mean([np.isin(ids[e][ids[e] != PAD_ID], comm_clusters[e]).mean() for e in range(n_ent)]))
    require(share >= SC2_ENTITY_SHARE, f"entity embeddings: {share:.3f} of top clusters in the entity's community")
    print(f"offline_simclusters_2: {card_line()}; entity embeddings from the index job's events (entity = the "
          f"tweet's community: [{n_ent}, {C}] dense, {n_ent * C * 4 / 1e6:.0f} MB): launches {n}, top-"
          f"{SC2_ENTITY_TOP} the CPU's ({moved} ranks apart among near-ties), {share:.3f} of them in the entity's "
          f"own community, {t_card * 1e3:.1f} ms (host clock)")
    return {"entity_embeddings": dict(n)}


def sc2_tweet_similarity(dev):
    """The pair model trained on the card on the JAX test's world to its AUC."""
    rng = np.random.default_rng(0)
    n_tweets, K = 120, 8
    comm = rng.integers(0, 4, n_tweets)
    t_ids = np.stack([rng.choice(np.arange(c * 16, (c + 1) * 16), K, replace=False) for c in comm]).astype(np.int32)
    t_scores = rng.uniform(0.5, 1, (n_tweets, K)).astype(np.float32)
    eu, et, ets = [], [], []
    for u in range(150):
        c = rng.integers(0, 4)
        for i, tw in enumerate(rng.choice(np.flatnonzero(comm == c), 4, replace=False)):
            eu.append(u)
            et.append(int(tw))
            ets.append(u * 10_000 + i)
    ds = tsim.collect_training_pairs(np.asarray(eu), np.asarray(et), np.asarray(ets), coengagement_window_s=100)
    side = [SparseEmbedding(torch.from_numpy(t_ids[x]).to(dev), torch.from_numpy(t_scores[x]).to(dev))
            for x in (ds.tweet_a, ds.tweet_b)]
    feats = tsim.pair_features_batch(*side)
    labels = torch.from_numpy(ds.label).to(dev)
    model = tsim.TweetSimilarityModel(device=dev)
    opt = optimizers.Adam(model.parameters(), lr=1e-2)
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(SC2_TSIM_STEPS):
        opt.zero_grad()
        loss = tsim.loss_fn(model, {"features": feats, "label": labels})[0]
        loss.backward()
        opt.step()
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    n = counts()
    require(sum(n.values()) == 0, f"the pair model launched a hand kernel: {n}")
    auc = float(metrics.auc(model(feats).detach(), labels))
    require(auc > SC2_AUC, f"the pair model's AUC {auc:.3f} ≤ {SC2_AUC}")
    print(f"offline_simclusters_2: {card_line()}; tweet-similarity pair model: {len(ds.label)} pairs from the JAX "
          f"test's world, {SC2_TSIM_STEPS} Adam steps on the card in {t_fit:.2f} s, AUC {auc:.3f} (> {SC2_AUC}), "
          f"final loss {loss.item():.4f}, no hand kernel (no table)")


def sc2_ann_lib(dev):
    """Brute force and IVF on the card under run_loadtest; HNSW on the host."""
    a = SC2_ANN
    x = planted_vectors(a["n"], a["dim"], a["centers"], SC2_SEED)
    ids = np.arange(a["n"], dtype=np.int64) + 1_000_000
    rng = np.random.default_rng(SC2_SEED + 2)
    queries = x[rng.choice(a["n"], a["queries"], replace=False)] + 0.1 * rng.normal(
        size=(a["queries"], a["dim"])).astype(np.float32)
    brute = ann_lib.BruteForceIndex(a["dim"], device=dev)
    brute.append(ids, x)
    ivf = ann_lib.ClusteredScanIndex(a["dim"], n_clusters=a["cells"], n_probes=a["probes"], device=dev)
    ivf.append(ids, x)
    t0 = time.perf_counter()
    ivf.build()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    ivf.query(queries[:2], a["k"])  # warm
    brute.query(queries[:2], a["k"])
    zero_counts()
    res_ivf = ann_lib.run_loadtest(ivf, queries, a["k"], truth_index=brute)
    n = counts()
    require(n == {"run_collapse": 0, "row_gather": a["queries"], "run_collapse_rows": 0},
            f"IVF: launches {n}, want one row_gather (the member vectors) a query")
    res_bf = ann_lib.run_loadtest(brute, queries, a["k"], truth_index=brute)
    require(res_bf.overall_recall == 1.0, f"brute force against itself: recall {res_bf.overall_recall}")
    cpu = ann_lib.ClusteredScanIndex(a["dim"], n_clusters=a["cells"], n_probes=a["probes"], device="cpu")
    cpu.append(ids, x)
    cpu._load(ivf._centroids.cpu(), ivf._members.cpu().numpy())  # the card's cells
    got, want = ivf.query(queries[:8], a["k"]), cpu.query(queries[:8], a["k"])
    require(np.array_equal(got[0], want[0]) and np.allclose(got[1], want[1], rtol=1e-4, atol=1e-4),
            "IVF: card against CPU on the same cells")
    cap = ivf._members.shape[1]
    sub = x[:SC2_HNSW_N]
    h = hnsw.HnswIndex(a["dim"], ef=100)
    t0 = time.perf_counter()
    h.append(ids[:SC2_HNSW_N], sub)
    t_hnsw = time.perf_counter() - t0
    require(t_hnsw <= SC2_HNSW_S, f"HNSW build took {t_hnsw:.1f} s")
    small = ann_lib.BruteForceIndex(a["dim"], device=dev)
    small.append(ids[:SC2_HNSW_N], sub)
    res_h = ann_lib.run_loadtest(h, queries, a["k"], truth_index=small)
    print(f"offline_simclusters_2: {card_line()}; ann_lib over {a['n']} x {a['dim']} f32 ({a['centers']} planted "
          f"centres), {a['queries']} queries, k={a['k']}: IVF {a['cells']} cells (k-means on the card "
          f"{t_build:.2f} s, the fullest {cap}), {a['probes']} probes: recall@1 {res_ivf.recall_at_1:.4f}, @10 "
          f"{res_ivf.recall_at_10:.4f}, overall {res_ivf.overall_recall:.4f}, p50 {res_ivf.p50_latency_us:.0f} µs, "
          f"launches {n} (one row_gather a query); brute force overall {res_bf.overall_recall:.4f}, p50 "
          f"{res_bf.p50_latency_us:.0f} µs; HNSW on the host over the first {SC2_HNSW_N} (built in {t_hnsw:.1f} "
          f"s, ef=100): recall@10 {res_h.recall_at_10:.4f}, overall {res_h.overall_recall:.4f}, p50 "
          f"{res_h.p50_latency_us:.0f} µs (latencies host clock, whole query calls)")
    return {"ann_lib": dict(n)}, ivf, queries


def sc2_kernel_times(dev, w, cfg, ev_dev, ii_dev, src, graph, kf, ivf, queries, pairs):
    """The new launch shapes against their plain versions (device time over
    warm calls), each kernel's inputs recorded from a path call."""
    rows = {}
    job = lambda: igen.generate_cluster_to_tweet_index(ev_dev, *ii_dev, cfg, w.now)  # noqa: E731
    seen = recorded(igen, "run_collapse_sorted", job)
    rows["index job sum by key"] = time_collapse(seen[0], "the index job's dense run indices")
    seen = recorded(igen, "row_gather", job)
    ids, *tables = seen[0]
    rows["index job join"] = time_gather(ids, tuple(tables), f"the InterestedIn join: {ids.numel()} events x 2 x "
                                                             f"{tables[0].shape[1] * 4} B (word kernel)")
    store = rmgr.TableEmbeddingStore(*ii_dev, {u: u for u in range(w.ii_ids.shape[0])})
    seen = recorded(rmgr, "row_gather", lambda: store.multiget(np.asarray([5])))
    rows["RMS multiget"] = time_gather(seen[0][0], tuple(seen[0][1:]), "an RMS miss: 1 x 2 x 200 B (word kernel)")
    seen = recorded(rmgr, "row_gather", lambda: store.multiget(pairs[0]))
    rows["score facade multiget"] = time_gather(seen[0][0], tuple(seen[0][1:]),
                                                f"the score facade: {SC2_PAIRS} x 2 x 200 B (word kernel)")
    seen = recorded(evaluation, "row_gather", lambda: evaluation.top_eigenvectors(graph, k=SC2_EIG["k"], iterations=1))
    ids, v = seen[0]
    rows["eigen matvec"] = time_gather(ids, (v,), f"the eigen matvec: {ids.numel()} rows x {v.shape[1] * 4} B")
    seen = recorded(evaluation.segment, "run_collapse_sorted", lambda: evaluation.evaluate_clusters(graph, kf, OS_C))
    rows["evaluate_clusters"] = time_collapse(seen[0], "evaluate_clusters' per-cluster sums", copy_yardstick=False)
    seen = recorded(ann_lib.index, "row_gather", lambda: ivf.query(queries[:1], SC2_ANN["k"]))
    ids, vec = seen[0]
    rows["IVF members"] = time_gather(ids, (vec,), f"the IVF member vectors: {ids.numel()} x {vec.shape[1] * 4} B")
    user = {"user_id": 5}
    seen = recorded(retrieval, "row_gather", lambda: src.get(user, Params()))
    ids, *tables = seen[0]
    rows["wrapper SANN rows"] = time_gather(ids, tuple(tables), f"the wrapper's SANN rows: {ids.numel()} x 3 x "
                                                                f"{tables[0].shape[1] * 4} B")
    seen = recorded(retrieval, "run_collapse_sorted", lambda: src.get(user, Params()))
    rows["wrapper SANN dedup"] = time_collapse(seen[0], "the wrapper's SANN entries", copy_yardstick=False)
    print(f"offline_simclusters_2: new kernel shapes (device time; {card_line()}): " + "; ".join(
        f"{k} {v['device_ms']:.4f} ms (plain {v['plain_device_ms']:.4f}, bound {v['bound_ms']:.4f} ms"
        + (f", copy_ {v['copy_ms']:.4f}" if v.get("copy_ms") else "") + ")" for k, v in rows.items()))
    return rows


def phase_offline_part_two(dev):
    """``chip_smoke.py --offline-simclusters-2``: the slice's paths on the
    card (see SC2_*), then the new kernel shapes timed. Returns the launches
    by path."""
    t_phase = time.perf_counter()
    w, cfg, index, ev_dev, ii_dev, by_path = sc2_index_job(dev)
    wrapper, src = sc2_wrapper(dev, w, index, ii_dev)
    by_path.update(wrapper)
    facade, pairs = sc2_score_facade(dev, w, ii_dev)
    by_path.update(facade)
    evals, graph, kf = sc2_evaluation(dev)
    by_path.update(evals)
    by_path.update(sc2_entity(dev, w, ev_dev, ii_dev))
    sc2_tweet_similarity(dev)
    ann_launches, ivf, queries = sc2_ann_lib(dev)
    by_path.update(ann_launches)
    sc2_kernel_times(dev, w, cfg, ev_dev, ii_dev, src, graph, kf, ivf, queries, pairs)
    print(f"offline_simclusters_2: {card_line()}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return {path: {k: v for k, v in n.items() if k != "run_collapse_rows"} for path, n in by_path.items()}


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
# bench.py's freshness criterion (bench.py:781-788): after the fav bursts the
# probe's top candidate scores more than this away from before, or leaves the
# top-50. The probe is served with creation times below SPREAD_TS: at
# bench.py's ~1e7-second times a request's scores sit within ulps of each
# other (4.70161e-07 -> 4.70151e-07 in a failed run), where a burst moves the
# target's score by less than this and the check passed only when the target
# left the top-50
FRESH_BOUND = 1e-9
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
    launches = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                "row_gather": _build.launches(gather.row_gather)}
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


def freshness_moved(target, after):
    """bench.py's freshness criterion for the probe's top candidate
    ``target`` and the next request's list ``after``: (moved, its score in
    ``after`` or None when it left the list)."""
    after_s = {c.id: c.score for c in after}.get(target.id)
    return after_s is None or abs(after_s - target.score) > FRESH_BOUND, after_s


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
    served, make, probe_engine = fy["served"], fy["queries"], fy["probe"]
    scorer = served.scorer
    num_users, num_authors = FY_WORLD["num_users"], FY_WORLD["num_authors"]
    now = foryou_world.NOW
    updater = lu.LiveUpdater(scorer)
    rng = np.random.default_rng(23)
    probe = make(1, base=900)[0]
    target = probe_engine.serve_batch([probe])[0][0]  # the probe's top candidate
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
    after = probe_engine.serve_batch([probe])[0]
    torch.cuda.synchronize()
    launches = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                "row_gather": _build.launches(gather.row_gather)}
    require(launches == FY_LAUNCHES, f"launches of the request after the updates {launches}, want {FY_LAUNCHES}")
    moved, after_s = freshness_moved(target, after)
    require(moved, f"the fav bursts did not move tweet {target.id}'s score ({target.score} -> {after_s})")
    print(f"live: freshness (creation times below {SPREAD_TS} s): tweet {target.id}, the probe's top candidate, "
          f"scored {target.score:.9g} before the updates and "
          f"{'%.9g' % after_s if after_s is not None else 'out of the top-50'} in the next request"
          + (f", moved by {abs(after_s - target.score):.6g} (bound {FRESH_BOUND:g})" if after_s is not None else "")
          + f" (launches {launches})")

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
    query_launches = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                      "row_gather": _build.launches(gather.row_gather)}
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


# -- training: bench.py's MaskNet step (bench.py:266-328) and the light ranker's lifecycle --------
TRAIN_MODEL = dict(num_features=6000, num_heads=15, mask_blocks=4, block_dim=512, aggregation_dim=128,
                   head_hidden=(256, 128))
TRAIN_B = 16_384  # bench.py's batch
TRAIN_LR = 1e-3  # bench.py's adam_bf16(1e-3)
TRAIN_WARMUP = 3
TRAIN_STEPS = 24  # loop-carried steps timed with CUDA events
GRAD_B = 256  # card against CPU: the f32 model's first gradients and 3 AdamBf16 steps
GRAD_STEPS = 3
# f32 gradients, card against CPU: products of 6,000 terms summed in another
# order (cuBLAS against the CPU's BLAS), so each parameter within this share of
# its largest entry
GRAD_SCALE_TOL = 1e-4
# params after GRAD_STEPS AdamBf16 steps: m/√v turns gradient noise into ±lr
# where a gradient is near zero, so no entry may differ by more than
# 2·GRAD_STEPS·lr, and all but PARAM_OUTLIERS of the entries within PARAM_ATOL
PARAM_ATOL, PARAM_OUTLIERS = 1e-5, 1e-3
TRAINER_B = 1024  # the Trainer's batches: seeded normal features, labels of a linear teacher
TRAINER_STEPS = 200
TRAINER_EVAL_EVERY = 25
TRAINER_HELD_OUT = 4096
TRAINER_AUC = 0.75  # auc_mean on the held-out batch within TRAINER_STEPS
TRAINER_SERVED = (4, 64)  # HTTP requests x instances of the exported version
LR_FEATURES, LR_BITS, LR_BINS, LR_BATCH = 40, 18, 16, 1024  # the light ranker's config
LR_SHARDS, LR_PER_SHARD, LR_HELD_OUT = 8, 4096, 8192
LR_STEPS = 48
LR_LABEL_FID = 7
LR_AUC = 0.75
LR_PRED_RTOL, LR_PRED_ATOL = 1e-5, 1e-6  # served against predict_proba: the same f32 function
# the weight gradient through sort + run_collapse against index_put_(accumulate=True)
# of the same contributions: f32 sums of ~64 terms a bucket in another order, so
# within this share of each entry, or of the gradient's largest entry
LR_GRAD_RTOL = 1e-6
PRODUCT_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def masknet_step(model, opt, x, y):
    """One bench.py step: value_and_grad of the multi-task loss, then the update."""
    with torch.profiler.record_function("forward"):
        loss = masknet.multi_task_loss(model(x), y)
    loss.backward()
    with torch.profiler.record_function("update"):
        opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def step_breakdown(step, reps=2):
    """The step's device time by part from ONE profiler session of ``reps``
    steps: each CPU op's own kernels, by the part of the step that launched
    them (the forward, the backward, the optimizer update) and by kind
    (products, layer norms, the rest); the kernels the products ran on; and
    the kernels that took longest."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    parts, products, kernels = Counter(), Counter(), Counter()
    for e in prof.events():
        if e.device_type != DeviceType.CPU or e.self_device_time_total <= 0:
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        if any(n.startswith("autograd::engine") for n in chain):
            phase = "backward"
        elif "update" in chain:
            phase = "update"
        else:
            phase = "forward"
        kind = "products" if e.name in PRODUCT_OPS else "layer norms" if "layer_norm" in e.name else "other"
        parts[f"{phase} {kind}" if phase != "update" else "update"] += e.self_device_time_total / 1000 / reps
        for k in e.kernels:
            kernels[k.name[:60]] += k.duration / 1000 / reps
            if kind == "products":
                products[k.name[:60]] += k.duration / 1000 / reps
    return parts, products.most_common(4), kernels.most_common(4)


def bench_train_step(dev):
    """bench.py's train step at its width and batch: warm up, time loop-carried
    steps with CUDA events, the loss finite and falling, peak memory, and the
    device time by part from one profiler session."""
    cfg = masknet.MaskNetConfig(**TRAIN_MODEL)
    model = masknet.MaskNet(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    opt = optimizers.AdamBf16(model.parameters(), TRAIN_LR)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(TRAIN_B, cfg.num_features)).astype(np.float32)).to(dev).to(torch.bfloat16)
    y = torch.from_numpy((rng.random((TRAIN_B, cfg.num_heads)) < 0.05).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [masknet_step(model, opt, x, y) for _ in range(TRAIN_WARMUP)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_STEPS):
        losses.append(masknet_step(model, opt, x, y))
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(v) for v in losses]
    require(all(np.isfinite(losses)), f"bench.py's train step gave a non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"bench.py's train step did not lower the loss: {losses[0]} -> {losses[-1]}")
    parts, products, top = step_breakdown(lambda: masknet_step(model, opt, x, y))
    # the products' operations: 2 a weight entry and example forward, 4 backward
    flops = 6 * TRAIN_B * sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    print(f"training: bench.py's MaskNet step (F={cfg.num_features}, {cfg.num_heads} heads, G={cfg.mask_blocks}, "
          f"D={cfg.block_dim}, A={cfg.aggregation_dim}, trunk {cfg.head_hidden}, bf16, B={TRAIN_B}, bf16 inputs, "
          f"AdamBf16({TRAIN_LR})): {ms:.3f} ms a step over {TRAIN_STEPS} loop-carried steps (CUDA events), "
          f"{TRAIN_B / ms * 1e3:,.1f} examples/s (not a benchmark); loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
          f"finite; peak memory {peak / 2**30:.2f} GiB; the products' bound {flops / 989e12 * 1e3:.3f} ms "
          f"({flops / 1e9:.1f} GFLOP at 989 TFLOP/s)")
    print("training: step device time by part (one profiler session): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(parts.items(), key=lambda kv: -kv[1])) +
        f"; total {sum(parts.values()):.3f} ms; the products' kernels " +
        "; ".join(f"{n} {t:.3f} ms" for n, t in products) + "; longest kernels " +
        "; ".join(f"{n} {t:.3f} ms" for n, t in top))
    del model, opt, x, y
    torch.cuda.empty_cache()


def masknet_card_against_cpu(dev):
    """The full-width model in f32 (TF32 off) at B=GRAD_B on the card and on
    the CPU from the same weights and inputs: the first step's gradients per
    parameter, then the params after GRAD_STEPS AdamBf16 steps."""
    cfg = masknet.MaskNetConfig(**TRAIN_MODEL, dtype="float32")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(GRAD_B, cfg.num_features)).astype(np.float32)
    y = (rng.random((GRAD_B, cfg.num_heads)) < 0.3).astype(np.float32)
    runs = []
    ref = masknet.MaskNet(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(1)).state_dict()
    for where in (dev, torch.device("cpu")):
        model = masknet.MaskNet(cfg, device=where)
        model.load_state_dict(ref)
        opt = optimizers.AdamBf16(model.parameters(), TRAIN_LR)
        xt, yt = torch.from_numpy(x).to(where), torch.from_numpy(y).to(where)
        masknet.multi_task_loss(model(xt), yt).backward()
        grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()}
        opt.step()
        for _ in range(GRAD_STEPS - 1):
            opt.zero_grad(set_to_none=True)
            masknet.multi_task_loss(model(xt), yt).backward()
            opt.step()
        runs.append((grads, {k: v.detach().cpu() for k, v in model.state_dict().items()}))
    (g_card, p_card), (g_cpu, p_cpu) = runs
    worst = max(float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max().clamp(min=1e-30)) for k in g_cpu)
    require(worst <= GRAD_SCALE_TOL, f"card gradients off the CPU's by {worst:.3g} of a parameter's largest entry")
    diffs = torch.cat([(p_card[k] - p_cpu[k]).abs().reshape(-1) for k in p_cpu])
    max_diff, outliers = float(diffs.max()), float((diffs > PARAM_ATOL).double().mean())
    require(max_diff <= 2 * GRAD_STEPS * TRAIN_LR and outliers <= PARAM_OUTLIERS,
            f"params after {GRAD_STEPS} AdamBf16 steps: card vs CPU max {max_diff:.3g}, {outliers:.3g} beyond "
            f"{PARAM_ATOL}")
    print(f"training: card against CPU (f32, TF32 off, B={GRAD_B}): first gradients within {worst:.3g} of each "
          f"parameter's largest entry (limit {GRAD_SCALE_TOL}); params after {GRAD_STEPS} AdamBf16 steps: max "
          f"|diff| {max_diff:.3g} (limit 2·steps·lr = {2 * GRAD_STEPS * TRAIN_LR:g}), share beyond {PARAM_ATOL:g}: "
          f"{outliers:.3g} (limit {PARAM_OUTLIERS:g})")


def teacher_batches(seed, w_true, n):
    """Seeded normal features and the labels of a linear teacher,
    ``sigmoid(x @ w_true) > 0.5``, in host batches of ``n``."""
    rng = np.random.default_rng(seed)
    while True:
        x = rng.standard_normal((n, w_true.shape[0]), dtype=np.float32)
        yield x, (x @ w_true > 0).astype(np.float32)


def post_json(port, model, instances):
    body = json.dumps({"instances": instances.tolist()}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{model}:predict", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:  # an HTTP error raises
        require(r.status == 200, f"HTTP {r.status}")
        return np.asarray(json.loads(r.read())["predictions"], np.float32)


def unflatten(flat):
    """A flat export ("params/input_ln/scale" ...) → the nested tree."""
    tree = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def trainer_at_full_width(dev, root):
    """The Trainer over the full-width bf16 MaskNet: fit with the prefetch
    feeder and the per-head AUC eval until auc_mean passes TRAINER_AUC, a
    bit-exact checkpoint round trip, and the export served over HTTP in
    bf16 against a direct f32 forward of the restored weights."""
    cfg = masknet.MaskNetConfig(**TRAIN_MODEL)
    w_true = np.random.default_rng(2).normal(size=(cfg.num_features, cfg.num_heads)).astype(np.float32)
    held_x, held_y = next(teacher_batches(3, w_true, TRAINER_HELD_OUT))
    model = masknet.MaskNet(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(2))

    def loss(m, batch):
        return masknet.multi_task_loss(m(batch[0]), batch[1]), {}

    ckpt = os.path.join(root, "ckpt")
    trainer = Trainer(loss, model, TrainerConfig(learning_rate=TRAIN_LR, eval_metric="auc_mean",
                                                 checkpoint_dir=ckpt, checkpoint_every=100, keep_checkpoints=2),
                      device=dev)
    held = torch.from_numpy(held_x).to(dev)
    eval_fn = make_auc_per_head_eval(lambda m, b: torch.sigmoid(m(b)), [(held, held_y)], masknet.DEFAULT_HEAD_NAMES)
    t0 = time.perf_counter()
    out = trainer.fit(teacher_batches(4, w_true, TRAINER_B), TRAINER_STEPS, eval_fn=eval_fn,
                      eval_every=TRAINER_EVAL_EVERY, prefetch=2)
    fit_s = time.perf_counter() - t0
    require(trainer.best_metric is not None and trainer.best_metric > TRAINER_AUC,
            f"the Trainer reached auc_mean {trainer.best_metric} in {TRAINER_STEPS} steps (limit {TRAINER_AUC})")
    # checkpoint round trip: save, train on, restore; bit-equal
    trainer.save()
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    saved_step = trainer.step
    trainer.fit(teacher_batches(5, w_true, TRAINER_B), 3, prefetch=0)
    require(any(not torch.equal(v, saved[k]) for k, v in trainer.model.state_dict().items()), "training on moved nothing")
    trainer.restore()
    require(trainer.step == saved_step and all(torch.equal(v, saved[k]) for k, v in trainer.model.state_dict().items()),
            "restored params differ from those saved")
    # export → registry version → InferenceServer in bf16 over HTTP, answering
    # each head's logit: a trained model's weighted sum of 15 heads cancels
    # near zero, where a score's relative error says little. bf16 keeps 8
    # mantissa bits of every activation, so each logit's error scales with the
    # batch's logits, not with its own value: the limit is SCORE_RTOL of the
    # largest
    trainer.export(os.path.join(root, "models", "masknet", "1"))

    def build(flat):
        served = masknet.MaskNet(cfg, device=dev)
        served.load_state_dict(masknet.params_from_flax(unflatten(flat)))

        def predict(x):
            with torch.inference_mode():
                return served(torch.from_numpy(x).to(dev)).cpu().numpy()

        return predict

    reg = ModelRegistry(os.path.join(root, "models"))
    reg.scan_once()
    srv = InferenceServer(reg, build, batcher_config=BatcherConfig(max_batch_size=256, max_delay_ms=5.0))
    srv.start()
    n_req, per_req = TRAINER_SERVED
    try:
        with ThreadPoolExecutor(n_req) as pool:
            answers = list(pool.map(lambda i: post_json(srv.port, "masknet", held_x[i * per_req:(i + 1) * per_req]),
                                    range(n_req)))
    finally:
        srv.close()
    preds = np.concatenate(answers)
    ref = masknet.MaskNet(masknet.MaskNetConfig(**TRAIN_MODEL, dtype="float32"), device=dev)
    ref.load_state_dict(trainer.model.state_dict())
    with torch.inference_mode():
        want = ref(torch.from_numpy(held_x[:n_req * per_req]).to(dev)).cpu().numpy()
    err = float(np.abs(preds - want).max())
    limit = SCORE_RTOL * float(np.abs(want).max())
    print(f"training: Trainer at full width (bf16, B={TRAINER_B}, adam {TRAIN_LR}, prefetch 2): best auc_mean "
          f"{trainer.best_metric:.4f} at step {trainer.best_step} of {TRAINER_STEPS} (limit {TRAINER_AUC}; held-out "
          f"{TRAINER_HELD_OUT}, a seeded linear teacher), last loss {out['loss']:.4f}, {fit_s:.1f} s of fit; "
          f"checkpoint round trip bit-exact (step {saved_step}); export served over HTTP ({n_req} x {per_req}) in "
          f"bf16 vs the f32 forward: max |logit err| {err:.3g} (limit {limit:.3g}: rtol {SCORE_RTOL} of the "
          f"batch's largest logit)")
    require(preds.shape == want.shape and err <= limit, f"served logits off the f32 forward by {err}")
    del trainer, model, ref, held
    torch.cuda.empty_cache()


def lr_shards(root):
    """Seeded ``lr_examples`` written to TRec shards; the last LR_HELD_OUT
    examples held out as raw arrays."""
    n = LR_SHARDS * LR_PER_SHARD
    feats, labels = synthetic.lr_examples(n + LR_HELD_OUT, num_features=LR_FEATURES, seed=0)
    fids, vals = feats["feature_ids"], feats["values"]
    paths = []
    for s in range(LR_SHARDS):
        rows = range(s * LR_PER_SHARD, (s + 1) * LR_PER_SHARD)
        records = [(dict(zip(fids.tolist(), vals[r].tolist())), {LR_LABEL_FID: float(labels[r])}) for r in rows]
        paths.append(os.path.join(root, f"part-{s:05d}.trec"))
        datarecord.write_records(paths[-1], records, block_size=256)
    return paths, fids, vals[n:], labels[n:]


def lr_gradient_check(dev, batch, labels, params):
    """The weight gradient of one step through the kernels is bit-equal
    across two runs, and its sums (sort + run_collapse) equal the plain
    accumulating scatter (``index_put_(accumulate=True)``, what autograd of
    ``weights[idx]`` does) of the same contributions; then both kernels
    against their plain versions, and the whole gradient against that
    scatter, at this step's shapes."""
    grads = []
    for _ in range(2):
        params.zero_grad(set_to_none=True)
        light_ranker.loss_fn(params, batch, labels).backward()
        grads.append(params.weights.grad.clone())
    require(torch.equal(grads[0], grads[1]), "the light ranker's weight gradient differs between two runs")
    N = params.weights.shape[0]
    ids = gather.jax_rows(batch.indices, N)
    vals = torch.where(batch.mask, batch.values, 0.0)
    with torch.no_grad():
        logits = light_ranker.logits_fn(params, batch)
    dl = ((torch.sigmoid(logits) - labels) / labels.shape[0])[:, None].contiguous()  # d(mean CE)/d(logits)
    flat_ids, flat_c = ids.reshape(-1).long(), (vals * dl).reshape(-1, 1)
    ours = lambda: hashed_lr.weight_grad(ids, vals, dl, N)  # noqa: E731
    lib = lambda: torch.zeros(N, 1, device=dev).index_put_((flat_ids,), flat_c, accumulate=True)  # noqa: E731
    got, want = ours(), lib()
    err, atol = float((got - want).abs().max()), LR_GRAD_RTOL * float(want.abs().max())
    require(torch.allclose(got, want, rtol=LR_GRAD_RTOL, atol=atol),
            f"the kernel-path weight gradient is off index_put_(accumulate=True) by {err:.3g}")
    require(torch.allclose(grads[0][:, None], want, rtol=1e-4, atol=1e3 * atol),
            "the step's weight gradient is not the gradient of its loss")
    # the kernels at this step's shapes
    table = params.weights.detach()[:, None]
    gathered = time_gather(ids, (table,), f"light ranker {tuple(ids.shape)} ids, [{N}, 1] f32 weights")
    entries = retrieval.sort_by_id(ids.reshape(1, -1).contiguous(), flat_c.reshape(1, -1).contiguous())
    collapsed = time_collapse(entries, "light ranker weight gradient's sorted entries")
    grad_ms, lib_ms = timed_pair(ours, lib, clock=lambda fn, reps: device_ms(fn, reps, kernels_only=True))
    print(f"training: light ranker weight gradient bit-equal across two runs; its sums equal "
          f"index_put_(accumulate=True) of the same contributions (max |err| {err:.3g}; rtol {LR_GRAD_RTOL}, atol "
          f"{atol:.3g}: {LR_GRAD_RTOL} of the largest entry); the whole gradient (sort, run_collapse, one write a "
          f"row) device {grad_ms:.4f} ms vs index_put_(accumulate=True) {lib_ms:.4f} ms; row_gather "
          f"{gathered['device_ms']:.4f} ms vs index_select {gathered['plain_device_ms']:.4f} ms, run_collapse "
          f"{collapsed['device_ms']:.4f} ms vs plain {collapsed['plain_device_ms']:.4f} ms")


def light_ranker_lifecycle(dev, root):
    """TRec shards → calibrate → DataRecordTrainer (adagrad) on the card →
    held-out AUC → export → HTTP serve equal to predict_proba; the launches
    of the counted fit (one row_gather and one run_collapse a step)."""
    t0 = time.perf_counter()
    paths, fids, held_vals, held_labels = lr_shards(root)
    write_s = time.perf_counter() - t0
    vocab = np.sort(fids)
    dataset = datarecord.TRecDataset(paths, seed=0)
    hd = drt.calibrate_from_files(dataset, vocab, LR_BINS, LR_BITS)
    transform = datarecord.hashed_lr_transform(vocab, hd.bins.bin_vals, LR_BITS, max_width=LR_FEATURES,
                                               label_vocab=np.asarray([LR_LABEL_FID], np.int64))
    cfg = light_ranker.LightRankerConfig(n_bins=LR_BINS, output_bits=LR_BITS)

    def batch_fn(raw):
        return hashed_lr.SparseBatch(raw["indices"], raw["sparse_values"], raw["sparse_mask"]), raw["labels"][:, 0]

    def loss(params, batch):
        sb, y = batch
        return light_ranker.loss_fn(params, sb, y, l2=cfg.l2), {}

    trainer = drt.DataRecordTrainer(
        loss, light_ranker.init_params(cfg, device=dev), transform, batch_fn,
        drt.DataRecordTrainerConfig(batch_size=LR_BATCH, n_bins=LR_BINS, output_bits=LR_BITS,
                                    trainer=TrainerConfig(learning_rate=0.5, optimizer="adagrad")),
        device=dev)
    torch.cuda.synchronize()
    gather.row_gather.launches = seg_scan.run_collapse_sorted.launches = 0
    t0 = time.perf_counter()
    out = trainer.fit_from_files(dataset, LR_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"row_gather": _build.launches(gather.row_gather),
                "run_collapse": _build.launches(seg_scan.run_collapse_sorted)}
    require(launches == {"row_gather": LR_STEPS, "run_collapse": LR_STEPS},
            f"the light ranker's {LR_STEPS} steps launched {launches}, not one row_gather and one run_collapse a step")
    sb = light_ranker.featurize(hd, fids, held_vals, device=dev)
    with torch.no_grad():
        auc = float(metrics.auc(light_ranker.logits_fn(trainer.params, sb), torch.from_numpy(held_labels).to(dev)))
    require(auc > LR_AUC, f"the light ranker's held-out AUC {auc:.4f} (limit {LR_AUC})")
    vdir = os.path.join(root, "lr_models", "light_ranker", "1")
    trainer.export(vdir, extra={"feature_ids": hd.bins.feature_ids, "bin_vals": hd.bins.bin_vals,
                                "output_bits": np.asarray(LR_BITS)})

    def load(version_dir):
        z = load_params_npz(version_dir)
        return light_ranker.LightRankerModel(z["feature_ids"], z["bin_vals"], torch.from_numpy(z["weights"]).to(dev),
                                             torch.from_numpy(z["bias"]).to(dev), int(z["output_bits"]))

    reg = ModelRegistry(os.path.join(root, "lr_models"), load_fn=load)
    reg.scan_once()
    srv = InferenceServer(reg, lambda m: (lambda x: light_ranker.predict_proba(m, x)),
                          batcher_config=BatcherConfig(max_batch_size=64, max_delay_ms=5.0))
    srv.start()
    try:
        preds = post_json(srv.port, "light_ranker", held_vals[:64])
    finally:
        srv.close()
    want = light_ranker.predict_proba(load(vdir), held_vals[:64])
    np.testing.assert_allclose(preds, want, rtol=LR_PRED_RTOL, atol=LR_PRED_ATOL)
    print(f"training: light ranker lifecycle ({LR_FEATURES} features, 2^{LR_BITS} buckets, {LR_BINS} bins, batch "
          f"{LR_BATCH}): {LR_SHARDS} TRec shards of {LR_PER_SHARD} written in {write_s:.1f} s, calibrated from "
          f"the files, {LR_STEPS} adagrad(0.5) steps in {fit_s:.2f} s (last loss {out['loss']:.4f}), launches "
          f"{launches}; held-out AUC {auc:.4f} (limit {LR_AUC}); export served over HTTP equal to predict_proba "
          f"(max |err| {float(np.abs(preds - want).max()):.3g}; rtol {LR_PRED_RTOL}, atol {LR_PRED_ATOL})")
    batch = put_batch(batch_fn(next(dataset.batches(LR_BATCH, transform, num_epochs=1))), dev)
    lr_gradient_check(dev, batch[0], batch[1], trainer.params)
    return launches


def phase_training(dev):
    """bench.py's train step, the card against the CPU, the Trainer at full
    width and the light ranker's lifecycle. Returns the lifecycle's counted
    launches."""
    bench_train_step(dev)
    masknet_card_against_cpu(dev)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        trainer_at_full_width(dev, root)
        return light_ranker_lifecycle(dev, root)


def child_main(phase) -> int:
    """``chip_smoke.py --training``, ``--tweet-mixer``, ``--phoenix-training``
    or another of ``CHILD_PHASES``: that phase alone, on the card, its
    launches (and the embedding phase's kernel numbers) as the last line of
    output."""
    require(torch.cuda.is_available(), "no CUDA device: this script runs on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    print(json.dumps(phase(torch.device("cuda", 0))))
    return 0


def phase_apart(flag: str, what: str, *args: str, timeout: int = 900):
    """A phase in a child process on the same card, its output passed on,
    its launches returned. On the card the profiler of a process drops
    events of later sessions after some phases: with the training phase in
    the main process (~10 sessions), the copy_ yardsticks of the light
    ranker's collapse and of the live phase's refreshed-index query saw 92
    of 100 and 142 of 150 copies; with the tweet_mixer phase (thousands of
    launches from the main thread and an 8-thread fan-out), the next
    ring-shape session saw 46 of 50 kernels five times running. Both failed
    their runs. Apart, each process runs as many sessions as before those
    phases existed. The tweet_mixer child runs after the main process's last
    session: run before the exact-tier and live phases, or first, it left
    the live fold's session short five times running in both runs that got
    there."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag, *args], capture_output=True, text=True,
                          timeout=timeout)
    sys.stderr.write(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    sys.stdout.write("".join(line + "\n" for line in lines[:-1]))
    require(proc.returncode == 0 and lines, f"the {what} phase failed (exit {proc.returncode})")
    return json.loads(lines[-1])


# tweet-mixer's Home product (tweet_mixer_products.py:48-59): 20 pipelines over
# the step-3 SANN world, the step-4 candidate world and TwHIN / two-tower
# models at their default widths over the 2M-tweet corpus, nothing cut
TM_SHAPE = tweet_mixer_world.FULL
HOME = tmp.TweetMixerProduct.HOME_RECOMMENDED_TWEETS
TM_DIRECT = 8  # served users whose 20 pipelines are called one by one
TM_DENSE = 4  # users whose dense top-200s are held against float64
TM_CPU = 2  # users whose Home request is held against the port on the CPU
TM_SERIAL = 32  # serial Home requests on the host clock
TM_PROFILED = 3  # Home requests in the profiler session
# the dense engines: their pipeline, the table they scan, the query vector
TM_DENSE_PIPES = ("twhin_consumer_based", "twhin_tweet_similarity", "deep_retrieval_user_tweet",
                  "deep_retrieval_tweet_tweet", "two_tower_consumer")
# dense top-200 against float64: f32 products of 128 terms
DENSE_RTOL, DENSE_ATOL = 1e-5, 1e-6


def dense_query(tw, name, q):
    """(the table a dense pipeline scans, the vector it scans with) for query ``q``."""
    t = cat._source_tweet(q)
    return {"twhin_consumer_based": (tw.twhin.item_table, lambda: tw.twhin_user_vector(q.user_id)),
            "twhin_tweet_similarity": (tw.twhin.item_table, lambda: tw.twhin_tweet_vector(t)),
            "deep_retrieval_user_tweet": (tw.two_tower_items, lambda: tw.two_tower_user_vector(q.user_id)),
            "deep_retrieval_tweet_tweet": (tw.two_tower_items, lambda: tw.two_tower_tweet_vector(t)),
            "two_tower_consumer": (tw.two_tower_items, lambda: tw.two_tower_user_vector(q.user_id))}[name]


def brute_force_dense(table, vectors, k):
    """Float64 numpy top-k of ``table @ v`` for each of ``vectors`` [Q, D]:
    (ids [Q, k], scores [Q, k]), ranked by score, then row."""
    q64 = vectors.astype(np.float64)
    scores = np.concatenate([table[s:s + (1 << 18)].cpu().numpy().astype(np.float64) @ q64.T
                             for s in range(0, table.shape[0], 1 << 18)]).T  # [Q, N]
    ids = np.empty((len(q64), k), np.int64)
    for r, row in enumerate(scores):
        part = np.argpartition(-row, k)[:k]
        ids[r] = part[np.lexsort((part, -row[part]))]
    return ids, np.take_along_axis(scores, ids, 1)


def ranked_arrays(cands):
    return np.array([[c.id for c in cands]], np.int64), np.array([[c.score for c in cands]], np.float32)


def home_lists(catalog, q):
    """Each routed Home pipeline's candidates for ``q`` by spec name, called
    directly (not through run_product's fail-open), in routing order."""
    routed = tmp.product_pipelines(catalog, HOME, q, Params())
    return {spec.name: pipe.source.get(q, Params()) for spec, pipe in catalog if pipe in routed}


def check_blend(got, want, moved, what):
    """Two blended lists: ids equal at every place but where both ids moved
    between the two sides' pipeline lists (near-ties); scores of equal ids
    within EB_RTOL / EB_ATOL."""
    require(len(got) == len(want), f"{what}: {len(got)} candidates against {len(want)}")
    for a, b in zip(got, want):
        if a.id != b.id:
            require(a.id in moved and b.id in moved, f"{what}: id {a.id} against {b.id} away from a near-tie")
        else:
            require(abs(a.score - b.score) <= EB_ATOL + EB_RTOL * abs(b.score), f"{what}: id {a.id} scored apart")


def phase_tweet_mixer(dev, sann=None):
    """tweet-mixer's Home product at bench.py's sizes on the card: the world
    (over the SANN and candidate worlds of steps 3-4, built from the same
    seeds), each of the 20 pipelines called directly, one counted request,
    the dense engines against float64, Home against the CPU, and the host
    clock. Returns the counted launches and the world the profile at the
    end of the run takes."""
    t0 = time.perf_counter()
    tw = tweet_mixer_world.build(TM_SHAPE, device=dev, sann=sann)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    items = tweet_mixer_world.export_item_table(tw.two_tower)
    require(torch.allclose(items, tw.two_tower_items, rtol=1e-6, atol=1e-7), "the item table export is not repeatable")
    del items
    export_ms = cuda_ms(lambda: tweet_mixer_world.export_item_table(tw.two_tower), 3)
    tables = [tw.twhin.item_table, tw.twhin.user_table, tw.two_tower.item_table, tw.two_tower_items]
    print(f"tweet_mixer: world (TwHIN and two-tower {TM_SHAPE.num_users} users x {TM_SHAPE.num_items} items x "
          f"{TM_SHAPE.embed_dim}, tower {TM_SHAPE.tower_hidden}; {sum(t.numel() * 4 for t in tables) / 1e9:.2f} GB of "
          f"tables, over the SANN and candidate worlds of steps 3-4) built in {build_s:.1f} s with the SANN and candidate "
          f"worlds (set-up); the two-tower item "
          f"table exported through the item tower in {export_ms:.2f} ms (CUDA events, mean of 3 warm exports)")

    # each Home pipeline called directly: run_product and the engines fail open,
    # so only a direct call shows that an engine ran on the card
    catalog = cat.build_catalog(tw.source_world())
    sizes = Counter()
    for q in tw.queries[:TM_DIRECT]:
        lists = home_lists(catalog, q)
        require(len(lists) == 20, f"user {q.user_id}: {len(lists)} Home pipelines routed, not 20")
        for name, got in lists.items():
            require(len(got) > 0, f"user {q.user_id}: Home pipeline {name} returned nothing")
            require(all(np.isfinite(c.score) for c in got), f"user {q.user_id}: {name} returned non-finite scores")
            sizes[name] += len(got) / TM_DIRECT
    print(f"tweet_mixer: all 20 Home pipelines non-empty for {TM_DIRECT} users called directly; mean candidates "
          f"{dict((k, round(v, 1)) for k, v in sizes.items())}")

    # the main path, counted: one Home request (a fresh catalog: the lookup cache cold)
    q = tw.queries[0]
    fresh = cat.build_catalog(tw.source_world())
    names = [s.name for s, p in fresh if p in tmp.product_pipelines(fresh, HOME, q, Params())]
    seg_scan.run_collapse_sorted.launches = 0
    gather.row_gather.launches = 0
    home = tmp.run_product(fresh, HOME, q)
    torch.cuda.synchronize()
    launches = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                "row_gather": _build.launches(gather.row_gather)}
    want = tweet_mixer_world.expected_launches(names, q)
    print(f"tweet_mixer: one Home request (user {q.user_id}, {len(q.recent_engagement_ids)} recent tweets) -> "
          f"{len(home)} candidates, launches {launches}; the routed pipelines make {want}")
    require(launches == want, f"Home launches {launches}, the routed pipelines make {want}")
    require(len(home) == tmp.PRODUCT_SPECS[HOME].max_results and len({c.id for c in home}) == len(home),
            "the Home request did not fill its 400 distinct candidates")

    # the dense engines' top-200 against a float64 numpy brute force
    moved_dense, t0 = 0, time.perf_counter()
    by_table = {}
    for q in tw.queries[:TM_DENSE]:
        lists = home_lists(catalog, q)
        for name in TM_DENSE_PIPES:
            table, vec = dense_query(tw, name, q)
            by_table.setdefault(id(table), (table, []))[1].append((name, q, vec().cpu().numpy(), lists[name]))
    for table, rows in by_table.values():
        want_ids, want_scores = brute_force_dense(table, np.stack([v for _, _, v, _ in rows]), 200)
        for r, (name, q, _, got) in enumerate(rows):
            ids, scores = ranked_arrays(got)
            moved_dense += check_same_ranking(ids, scores, want_ids[r:r + 1], want_scores[r:r + 1], DENSE_RTOL,
                                              DENSE_ATOL, f"{name} user {q.user_id} against float64")
    print(f"tweet_mixer: {len(TM_DENSE_PIPES)} dense engines x {TM_DENSE} users: top-200 equal to a float64 numpy "
          f"brute force over {TM_SHAPE.num_items} items ({moved_dense} ranks hold another id, all within near-ties; "
          f"scores rtol {DENSE_RTOL}, atol {DENSE_ATOL}; {time.perf_counter() - t0:.1f} s)")

    # Home on the card against the port on the CPU
    t0 = time.perf_counter()
    cpu_world = tw.to("cpu")
    cpu_catalog = cat.build_catalog(cpu_world.source_world())
    moved = 0
    for q in tw.queries[:TM_CPU]:
        card, cpu = home_lists(catalog, q), home_lists(cpu_catalog, q)
        require(list(card) == list(cpu), f"user {q.user_id}: routed pipelines differ")
        moved_ids = set()
        for name in card:
            a, b = ranked_arrays(card[name]), ranked_arrays(cpu[name])
            moved += check_same_ranking(*a, *b, EB_RTOL, EB_ATOL, f"Home {name} user {q.user_id}, card against CPU")
            moved_ids |= {int(x) for x, y in zip(a[0][0], b[0][0]) if x != y} | {
                int(y) for x, y in zip(a[0][0], b[0][0]) if x != y}
        check_blend(tmp.run_product(catalog, HOME, q), tmp.run_product(cpu_catalog, HOME, q), moved_ids,
                    f"Home user {q.user_id}, card against CPU")
    del cpu_world, cpu_catalog
    print(f"tweet_mixer: Home on the card equal to the port on the CPU for {TM_CPU} users: every pipeline's ranking "
          f"and the blended 400 ({moved} pipeline ranks hold another id, all within near-ties; rtol {EB_RTOL}, atol "
          f"{EB_ATOL}; {time.perf_counter() - t0:.1f} s with the CPU run)")

    # host clock, before any profiler session of this phase: serial Home
    # requests (distinct users, the lookup cache cold), then the 8-thread fan-out
    warm = cat.build_catalog(tw.source_world())
    for q in tw.queries[-4:]:
        tmp.run_product(warm, HOME, q)
    serial = cat.build_catalog(tw.source_world())
    lat, blended = [], {}
    for q in tw.queries[:TM_SERIAL]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blended[q.user_id] = tmp.run_product(serial, HOME, q)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    lat = np.array(lat) * 1e3
    print(f"tweet_mixer: serial Home {len(lat) / lat.sum() * 1e3:.1f} requests/s, p50 {np.percentile(lat, 50):.2f} ms, "
          f"p99 {np.percentile(lat, 99):.2f} ms ({len(lat)} requests; host clock; not a benchmark)")
    # the fan-out, warmed on the warm catalog's engines and timed on a fresh
    # catalog's: the lookup cache cold, as in the serial run
    def fan_out(catalog):
        return tm.TweetMixer([p.source for p in tmp.product_pipelines(catalog, HOME, tw.queries[0], Params())],
                             max_results=tmp.PRODUCT_SPECS[HOME].max_results, max_concurrency=8)

    warm_mixer, mixer = fan_out(warm), fan_out(cat.build_catalog(tw.source_world()))
    try:
        warm_mixer.get_candidates(tw.queries[-1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fanned = {q.user_id: mixer.get_candidates(q) for q in tw.queries[:TM_SERIAL]}
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        warm_mixer.close()
        mixer.close()
    print(f"tweet_mixer: TweetMixer with an 8-thread fan-out {TM_SERIAL / dt:.1f} requests/s ({1e3 * dt / TM_SERIAL:.2f} "
          f"ms a request; host clock; not a benchmark)")
    same = sum([c.id for c in fanned[u]] == [c.id for c in blended[u]] for u in fanned)
    require(same == len(fanned), f"the fan-out blended {len(fanned) - same} of {len(fanned)} requests otherwise than "
                                 "run_product")
    torch.cuda.empty_cache()
    return launches, tw


def home_device_ms(tw, reps):
    """Device time of each Home pipeline in one request, from ONE profiler
    session of ``reps`` requests (fresh catalogs, distinct users): each
    kernel is charged to the pipeline whose range launched it."""
    PROFILER["sessions"] += 1
    catalogs = [cat.build_catalog(tw.source_world()) for _ in range(reps)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for catalog, q in zip(catalogs, tw.queries[-reps:]):
            routed = tmp.product_pipelines(catalog, HOME, q, Params())
            for spec, pipe in catalog:
                if pipe in routed:
                    with torch.profiler.record_function(f"tm:{spec.name}"):
                        pipe.source.get(q, Params())
        torch.cuda.synchronize()
    # the ranges show up on the device too (as annotations spanning their kernels): left out of the total
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not e.key.startswith("tm:")) / 1000 / reps
    by, kernels = Counter(), Counter()
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        p = e
        while p is not None and not p.name.startswith("tm:"):
            p = p.cpu_parent
        name = p.name[3:] if p is not None else "(outside the pipelines)"
        for k in e.kernels:
            by[name] += k.duration / 1000 / reps
            kernels[k.name[:50]] += k.duration / 1000 / reps
    return by, kernels, total


def home_graph_inputs(tw, q):
    """The inputs one Home request of ``q`` hands the batched graph paths,
    by pipeline: each UTEG-family engine's [1, S] seeds and weights to
    ``uteg.recommend`` and each UTG call's [1] source tweet to
    ``graphjet.related_tweets`` (a fresh catalog, each pipeline called
    directly)."""
    catalog = cat.build_catalog(tw.source_world())
    routed = tmp.product_pipelines(catalog, HOME, q, Params())
    seen, current = {}, [None]
    recommend, related = uteg.recommend, graphjet.related_tweets

    def recommend_seen(graph, seed_ids, seed_weights, **kw):
        seen.setdefault(current[0], []).append(("uteg", graph, seed_ids, seed_weights))
        return recommend(graph, seed_ids, seed_weights, **kw)

    def related_seen(left, right, sources, **kw):
        seen.setdefault(current[0], []).append(("utg", left, right, sources))
        return related(left, right, sources, **kw)

    uteg.recommend, graphjet.related_tweets = recommend_seen, related_seen
    try:
        for spec, pipe in catalog:
            if pipe in routed:
                current[0] = spec.name
                pipe.source.get(q, Params())
    finally:
        uteg.recommend, graphjet.related_tweets = recommend, related
    return seen


def time_home_graph_kernels(tw, q):
    """Both kernels at the UTEG family's R=1 shapes (one per seed count) and
    at UTG's B=1 hops and dedup (one source tweet: every UTG call of the
    request has these shapes), on ``q``'s own inputs."""
    timed_seeds, utg = set(), None
    for name, calls in home_graph_inputs(tw, q).items():
        for call in calls:
            if call[0] == "utg":
                utg = utg or (name, *call[1:])
                continue
            _, graph, seed_ids, seed_weights = call
            S = seed_ids.shape[1]
            if S in timed_seeds:
                continue
            timed_seeds.add(S)
            U, W = graph.tweet_ids.shape
            time_gather(uteg.safe_rows(seed_ids, U).reshape(-1), tuple(graph),
                        f"Home {name}'s seed rows, {S} rows x 3 tables [{U}, {W}] int32")
            time_collapse(retrieval.sort_by_id(*uteg.engagement_entries(graph, seed_ids, seed_weights)),
                          f"Home {name}'s sorted entries ({S} seeds)", copy_yardstick=False)
    require(utg is not None, "the Home request made no UTG call")
    name, left, right, sources = utg
    hop1 = gather.jax_rows(sources, right.user_ids.shape[0])
    time_gather(hop1, (right.user_ids, right.timestamps),
                f"Home {name}'s first hop, 1 row x 2 tables [{right.user_ids.shape[0]}, {right.user_ids.shape[1]}] int32")
    flat, ones, users = graphjet.cooccurrence_entries(left, right, sources)
    hop2 = gather.jax_rows(torch.where(users != PAD_ID, users, 0), left.tweet_ids.shape[0]).reshape(-1)
    time_gather(hop2, (left.tweet_ids, left.timestamps), f"Home {name}'s second hop, {hop2.numel()} rows x 2 tables "
                                                         f"[{left.tweet_ids.shape[0]}, {left.tweet_ids.shape[1]}] int32")
    time_collapse(retrieval.sort_by_id(flat, ones), f"Home {name}'s sorted entries", copy_yardstick=False)


def phase_tweet_mixer_alone(dev, root=None):
    """The tweet_mixer phase in its own process (``--tweet-mixer [dir]``:
    the SANN world from :func:`save_world`'s files, else built), then its
    profile and kernel timings. Returns the counted request's launches."""
    launches, tw = phase_tweet_mixer(dev, saved_sann(root, dev))
    phase_tweet_mixer_times(tw)
    return launches


def phase_tweet_mixer_times(tw):
    """After the phase's host-clock numbers: one Home request's device time
    by pipeline, and both kernels against their plain versions at its
    per-query shapes (no copy_ yardstick: after the phase's launches the
    profiler may drop copy events of short sessions)."""
    by, kernels, total = home_device_ms(tw, TM_PROFILED)
    dense = sum(by[n] for n in TM_DENSE_PIPES)
    dense_bound = bound_ms(len(TM_DENSE_PIPES) * TM_SHAPE.num_items * TM_SHAPE.embed_dim * 4)
    print(f"tweet_mixer: one Home request's device time {total:.3f} ms, {sum(by.values()):.3f} of it charged to a "
          f"pipeline (mean of {TM_PROFILED} requests, torch.profiler), by pipeline: "
          + ", ".join(f"{k} {v:.3f}" for k, v in by.most_common()))
    print(f"tweet_mixer: the five dense engines {dense:.3f} ms of device time against their {dense_bound:.3f} ms bound "
          f"(five [{TM_SHAPE.num_items}, {TM_SHAPE.embed_dim}] f32 tables read once at 3.35 TB/s); top kernels "
          + ", ".join(f"{k} {v:.3f}" for k, v in kernels.most_common(6)))

    q = tw.queries[0]
    src = sparse.truncate(SparseEmbedding(*(t[None] for t in tw.interested_in(q.user_id))), TM_SHAPE.sann.N)
    safe = torch.where(src.valid_mask(), src.ids, 0).reshape(-1).contiguous()  # [N] = 50 cluster rows
    index = tw.sann.index
    tables = (index.tweet_ids, index.scores, index.timestamps)
    time_gather(safe, tables, f"a Home SANN query's cluster rows, {safe.numel()} rows x 3 tables "
                              f"[{index.tweet_ids.shape[0]}, {index.tweet_ids.shape[1]}]")
    rows = tuple(r.reshape(1, *src.ids.shape[1:], -1) for r in gather.row_gather(safe, *tables))
    entries = retrieval.sort_by_id(*retrieval.scan_entries(*rows, src))
    time_collapse(entries, "a Home SANN query's sorted entries", copy_yardstick=False)
    uid = torch.tensor([q.user_id], dtype=torch.int32, device=index.scores.device)
    time_gather(uid, (tw.twhin.item_table,), f"a TwHIN item row, 1 row x [{TM_SHAPE.num_items}, "
                                              f"{TM_SHAPE.embed_dim}] f32 (512 B)")
    time_gather(uid, (tw.twhin.user_table,), f"a TwHIN user row, 1 row x [{TM_SHAPE.num_users}, "
                                              f"{TM_SHAPE.embed_dim}] f32 (512 B)")
    time_home_graph_kernels(tw, q)



# embedding-table training (two-tower and TwHIN) at tweet-mixer's widths:
# 16,384 users x 2,000,000 items x D=128 f32 tables, the planted engagements
# of data/tweet_mixer_world.py, B=4,096 in-batch negatives, the Trainer's adam
EMB_B = tweet_mixer_world.TRAIN_B  # 4,096 in-batch negatives (the world's choice; the JAX tests use 16-64)
EMB_LR = 1e-2  # adam's learning rate (TrainerConfig)
EMB_STEPS = 300  # steps of each model's fit
EMB_TIMED = 20  # loop-carried steps timed with CUDA events
EMB_EVAL_USERS = 1024  # users whose planted item's rank is read
EMB_K = 100
EMB_HITS = 0.5  # hits@100 over all 2M items each model must reach (untrained ~5e-5)
EMB_SERVED_K = 200  # a dense engine's list: the planted item must be in it
# the table gradient against index_put_(accumulate=True): f32 sums in another
# order (atomics), so within this share of each entry or of the largest
EMB_LIB_RTOL = 1e-6
# the card against the CPU: a small-width f32 model (TF32 off), GRAD_STEPS
# Trainer steps from the same weights, at the training phase's tolerances
EMB_SMALL = dict(users=64, items=500, dim=32, hidden=(32,), batch=48)
# launches of one counted step: a row_gather a table read, a D-wide collapse a table gradient
EMB_LAUNCHES = {"two_tower": {"row_gather": 2, "run_collapse_rows": 2, "run_collapse": 0},
                "twhin": {"row_gather": 3, "run_collapse_rows": 3, "run_collapse": 0}}
RG_USERS, RG_DEGREE, RG_EVENTS, RG_BATCH = 16_384, 32, 65_536, 256  # RealGraph: bench.py's 65,536 events
WALS_SHAPE = dict(users=1024, items=2048, dim=32, iterations=5, history=64)


def embedding_models(dev, shape=None, seed=13, explicit=False):
    """Trainable two-tower and TwHIN models at the world's widths (with
    ``explicit``: reading through the row exchange, on a mesh)."""
    s = shape or TM_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed)
    tt = two_tower.TwoTower(two_tower.TwoTowerConfig(s.num_users, s.num_items, s.embed_dim, s.tower_hidden,
                                                     explicit_lookup=explicit), device=dev, generator=gen)
    th = twhin.Twhin(twhin.TwhinConfig(s.num_users, s.num_items, s.embed_dim, explicit_lookup=explicit), device=dev,
                     generator=gen)
    return tt, th


def collapse_inputs(trainer, batch):
    """The (sorted ids, permutation, dy, table rows) each table gradient of
    one step hands the D-wide collapse, by table, in backward order."""
    seen, inner = [], gather.run_collapse_rows

    def recording(ids, perm, dy, num_rows):
        seen.append((ids.clone(), perm.clone(), dy.clone(), num_rows))
        return inner(ids, perm, dy, num_rows)

    gather.run_collapse_rows = recording
    try:
        trainer.train_step(batch)
    finally:
        gather.run_collapse_rows = inner
    torch.cuda.synchronize()
    return seen


def collapse_rows_sums64(ids, perm, dy, num_rows):
    """Float64 sums of each row's slots and of their magnitudes, and each
    row's count of slots, on the card (index_add_ in float64)."""
    keep = (ids >= 0) & (ids < num_rows)
    rows = torch.where(keep, ids, num_rows).long()
    x = dy[perm].double()
    sums = torch.zeros((num_rows + 1, dy.shape[1]), dtype=torch.float64, device=dy.device).index_add_(0, rows, x)
    mags = torch.zeros_like(sums).index_add_(0, rows, x.abs())
    terms = torch.bincount(rows, minlength=num_rows + 1)[:num_rows]
    return sums[:num_rows], mags[:num_rows], terms


# bytes copied before each call of a cold-L2 timing: more than twice the H100's
# 50 MB L2, so none of a kernel's inputs is left there
L2_FLUSH_BYTES = 128 << 20
_FLUSH = []


def cold_device_ms(fn, dev, reps=20):
    """Device time of one call of ``fn`` that finds the L2 cold, as a call
    inside a training step does: an L2_FLUSH_BYTES ``copy_`` (left out of
    the time, as every Memcpy) before each of ``reps`` calls."""
    if not _FLUSH:
        _FLUSH.extend(torch.empty(L2_FLUSH_BYTES // 8, dtype=torch.int32, device=dev) for _ in range(2))
    src, dst = _FLUSH
    return device_ms(lambda: (dst.copy_(src), fn()), reps, kernels_only=True)


def time_collapse_rows(ids, perm, dy, num_rows, label, hold_to_plain=True):
    """The D-wide collapse on one input: one launch a call, bit-equal run to
    run, each row no slot names exactly 0; the kernel, its plain version
    and index_put_(accumulate=True) each within m·2⁻²⁴·Σ|x| of the float64
    sums (a run of m terms: the bound of any order of summation); the kernel
    within SUM_RTOL of each entry's Σ|x| (+ SUM_ATOL) of its plain version
    and, with ``hold_to_plain`` (the path's own inputs), within SUM_RTOL /
    SUM_ATOL of each entry too, and within EMB_LIB_RTOL of index_put_; each
    side's time on CUDA events and in device time, warm and with the L2
    cold. The kernel writes the whole dense gradient, zeros included (above
    ``seg_scan.FILL_BYTES``, after a ``torch.zeros`` fill, which is timed with it)."""
    before = _build.launches(seg_scan.run_collapse_rows)
    got = seg_scan.run_collapse_rows(ids, perm, dy, num_rows)
    again = seg_scan.run_collapse_rows(ids, perm, dy, num_rows)
    torch.cuda.synchronize()
    require(_build.launches(seg_scan.run_collapse_rows) == before + 2,
            f"run_collapse_rows: not one launch a call at {label}")
    plain = seg_scan.run_collapse_rows_plain(ids, perm, dy, num_rows)
    keep = (ids >= 0) & (ids < num_rows)
    rows_unsorted = torch.empty(ids.shape, dtype=torch.long, device=ids.device).scatter_(
        0, perm, torch.where(keep, ids, num_rows).long())  # the table read's own order

    def library():
        return torch.zeros((num_rows + 1, dy.shape[1]), device=dy.device).index_put_(
            (rows_unsorted,), dy, accumulate=True)[:num_rows]

    lib = library()
    torch.cuda.synchronize()
    require(torch.equal(got, again), f"run_collapse_rows not bit-equal run to run at {label}")
    sums, mags, terms = collapse_rows_sums64(ids, perm, dy, num_rows)
    bound = terms[:, None].double() * 2.0 ** -24 * mags
    for name, side in (("the kernel", got), ("the plain version", plain), ("index_put_", lib)):
        require(bool(((side.double() - sums).abs() <= bound).all()),
                f"run_collapse_rows: {name} beyond m·2⁻²⁴·Σ|x| of the float64 sums at {label}")
    require(bool((got[terms == 0] == 0.0).all()), f"run_collapse_rows: a row no slot names is not 0 at {label}")
    diff = (got - plain).abs()
    err = float(diff.max())
    require(bool((diff.double() <= SUM_RTOL * mags + SUM_ATOL).all()),
            f"run_collapse_rows off its plain version by more than {SUM_RTOL}·Σ|x| + {SUM_ATOL} at {label}")
    outside = int((diff > SUM_ATOL + SUM_RTOL * plain.abs()).sum())  # entries outside rtol / atol of plain's own
    scale = float(lib.abs().max())
    lib_err = float((got - lib).abs().max())
    if hold_to_plain:
        require(outside == 0, f"run_collapse_rows off its plain version at {label}")
        require(bool(((got - lib).abs() <= EMB_LIB_RTOL * (lib.abs() + scale)).all()),
                f"run_collapse_rows off index_put_(accumulate=True) at {label} (max |diff| {lib_err:.3g})")
    worst = float(((got.double() - sums).abs() / bound.clamp(min=1e-30)).max())
    del sums, mags, bound, diff
    n, D = dy.shape
    distinct = int(torch.unique(ids[keep]).numel())
    kernel = lambda: seg_scan.run_collapse_rows(ids, perm, dy, num_rows)  # noqa: E731
    plain_fn = lambda: seg_scan.run_collapse_rows_plain(ids, perm, dy, num_rows)  # noqa: E731
    ms, plain_ms = timed_pair(kernel, plain_fn)
    lib_ms = cuda_ms(library, 50)
    dev_ms, plain_dev_ms, lib_dev_ms = device_ms(kernel, 50), device_ms(plain_fn, 50), device_ms(library, 50)
    cold_ms = cold_device_ms(kernel, dy.device)
    # the function's bytes: ids and permutation and each dy row read once, the
    # dense [N, D] gradient written once
    moved = n * (4 + 8 + 4 * D) + num_rows * D * 4
    bound_t = bound_ms(moved)
    print(f"kernel run_collapse_rows: {label}: {n} slots, {distinct} runs into [{num_rows}, {D}]; one launch a call, "
          f"bit-equal run to run, untouched rows 0; each side within m·2⁻²⁴·Σ|x| of float64 (the kernel at "
          f"{worst:.3g} of it); max |err| {err:.3g} vs plain ({outside} entries outside rtol {SUM_RTOL} / atol "
          f"{SUM_ATOL} of plain's own value; none beyond {SUM_RTOL}·Σ|x| + {SUM_ATOL}), {lib_err:.3g} vs "
          f"index_put_(accumulate=True); device {dev_ms:.4f} ms ({moved / dev_ms / 1e9:.2f} TB/s, "
          f"{100 * bound_t / dev_ms:.1f}% of its {bound_t:.4f} ms bound), {cold_ms:.4f} ms with the L2 cold, plain "
          f"{plain_dev_ms:.4f} ms, index_put_ {lib_dev_ms:.4f} ms; events {ms:.4f} / {plain_ms:.4f} / {lib_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms, plain_device_ms=plain_dev_ms,
                bound_ms=bound_t, bound_by="bytes", library_ms=lib_ms, library_device_ms=lib_dev_ms,
                cold_device_ms=cold_ms)


def embedding_step_breakdown(model, loss_fn, opt, batch, reps=2):
    """One profiler session of ``reps`` steps: device time by part (the
    forward, the backward without the table gradients' kernels, the table
    gradients' collapse kernels, the update). A ``torch.zeros`` fill before
    a collapse of over ``seg_scan.FILL_BYTES`` counts as backward."""
    def step():
        opt.zero_grad(set_to_none=True)
        with torch.profiler.record_function("forward"):
            loss, _ = loss_fn(model, batch)
        loss.backward()
        with torch.profiler.record_function("update"):
            opt.step()

    for _ in range(2):
        step()
    PROFILER["sessions"] += 1
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    parts, kernels = Counter(), Counter()
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        backward = any(n.startswith("autograd::engine") for n in chain)
        for k in e.kernels:
            if "run_collapse_rows" in k.name:
                part = "table gradient (collapse)"
            elif backward:
                part = "backward"
            elif "update" in chain:
                part = "update"
            else:
                part = "forward"
            parts[part] += k.duration / 1000 / reps
            kernels[k.name[:60]] += k.duration / 1000 / reps
    return parts, kernels.most_common(5)


def train_full_width(dev, name, model, loss_fn, batches, hits_fn):
    """One model's fit at full width through the Trainer: the counted step,
    steps on CUDA events, the device-time breakdown, hits@100 before and
    after. Returns the counted launches, the collapse's inputs of one step,
    and the trained model."""
    tr = Trainer(loss_fn, model, TrainerConfig(learning_rate=EMB_LR), device=dev)
    untrained = hits_fn(model)
    torch.cuda.reset_peak_memory_stats(dev)
    first = put_batch(next(batches), dev)
    seg_scan.run_collapse_sorted.launches = 0
    seg_scan.run_collapse_rows.launches = 0
    gather.row_gather.launches = 0
    loss0 = float(tr.train_step(first)["loss"])
    torch.cuda.synchronize()
    launches = {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                "row_gather": _build.launches(gather.row_gather),
                "run_collapse_rows": _build.launches(seg_scan.run_collapse_rows)}
    require(launches == EMB_LAUNCHES[name], f"{name} step launches {launches}, want {EMB_LAUNCHES[name]}")
    inputs = collapse_inputs(tr, put_batch(next(batches), dev))
    timed = [put_batch(next(batches), dev) for _ in range(EMB_TIMED)]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for b in timed:
        tr.train_step(b)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / EMB_TIMED
    t0 = time.perf_counter()
    while tr.step < EMB_STEPS:
        out = tr.train_step(next(batches))
    loss = float(out["loss"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    parts, top = embedding_step_breakdown(model, loss_fn, tr.optimizer, timed[0])
    trained = hits_fn(model)
    n_params = sum(p.numel() for p in model.parameters())
    require(np.isfinite(loss) and loss < loss0, f"{name}: the loss did not fall ({loss0} -> {loss})")
    print(f"embedding_training: {name} ({n_params / 1e6:.1f}M f32 params, B={EMB_B}, adam {EMB_LR}): one step "
          f"{step_ms:.3f} ms over {EMB_TIMED} loop-carried steps (CUDA events, not a benchmark); {EMB_STEPS} steps, "
          f"loss {loss0:.4f} -> {loss:.4f} ({fit_s:.1f} s on the host clock for the last {EMB_STEPS - 2 - EMB_TIMED}); "
          f"peak memory {peak / 2**30:.2f} GiB; launches a step {launches}")
    print(f"embedding_training: {name} step device time by part (one profiler session): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.most_common()) + f"; total {sum(parts.values()):.3f} ms; "
          f"the dense Adam's bound {bound_ms(7 * 4 * n_params):.3f} ms (p, g, m, v read, p, m, v written); longest "
          "kernels " + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
    print(f"embedding_training: {name} hits@{EMB_K} of the planted item over all {TM_SHAPE.num_items} items, "
          f"{EMB_EVAL_USERS} users: untrained {untrained}, trained {trained} (at least {EMB_HITS} required)")
    require(all(h >= EMB_HITS for h in np.atleast_1d(trained)), f"{name}: hits@{EMB_K} {trained} below {EMB_HITS}")
    model.zero_grad(set_to_none=True)
    return launches, inputs, model


def embedding_card_against_cpu(dev):
    """Small-width f32 two-tower and TwHIN models on the card and on the
    CPU through the Trainer from the same weights and batches: the first
    step's gradients per parameter, the params after GRAD_STEPS steps."""
    s = EMB_SMALL
    shape = SimpleNamespace(num_users=s["users"], num_items=s["items"], embed_dim=s["dim"], tower_hidden=s["hidden"])
    rng = np.random.default_rng(3)
    batches = [{"users": rng.integers(-2, s["users"] + 2, s["batch"]).astype(np.int32),
                "relations": rng.integers(0, len(twhin.RELATIONS), s["batch"]).astype(np.int32),
                "items": rng.integers(-2, s["items"] + 2, s["batch"]).astype(np.int32)} for _ in range(GRAD_STEPS)]
    report = []
    for idx, (name, loss_fn) in enumerate((("two_tower", tweet_mixer_world.two_tower_train_loss),
                                           ("twhin", tweet_mixer_world.twhin_train_loss))):
        ref = embedding_models(dev, shape, seed=5)[idx].state_dict()
        runs = []
        for where in (dev, torch.device("cpu")):
            model = embedding_models(where, shape, seed=5)[idx]
            model.load_state_dict(ref)
            tr = Trainer(loss_fn, model, TrainerConfig(learning_rate=EMB_LR), device=where)
            grads = None
            for b in batches:
                tr.train_step(b)
                if grads is None:
                    grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()}
            runs.append((grads, {k: v.detach().cpu() for k, v in model.state_dict().items()}))
        (g_card, p_card), (g_cpu, p_cpu) = runs
        worst = max(float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max().clamp(min=1e-30)) for k in g_cpu)
        require(worst <= GRAD_SCALE_TOL, f"{name}: card gradients off the CPU's by {worst:.3g} of a parameter's largest")
        diffs = torch.cat([(p_card[k] - p_cpu[k]).abs().reshape(-1) for k in p_cpu])
        max_diff, outliers = float(diffs.max()), float((diffs > PARAM_ATOL).double().mean())
        require(max_diff <= 2 * GRAD_STEPS * EMB_LR and outliers <= PARAM_OUTLIERS,
                f"{name}: params after {GRAD_STEPS} steps: card vs CPU max {max_diff:.3g}, {outliers:.3g} beyond "
                f"{PARAM_ATOL}")
        report.append(f"{name} gradients within {worst:.3g} of each parameter's largest entry, params after "
                      f"{GRAD_STEPS} steps max |diff| {max_diff:.3g}, share beyond {PARAM_ATOL:g} {outliers:.3g}")
    print(f"embedding_training: card against CPU (f32, TF32 off, {s['users']} users x {s['items']} items x "
          f"{s['dim']}, B={s['batch']}, ids past both ends; limits {GRAD_SCALE_TOL}, 2·steps·lr = "
          f"{2 * GRAD_STEPS * EMB_LR:g}, {PARAM_OUTLIERS:g}): " + "; ".join(report))


def realgraph_card_against_cpu(dev):
    """RealGraph's edge model on a table folded from RG_EVENTS seeded
    interactions: 100 adam steps of loss_fn on the card and on the CPU from
    the same start (the losses alike), then top_edges for RG_BATCH users
    (one row_gather launch) with the card's params on both."""
    rng = np.random.default_rng(41)
    F = len(realgraph.INTERACTION_TYPES)
    src = rng.integers(0, RG_USERS, RG_EVENTS).astype(np.int32)
    dst = (rng.zipf(1.5, RG_EVENTS) % RG_USERS).astype(np.int32)
    it = rng.integers(0, F, RG_EVENTS).astype(np.int32)
    ts = np.sort(rng.integers(0, 30 * 86400, RG_EVENTS)).astype(np.int32)
    t0 = time.perf_counter()
    table = realgraph.apply_interactions(realgraph.init_table(RG_USERS, RG_DEGREE, dev), src, dst, it, ts)
    fold_s = time.perf_counter() - t0
    now = 31 * 86400
    feats = realgraph.edge_features(table, now)
    x = feats[table.neighbor_ids != PAD_ID][:65_536]
    y = (x[:, 0] > x[:, 1:].sum(dim=1)).float()  # a fav-dominated edge: the label
    start = realgraph.init_model(torch.Generator(device=dev).manual_seed(0), device=dev)
    fits = []
    for where in (dev, torch.device("cpu")):
        params = {k: v.detach().clone().to(where).requires_grad_() for k, v in start.items()}
        opt = optimizers.Adam(list(params.values()), 0.1)
        xw, yw = x.to(where), y.to(where)
        for _ in range(100):
            opt.zero_grad()
            realgraph.loss_fn(params, xw, yw).backward()
            opt.step()
        with torch.no_grad():
            fits.append((params, float(realgraph.loss_fn(params, xw, yw)),
                         float(metrics.auc(realgraph.predict_edge_scores(params, xw).cpu(), yw.cpu()))))
    (params, loss, auc), (_, cpu_loss, _) = fits
    require(abs(loss - cpu_loss) <= 1e-3 * abs(cpu_loss) and auc > 0.95,
            f"RealGraph fit: loss {loss} on the card, {cpu_loss} on the CPU; AUC {auc:.4f}")
    users = torch.from_numpy(rng.integers(0, RG_USERS, RG_BATCH).astype(np.int32))
    runs = []
    for where in (dev, torch.device("cpu")):
        tw = realgraph.EdgeTable(*(t.to(where) for t in table))
        p = {k: v.detach().to(where) for k, v in params.items()}
        gather.row_gather.launches = 0
        ids, scores = realgraph.top_edges(tw, p, users.to(where), now, RG_DEGREE // 2)
        if where.type == "cuda":
            torch.cuda.synchronize()
            made = _build.launches(gather.row_gather)
            require(made == 1, f"top_edges made {made} row_gather launches")
        runs.append((ids.cpu().numpy(), scores.cpu().numpy()))
    moved = check_same_ranking(*runs[0], *runs[1], 1e-5, 1e-6, "RealGraph top_edges card vs CPU")
    print(f"embedding_training: RealGraph ({RG_EVENTS} events folded into [{RG_USERS}, {RG_DEGREE}] edges on the host "
          f"in {fold_s:.1f} s): 100 adam(0.1) steps of loss_fn on {x.shape[0]} edges, loss {loss:.6f} on the card, "
          f"{cpu_loss:.6f} on the CPU, AUC {auc:.4f}; top_edges (k={RG_DEGREE // 2}) for {RG_BATCH} users in 1 "
          f"row_gather launch equal to the CPU's ({moved} ranks hold another id, within near-ties; rtol 1e-5, atol 1e-6)")


def wals_card_against_cpu(dev):
    """A WALS fit on seeded implicit ratings on the card and on the CPU from
    the same start, then a consumer's solve and similar_items."""
    s = WALS_SHAPE
    rng = np.random.default_rng(43)
    r = ((rng.random((s["users"], s["items"])) < 0.02) * rng.uniform(0.5, 2.0, (s["users"], s["items"])))
    r = torch.from_numpy(r.astype(np.float32))
    init = torch.from_numpy((rng.normal(size=(s["items"], s["dim"])) * 0.1).astype(np.float32))
    cfg = wals.WalsConfig(dim=s["dim"], iterations=s["iterations"])
    hist = torch.from_numpy(np.flatnonzero(r[7].numpy())[: s["history"]].astype(np.int32))
    runs = []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        m = wals.train_wals(r.to(where), cfg, item_init=init.to(where))
        if where.type == "cuda":
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        gather.row_gather.launches = 0
        vec = wals.consumer_embedding(m.item_factors, hist.to(where), torch.ones(len(hist), device=where), cfg.reg,
                                      cfg.alpha, wals.item_gram(m.item_factors))
        ids, scores = wals.similar_items(vec, m.item_factors, EMB_K, exclude=hist.to(where))
        if where.type == "cuda":
            torch.cuda.synchronize()
            require(_build.launches(gather.row_gather) == 1, "consumer_embedding made no row_gather launch")
        runs.append((m, vec.cpu(), ids.cpu().numpy()[None], scores.cpu().numpy()[None], fit_s))
    (m_card, v_card, ids, scores, card_s), (m_cpu, v_cpu, want_ids, want_scores, cpu_s) = runs
    f_err = max(float(((a.cpu() - b).abs() / (b.abs() + 1e-3)).max()) for a, b in zip(m_card, m_cpu))
    require(all(torch.allclose(a.cpu(), b, rtol=1e-3, atol=1e-4) for a, b in zip(m_card, m_cpu)),
            f"WALS factors card vs CPU beyond rtol 1e-3, atol 1e-4 ({f_err:.3g})")
    require(torch.allclose(v_card, v_cpu, rtol=1e-3, atol=1e-4), "WALS consumer vector card vs CPU")
    moved = check_same_ranking(ids, scores, want_ids, want_scores, 1e-3, 1e-4, "WALS similar_items card vs CPU")
    print(f"embedding_training: WALS ({s['users']} users x {s['items']} items, d={s['dim']}, {s['iterations']} "
          f"iterations) card {card_s:.2f} s, CPU {cpu_s:.2f} s (host clock); factors within rtol 1e-3, atol 1e-4; a "
          f"consumer's solve from {len(hist)} engagements and its similar_items top-{EMB_K} equal to the CPU's "
          f"({moved} ranks hold another id, within near-ties)")


def serve_trained(dev, tt, th, planted, sann=None):
    """The trained tables served through tweet-mixer's Home dense engines:
    a served user's planted items in the dense pipelines' top-200."""
    t0 = time.perf_counter()
    tw = tweet_mixer_world.build(TM_SHAPE, device=dev, sann=sann).with_models(th, tt)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q = tw.queries[0]
    u = int(q.user_id)
    want = {"two_tower_consumer": int(planted.two_tower[u]), "deep_retrieval_user_tweet": int(planted.two_tower[u]),
            "twhin_consumer_based": int(planted.twhin[tweet_mixer_world.TWHIN_RELATION, u])}
    catalog = cat.build_catalog(tw.source_world())
    lists = home_lists(catalog, q)
    ranks = {}
    for name, item in want.items():
        got = [c.id for c in lists[name]]
        require(len(got) == EMB_SERVED_K, f"{name} served {len(got)} candidates, not {EMB_SERVED_K}")
        require(item in got, f"user {u}: {name}'s top-{EMB_SERVED_K} over the trained tables misses planted item {item}")
        ranks[name] = got.index(item)
    home = tmp.run_product(catalog, HOME, q)
    in_home = {name: want[name] in {c.id for c in home} for name in want}
    print(f"embedding_training: the trained tables served through Home's dense engines (world built in {build_s:.1f} "
          f"s, set-up): user {u}'s planted items at ranks {ranks} of the pipelines' top-{EMB_SERVED_K}; in the "
          f"blended {len(home)}: {in_home}")


# the tweet-mixer Home shapes whose run_collapse rows had no copy_ yardstick
# (phase_tweet_mixer_times leaves it out: after that phase's launches the
# profiler drops copy events of short sessions): [Q, W] and k, timed here in a
# fresh process on entries of the same shapes and types
HOME_COLLAPSE_SHAPES = [(1, 20_000, 2, "a Home SANN query's sorted entries"),
                        (1, 512, 2, "Home's UTEG family, 16 seeds"), (1, 1536, 2, "Home's UTEG family, 48 seeds"),
                        (1, 2048, 2, "Home's UTEG family, 64 seeds"), (1, 4096, 1, "Home's UTG dedup")]


def home_copy_yardsticks(dev):
    """The device time of ``copy_`` moving the bytes of each Home collapse
    shape (each slot's id and k values, read and written once)."""
    out = []
    for Q, W, k, label in HOME_COLLAPSE_SHAPES:
        entries = [torch.zeros((Q, W), dtype=torch.int32, device=dev)] + [torch.ones((Q, W), device=dev)] * k
        copies = [torch.empty_like(t) for t in entries]
        ms = device_ms(lambda: [c.copy_(t) for c, t in zip(copies, entries)], COPY_REPS)
        out.append(f"{label} [{Q}, {W}] k={k} {ms:.4f} ms")
    print("kernel run_collapse: copy_ of the same bytes at tweet-mixer's Home shapes (device time): " + "; ".join(out))


def phase_embedding_training(dev, root=None):
    """Embedding-table training through the D-wide collapse at full width,
    its kernel at this path's shapes, the card against the CPU, RealGraph
    and WALS, and the trained tables served back through Home. Returns the
    counted steps' launches and the kernel's numbers at the two-tower item
    table's shape."""
    home_copy_yardsticks(dev)
    embedding_card_against_cpu(dev)
    planted = tweet_mixer_world.planted_engagements(TM_SHAPE)
    users = np.random.default_rng(5).permutation(TM_SHAPE.num_users)[:EMB_EVAL_USERS]
    tt, th = embedding_models(dev)
    tt_launches, tt_inputs, tt = train_full_width(
        dev, "two_tower", tt, tweet_mixer_world.two_tower_train_loss, tweet_mixer_world.two_tower_batches(planted, EMB_B),
        lambda m: round(tweet_mixer_world.two_tower_hits(m, planted, users, EMB_K), 4))
    th_launches, th_inputs, th = train_full_width(
        dev, "twhin", th, tweet_mixer_world.twhin_train_loss, tweet_mixer_world.twhin_batches(planted, EMB_B),
        lambda m: [round(h, 4) for h in tweet_mixer_world.twhin_hits(m, planted, users, EMB_K)])
    launches = {k: tt_launches[k] + th_launches[k] for k in tt_launches}
    # the kernel at each of this path's shapes: a table by its rows
    tables = {TM_SHAPE.num_users: "user table", TM_SHAPE.num_items: "item table", len(twhin.RELATIONS): "relation table"}
    timings = {}
    for model, inputs in (("two-tower", tt_inputs), ("TwHIN", th_inputs)):
        for ids, perm, dy, n in inputs:
            label = f"{model} {tables[n]} ([{n}, {dy.shape[1]}])"
            timings[label] = time_collapse_rows(ids, perm, dy, n, label)
    require(len(timings) == 5, f"the collapse's shapes: {list(timings)}, want 5 tables")
    del tt_inputs, th_inputs
    realgraph_card_against_cpu(dev)
    wals_card_against_cpu(dev)
    torch.cuda.empty_cache()
    serve_trained(dev, tt, th, planted, saved_sann(root, dev))
    return {"launches": launches, "run_collapse_rows": timings[f"two-tower item table ([{TM_SHAPE.num_items}, "
                                                               f"{TM_SHAPE.embed_dim}])"]}


# -- the mesh layer (PR 11) ------------------------------------------------------
#
# At world size 1 on the card: one NCCL rank, a 1x1 (data, model) mesh, and the
# sharded paths' entry points: bench.py's lookup (bench.py:331-393) through the
# all-to-all multiget, the three sharded SANN forms, the sharded serve engine,
# earlybird's partitioned scan and GFS's worker fan-out. Then the E=4 routing on
# this one card: four gloo ranks in processes of their own (NCCL refuses two
# ranks on one device), correctness only.
LOOKUP_ROWS, LOOKUP_DIM = 16_000_000, 128  # bench.py's 8.19 GB f32 table
LOOKUP_B, LOOKUP_ITERS = 65_536, 16  # ids an iteration, iterations a run (bench.py's)
LOOKUP_REPS = 5  # timed runs of the 16 iterations
LOOKUP_SUM_RTOL = 1e-6  # the 16-iteration f32 sum against the bare gather's: the same rows, summed alike
MESH_RTOL = 1e-6  # sharded SANN scores against the batch path (the same sums at world 1)
MESH_SANN_LAUNCHES = {  # one Q=256 batch at world 1: the local accumulate (a fetch and a dedup), the merge's dedup
    "hybrid": {"run_collapse": 2, "row_gather": 1},
    "query_sharded": {"run_collapse": 1, "row_gather": 1},  # the multiget's local gather, the accumulate's dedup
    "sharded": {"run_collapse": 2, "row_gather": 1},
}
MESH_SERIAL = 3  # R=32 batches of the sharded serve on the host clock
GFS_RTOL = 1e-6
E4_LOOKUP = (1_000_000, 128, 65_536)  # the E=4 multiget: table rows, width, ids
E4_TIMEOUT = 300
MESH_TIMEOUT = 420  # the mesh child's limit, inside the script's


def counted(fn):
    """``fn()`` with every kernel's count set to 0 just before and read just
    after: (its result, the launches it made)."""
    seg_scan.run_collapse_sorted.launches = gather.row_gather.launches = seg_scan.run_collapse_rows.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"run_collapse": _build.launches(seg_scan.run_collapse_sorted),
                 "row_gather": _build.launches(gather.row_gather),
                 "run_collapse_rows": _build.launches(seg_scan.run_collapse_rows)}


def launch_times_us(fn):
    """Device time (µs) of each kernel launch in one profiler session of
    ``fn``, in launch order (copies and fills left out)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    PROFILER["sessions"] += 1
    return [e.device_time_total for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset"))]


def mesh_lookup(mesh, dev):
    """bench.py's bench_lookup at full size through ``multiget_all_to_all``:
    at world size 1 the exchange is the identity, and each iteration is one
    row_gather launch of 65,536 rows of 512 B from the 8.19 GB table."""
    from the_algorithm_tpu_torch.parallel import sharded_table

    t0 = time.perf_counter()
    table = torch.randn((LOOKUP_ROWS, LOOKUP_DIM), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    ids_all = torch.from_numpy(np.random.default_rng(1).integers(0, LOOKUP_ROWS, (LOOKUP_ITERS, LOOKUP_B),
                                                                   dtype=np.int64).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    print(f"mesh lookup: [{LOOKUP_ROWS}, {LOOKUP_DIM}] f32 table ({table.numel() * 4 / 1e9:.2f} GB) from a seeded "
          f"generator on the card, {LOOKUP_ITERS} x {LOOKUP_B} ids (bench.py's draw) in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")
    sharded = sharded_table.ShardedTable(table, LOOKUP_ROWS)  # the 1x1 mesh's one block: the table itself

    def run():
        acc = torch.zeros((), device=dev)
        for i in range(LOOKUP_ITERS):
            acc += sharded_table.multiget_all_to_all(mesh, sharded, ids_all[i]).sum(dtype=torch.float32)
        return acc

    def run_bare():
        acc = torch.zeros((), device=dev)
        for i in range(LOOKUP_ITERS):
            acc += torch.index_select(table, 0, ids_all[i]).sum(dtype=torch.float32)
        return acc

    acc, launches = counted(run)
    bare = float(run_bare())
    require(launches == {"run_collapse": 0, "row_gather": LOOKUP_ITERS, "run_collapse_rows": 0},
            f"lookup launches {launches}, want one row_gather an iteration")
    require(abs(float(acc) - bare) <= LOOKUP_SUM_RTOL * abs(bare), f"lookup sum {float(acc)} against {bare}")
    one = sharded_table.multiget_all_to_all(mesh, sharded, ids_all[0])
    require(torch.equal(one.view(torch.int32), torch.index_select(table, 0, ids_all[0]).view(torch.int32)),
            "an iteration's rows differ from index_select")
    dt, dt_bare = timed_pair(run, run_bare, reps=LOOKUP_REPS)  # ms a run of 16 iterations, CUDA events
    rows_per_s = LOOKUP_ITERS * LOOKUP_B / (dt / 1e3)
    moved = LOOKUP_ITERS * LOOKUP_B * LOOKUP_DIM * 4 * 2  # bench.py's count: row read + output write
    print(f"mesh lookup: 16-iteration sum {float(acc):.6g} within rtol {LOOKUP_SUM_RTOL} of the bare gather's "
          f"{bare:.6g}; an iteration's rows bit-equal to index_select; launches a run {launches}")
    print(f"mesh lookup: {rows_per_s:.4g} rows/s, {moved / (dt / 1e3) / 1e9:.1f} GB/s ({moved / 1e9:.2f} GB a run "
          f"in {dt:.3f} ms, CUDA events); bare index_select {dt_bare:.3f} ms: lookup_vs_bare_gather "
          f"{dt_bare / dt:.3f}")
    # each iteration's gather alone: 16 row_gather launches, then 16 index_selects
    k_us = launch_times_us(lambda: [gather.row_gather(ids_all[i], table) for i in range(LOOKUP_ITERS)])
    b_us = launch_times_us(lambda: [torch.index_select(table, 0, ids_all[i]) for i in range(LOOKUP_ITERS)])
    bound = bound_ms(LOOKUP_B * LOOKUP_DIM * 4 * 2)
    print(f"mesh lookup: each iteration's row_gather device time (µs) {[round(x, 1) for x in k_us]}; index_select "
          f"{[round(x, 1) for x in b_us]}; bound (65,536 x 512 B read + written) {bound * 1e3:.1f} µs: the kernel at "
          f"{100 * bound * 1e3 / np.mean(k_us):.0f}% of it on the mean (random 512-B reads from an 8 GB table are "
          f"transaction-bound)" if k_us else "mesh lookup: the profiler saw no kernel launch")
    timing = time_gather(ids_all[0], (table,), f"mesh lookup: {LOOKUP_B} of {LOOKUP_ROWS} x 512 B rows (bench.py's)")
    del table, sharded, one
    torch.cuda.empty_cache()
    return launches, timing


def same_lists(got, want, what):
    """Two [Q, X] result lists (tensors) the same up to near-ties."""
    return check_same_ranking(got[0].cpu().numpy(), got[1].cpu().numpy(), want[0].cpu().numpy(),
                              want[1].cpu().numpy(), MESH_RTOL, 0.0, what)


def mesh_sann(mesh, world):
    """The three sharded SANN forms and the cluster-row multiget at world
    size 1, against the batch path; returns their launches and results."""
    shape, _, _, index_np, q_ids, q_scores, index, sources = world
    cfg = ann.SimClustersANNConfig(max_scan_clusters=shape.N, max_top_tweets_per_cluster=shape.M,
                                   max_num_results=shape.X, scoring_algorithm=ScoringAlgorithm.COSINE)
    want = ann.get_tweet_candidates_batch(index, sources, cfg)
    local = ann.shard_index(mesh, index)
    forms = {"hybrid": lambda: ann.get_tweet_candidates_hybrid(mesh, local, sources, cfg),
             "query_sharded": lambda: ann.get_tweet_candidates_query_sharded(mesh, local, sources, cfg),
             "sharded": lambda: ann.get_tweet_candidates_sharded(mesh, local, sources, cfg)}
    launches, results = {}, {}
    for name, fn in forms.items():
        got, n = counted(fn)
        n = {k: v for k, v in n.items() if k != "run_collapse_rows"}
        require(n == MESH_SANN_LAUNCHES[name], f"SANN {name} launches {n}, want {MESH_SANN_LAUNCHES[name]}")
        moved = same_lists(got, want, f"SANN {name} against the batch path")
        got_np = got[0].cpu().numpy()
        hits = total = 0
        for q in range(8):
            ref = {t for t, _ in retrieval.approximate_cosine_similarity_reference(
                *index_np, q_ids[q], q_scores[q], max_results=K_RECALL, algorithm=ScoringAlgorithm.COSINE)}
            hits += len(ref & set(got_np[q, :K_RECALL].tolist()))
            total += len(ref)
        require(hits >= 0.99 * total, f"SANN {name} oracle parity {hits / total} < 0.99")
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        results[name] = got
        print(f"mesh sann: {name} Q={shape.Q} on the 1x1 mesh: the batch path's lists ({moved} ranks hold another "
              f"id, within near-ties; scores rtol {MESH_RTOL}), oracle parity {hits / total:.4f} on 8 queries, "
              f"launches {n}")
    # the merge's dedup at its shape: at world 1 the gathered partials are the local accumulate's
    head = SparseEmbedding(sources.ids[:, :shape.N], sources.scores[:, :shape.N])
    partials = ann._owned_partials(mesh, local, head, cfg, None, None)
    time_collapse(retrieval.sort_by_id(*partials), f"the sharded SANN merge's dedup (Q={shape.Q}, world 1)")
    del partials
    src = sparse.truncate(sources, shape.N)
    cids = torch.where(src.valid_mask(), src.ids, 0).reshape(-1)  # the batch's Q·N cluster ids
    rows, n = counted(lambda: ann.fetch_cluster_rows(mesh, local, cids))
    require(all(torch.equal(r.view(torch.int32), torch.index_select(t, 0, cids).view(torch.int32))
                for r, t in zip(rows, index)), "fetch_cluster_rows differs from index_select")
    require(n["row_gather"] == 1 and n["run_collapse"] == 0, f"fetch_cluster_rows launches {n}")
    launches["row_gather"] += n["row_gather"]
    print(f"mesh sann: fetch_cluster_rows of {cids.numel()} ids: bit-equal to index_select, launches {n}")
    qps = {}
    for name in ("sharded", "hybrid"):
        forms[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            forms[name]()
        torch.cuda.synchronize()
        qps[name] = shape.Q * 20 / (time.perf_counter() - t0)
    print(f"mesh sann: sharded_queries_per_s {qps['sharded']:.1f} (bench.py's key: the index-sharded form), hybrid "
          f"{qps['hybrid']:.1f} queries/s at Q={shape.Q} (host clock, 20 batches; not a benchmark)")
    return launches, {k: tuple(x.cpu().numpy() for x in v) for k, v in results.items()}, tuple(
        x.cpu().numpy() for x in want)


def mesh_serve(mesh, dev, sann, cand):
    """ShardedServeEngine on the 1x1 mesh at bench.py's For You width
    against DeviceHydrationScorer on the same card and tables: f32 scores
    (score_columnar, score_requests) and the bf16 device selection, on R=32
    requests with creation times below SPREAD_TS s; launches of one batch and
    requests/s on the host clock. Returns the launches and the tables."""
    from the_algorithm_tpu_torch.mixers import sharded_serve
    from the_algorithm_tpu_torch.pipeline.component import Candidate

    sann_ids, sann_scores = sann
    fy_world, index, graph = cand
    t0 = time.perf_counter()
    world = wh.synthetic_world(**FY_WORLD, device=dev)
    tables, fns, res = dh.build_from_world(world, world.pop("device_spec"))
    F = fs.total_width(fs.WIDE_SCHEMA)
    ref = masknet.MaskNet(masknet.MaskNetConfig(num_features=F, **FY_MODEL, dtype="float32"), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    m16 = masknet.MaskNet(masknet.MaskNetConfig(num_features=F, **FY_MODEL, dtype="bfloat16"), device=dev)
    m16.load_state_dict(ref.state_dict())
    weights = masknet.DEFAULT_HEAD_WEIGHTS
    half = sann_ids.shape[0] // 2
    s = fy_world.shape
    sources = [bf.PrecomputedBatchSource(sann_ids[:half], sann_scores[:half]),
               bf.EarlybirdBatchSource(index, foryou_world.NOW, max_results=EB_RESULTS),
               bf.UtegBatchSource(graph, lambda u: fy_world.seeds[u % s.num_users], max_results=UTEG_RESULTS),
               bf.PrecomputedBatchSource(sann_ids[half:], sann_scores[half:], name="TweetMixer")]
    follows = [[int(a) for a in row if a != PAD_ID] for row in fy_world.follows]
    queries = [ForYouQuery(user_id=u, followed_authors=follows[u % len(follows)], max_results=FY_TOP_K,
                           now=foryou_world.NOW) for u in range(FY_R)]

    def single(model, dtype, k):
        return dh.DeviceHydrationScorer(tables, fns, res, model, weights, pad_b=FY_PB, compute_dtype=dtype,
                                        select_top_k=k)

    lift = spread_lift(bf.ColumnsLift(FY_WORLD["num_authors"], foryou_world.NOW))
    engine = bf.BatchedForYouEngine(batch_sources=sources, scorer=single(ref, torch.float32, None),
                                    head_names=masknet.DEFAULT_HEAD_NAMES, lift=lift, max_age_s=10 ** 9)
    _, cols = engine.columns(queries)
    eng32 = sharded_serve.ShardedServeEngine(tables, fns, res, ref, weights, mesh, pad_b=FY_PB,
                                             compute_dtype=torch.float32)
    eng16 = sharded_serve.ShardedServeEngine(tables, fns, res, m16, weights, mesh, pad_b=FY_PB,
                                             compute_dtype=torch.bfloat16, select_top_k=FY_TOP_K)
    torch.cuda.synchronize()
    print(f"mesh serve: For You hydration world (users {FY_WORLD['num_users']}, {F} columns) and two 1x1-mesh "
          f"engines ({len(eng32._packs)} packed routes + the aggregate pack) built in {time.perf_counter() - t0:.1f} s "
          f"(set-up); R={FY_R} requests of {sum(n for _, _, n in cols)} candidates, creation times below {SPREAD_TS} s")

    got, n32 = counted(lambda: eng32.score_columnar(cols))
    want = single(ref, torch.float32, None).score_columnar(cols)
    err = 0.0
    for (gp, gc), (wp, wc) in zip(got, want):
        np.testing.assert_allclose(gp, wp, rtol=FY_RTOL, atol=FY_ATOL)
        np.testing.assert_allclose(gc, wc, rtol=FY_RTOL, atol=0)
        err = max(err, float(np.max(np.abs(gc - wc) / np.abs(wc))))
    # a launch for each route's 16-byte-row tables and one for its others (gather.multiget)
    packs = [*eng32._packs.values(), {"av": eng32._agg.values, "al": eng32._agg.last_ts}]
    routes = sum(len(gather.launch_groups({k: v.reshape(v.shape[0], -1) for k, v in p.items()})) for p in packs)
    require(n32 == {"run_collapse": 0, "row_gather": routes, "run_collapse_rows": 0},
            f"sharded serve launches {n32}, want {routes}: the packed routes' gathers")
    names = fs.candidate_source_names()
    batch = []
    for q, c, n in cols:
        feats = [k for k in c if k not in ("ids", "source_idx", "source_hash")]
        batch.append((q, [Candidate(id=int(c["ids"][i]), source=names[int(c["source_idx"][i])]
                                    if "source_idx" in c and c["source_idx"][i] >= 0 else None,
                                    features={k: c[k][i].item() for k in feats}) for i in range(n)]))
    got_r = eng32.score_requests(batch)
    want_r = single(ref, torch.float32, None).score_requests(batch)
    for (gp, gc), (wp, wc) in zip(got_r, want_r):
        np.testing.assert_allclose(gp, wp, rtol=FY_RTOL, atol=FY_ATOL)
        np.testing.assert_allclose(gc, wc, rtol=FY_RTOL, atol=0)
    sel, n16 = counted(lambda: eng16.select_columnar(cols))
    want_sel = single(m16, torch.bfloat16, FY_TOP_K).select_columnar(cols)

    def as_arrays(out):
        ids, scores = np.full((FY_R, FY_TOP_K), PAD_ID, np.int64), np.zeros((FY_R, FY_TOP_K))
        for r, (i, sc, _) in enumerate(out):
            ids[r, :len(i)], scores[r, :len(i)] = i, sc
        return ids, scores

    moved = check_same_ranking(*as_arrays(sel), *as_arrays(want_sel), SELECT_RTOL, 0.0,
                               "the sharded engine's device selection")
    print(f"mesh serve: score_columnar and score_requests (f32) against DeviceHydrationScorer on the card: every "
          f"candidate's score within rel {err:.3g} (rtol {FY_RTOL}); bf16 select_columnar top-{FY_TOP_K}: the "
          f"scorer's selection ({moved} ranks hold another id, within near-ties); launches a batch {n32} (f32), "
          f"{n16} (bf16 select)")
    rps = {}
    for name, fn in (("sharded engine", lambda: eng16.select_columnar(cols)),
                     ("DeviceHydrationScorer", lambda: single(m16, torch.bfloat16, FY_TOP_K).select_columnar(cols))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_SERIAL):
            fn()
        torch.cuda.synchronize()
        rps[name] = FY_R * MESH_SERIAL / (time.perf_counter() - t0)
    print("mesh serve: bf16 select_columnar at R=32, requests/s (host clock; not a benchmark): "
          + ", ".join(f"{k} {v:.1f}" for k, v in rps.items()))
    # each packed route's owner gather at its shape against index_select
    calls, routed = [], sharded_serve.route_and_gather

    def recording(group, ids, **kw):
        calls.append((group, ids))
        return routed(group, ids, **kw)

    sharded_serve.route_and_gather = recording
    try:
        eng32.score_columnar(cols)
    finally:
        sharded_serve.route_and_gather = routed
    route_of = {id(p): r for r, p in eng32._packs.items()}
    for group, ids in calls:
        flat = {k: t.reshape(t.shape[0], -1) for k, t in group.items()}
        for names in gather.launch_groups(flat):
            tabs = tuple(flat[k] for k in names)
            label = (f"sharded serve route {route_of.get(id(group), 'of the aggregate pack')} ({', '.join(names)}): "
                     f"{ids.numel()} rows x {'+'.join(str(t.shape[1] * t.element_size()) for t in tabs)} B of "
                     f"[{tabs[0].shape[0]}] rows")
            time_gather(ids.clamp(0, tabs[0].shape[0] - 1).contiguous(), tabs, label)
    del eng32, eng16, engine, ref, m16
    torch.cuda.empty_cache()
    return n16, tables, cols


def mesh_search(mesh, cand, tables, cols):
    """earlybird's search_sharded on the candidate world's 262,144-doc index
    (relevance and recency) against ``search``, and GFS's worker fan-out
    over ``shard_tables(..., 1)`` against ``feature_block``."""
    from the_algorithm_tpu_torch.features import graph_features as gf

    _, index, _ = cand
    query = foryou_world.in_network_query().to(index.tokens.device)
    local = earlybird.shard_index(mesh, index)
    for rank_by in ("relevance", "recency"):
        want = earlybird.search(index, query, max_results=EB_RESULTS, rank_by=rank_by)
        got = earlybird.search_sharded(mesh, local, query, max_results=EB_RESULTS, rank_by=rank_by)
        require(torch.equal(got[0], want[0]) and torch.allclose(got[1], want[1], rtol=MESH_RTOL, atol=0),
                f"search_sharded ({rank_by}) differs from search")
        require(int((want[0] != PAD_ID).sum()) > 0, f"search ({rank_by}) found nothing")
    print(f"mesh search: search_sharded on the {index.capacity}-doc index, relevance and recency, top {EB_RESULTS}: "
          f"search's ids, scores within rtol {MESH_RTOL}")
    graph = gf.GraphTables(tables.gfs_neighbors)
    t0 = time.perf_counter()
    sharded = gf.shard_tables(graph, 1)
    build_s = time.perf_counter() - t0
    cands = torch.from_numpy(np.asarray(cols[0][1]["author_id"][:cols[0][2]], np.int32)).to(index.tokens.device)
    for uid in (5, 1234):
        want = gf.feature_block(graph, uid, cands)
        got = gf.feature_block_sharded(mesh, meshlib.shard_rows(sharded, mesh), uid, cands)
        for k in want:
            exact = not k.endswith("_normalized")
            require(torch.equal(got[k], want[k]) if exact else torch.allclose(got[k], want[k], rtol=GFS_RTOL, atol=0),
                    f"feature_block_sharded {k} differs from feature_block")
    print(f"mesh search: GFS feature_block_sharded over shard_tables(..., 1) ({tuple(sharded.shape)}, built on the "
          f"host in {build_s:.1f} s) for {cands.numel()} candidate authors of 2 users: feature_block's counts exactly, "
          f"normalized within rtol {GFS_RTOL}")


def save_world(world, root):
    """The SANN world's corpus, index and queries as .npy files in ``root``,
    for the tweet-mixer, embedding-training and mesh children and the mesh
    child's E=4 ranks."""
    shape, corpus_ids, corpus_scores, index_np, q_ids, q_scores, _, _ = world
    for name, a in zip(("tweet_ids", "scores", "timestamps", "q_ids", "q_scores", "corpus_ids", "corpus_scores"),
                       (*index_np, q_ids, q_scores, corpus_ids, corpus_scores)):
        np.save(os.path.join(root, f"{name}.npy"), a)
    with open(os.path.join(root, "shape.json"), "w") as f:
        json.dump(dataclasses.asdict(shape), f)


def load_world(root, dev):
    """:func:`build_world`'s tuple from :func:`save_world`'s files (the
    corpus left out); ``dev`` None: the index as numpy memory maps only."""
    shape = sann_world.WorldShape(**json.load(open(os.path.join(root, "shape.json"))))
    # copy-on-write maps: torch takes only writable arrays
    index_np = tuple(np.load(os.path.join(root, f"{n}.npy"), mmap_mode="c")
                     for n in ("tweet_ids", "scores", "timestamps"))
    q_ids, q_scores = (np.load(os.path.join(root, f"{n}.npy")) for n in ("q_ids", "q_scores"))
    if dev is None:
        return shape, None, None, index_np, q_ids, q_scores, None, None
    index = ClusterTweetIndex(*(torch.from_numpy(np.asarray(a)).to(dev) for a in index_np))
    sources = SparseEmbedding(torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_scores).to(dev))
    return shape, None, None, index_np, q_ids, q_scores, index, sources


def saved_sann(root, dev):
    """The tweet-mixer world's SANN part from :func:`save_world`'s files
    (``tweet_mixer_world.build_sann`` at ``TM_SHAPE.sann``, which is
    bench.py's shape, without its numpy build); None without ``root``."""
    if root is None:
        return None
    shape, _, _, _, _, _, index, sources = load_world(root, dev)
    require(shape == TM_SHAPE.sann, f"the saved SANN world {shape} is not tweet-mixer's {TM_SHAPE.sann}")
    corpus = (np.load(os.path.join(root, f"{n}.npy")) for n in ("corpus_ids", "corpus_scores"))
    return tweet_mixer_world.SannParts(*corpus, index, sources)


def mesh_rank(rank: int, root: str) -> int:
    """One of the E=4 check's ranks (``chip_smoke.py --mesh-rank r dir``): a
    gloo rank on cuda:0, its blocks of the SANN index, the hybrid form on a
    2x2 mesh and the index-sharded form on a 1x4 mesh, and a multiget of
    65,536 ids from a 1,000,000 x 128 table split 4 ways; its results into
    ``root``. If gloo refuses CUDA tensors, it says so there instead."""
    import torch.distributed as dist

    from the_algorithm_tpu_torch.parallel import sharded_table

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    _build.lib()
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'store4')}", rank=rank, world_size=4)
    out = os.path.join(root, f"rank{rank}.npz")
    try:
        try:  # gloo and CUDA tensors: the two collectives the mesh layer's exchange and gathers take
            dist.all_to_all_single(torch.empty(4, device=dev), torch.arange(4.0, device=dev))
            meshlib._all_gather_into(torch.empty(8, device=dev), torch.arange(2.0, device=dev))
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — the reason is the result
            np.savez(out, unsupported=np.asarray(f"{type(e).__name__}: {e}"))
            return 0
        m22 = meshlib.make_mesh(meshlib.MeshSpec(data=2, model=2))
        m14 = meshlib.make_mesh(meshlib.MeshSpec(data=1, model=4))
        shape, _, _, index_np, q_ids, q_scores, _, _ = load_world(root, None)
        cfg = ann.SimClustersANNConfig(max_scan_clusters=shape.N, max_top_tweets_per_cluster=shape.M,
                                       max_num_results=shape.X, scoring_algorithm=ScoringAlgorithm.COSINE)
        res = {}
        for name, m in (("hybrid", m22), ("sharded", m14)):
            local = ClusterTweetIndex(*(meshlib.shard_rows(a, m, pad=False) for a in index_np))
            over = (meshlib.DATA_AXIS,) if name == "hybrid" else ()
            src = SparseEmbedding(*(meshlib.shard_rows(a, m, over=over, pad=False) for a in (q_ids, q_scores)))
            fn = ann.get_tweet_candidates_hybrid if name == "hybrid" else ann.get_tweet_candidates_sharded
            ids, scores = fn(m, local, src, cfg)
            res[f"{name}_ids"], res[f"{name}_scores"] = ids.cpu().numpy(), scores.cpu().numpy()
            res[f"{name}_block"] = np.asarray(m.coord(meshlib.DATA_AXIS) if over else 0)
            del local
        rows, width, B = E4_LOOKUP
        table = torch.randn((rows, width), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
        ids = torch.from_numpy(np.random.default_rng(3).integers(0, rows, B).astype(np.int32))
        block = meshlib.shard_rows(ids, m14, pad=False).to(dev)
        t = sharded_table.ShardedTable(meshlib.shard_rows(table, m14), rows)
        got, n = counted(lambda: sharded_table.multiget_all_to_all(m14, t, block))
        res["multiget_equal"] = np.asarray(torch.equal(got.view(torch.int32),
                                                       torch.index_select(table, 0, block).view(torch.int32)))
        res["multiget_row_gather"] = np.asarray(n["row_gather"])
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_four_ranks(root, results):
    """The E=4 routing on this one card: four gloo ranks (each its own
    process on cuda:0) against the world-1 results. Correctness only: the
    exchange crosses the host, so no time of it is a rate."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r), root])
             for r in range(4)]
    try:
        codes = [p.wait(timeout=E4_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(codes == [0, 0, 0, 0], f"an E=4 rank failed: exit codes {codes}")
    outs = [np.load(os.path.join(root, f"rank{r}.npz")) for r in range(4)]
    if "unsupported" in outs[0].files:
        print(f"mesh E=4: dropped: gloo refuses CUDA tensors on this torch ({outs[0]['unsupported']}); E>1 routing "
              "is held on the CPU by the tests/test_torch_sharded_*.py and test_torch_ann_sharded.py files")
        return False
    moved = 0
    for r, o in enumerate(outs):
        for name in ("hybrid", "sharded"):
            want_ids, want_scores = results[name]
            if name == "hybrid":
                half = want_ids.shape[0] // 2
                b = int(o["hybrid_block"])
                want_ids, want_scores = want_ids[b * half:(b + 1) * half], want_scores[b * half:(b + 1) * half]
            moved += check_same_ranking(o[f"{name}_ids"], o[f"{name}_scores"], want_ids, want_scores, MESH_RTOL,
                                        0.0, f"E=4 rank {r} {name}")
        require(bool(o["multiget_equal"]) and int(o["multiget_row_gather"]) == 1,
                f"E=4 rank {r}: multiget rows differ from index_select or not one row_gather launch")
    print(f"mesh E=4: four gloo ranks on the one card: the hybrid form on a 2x2 mesh (half the index a rank) and "
          f"the index-sharded form on a 1x4 mesh (a quarter) give every rank the world-1 lists ({moved} ranks hold "
          f"another id, within near-ties; scores rtol {MESH_RTOL}); a multiget of {E4_LOOKUP[2]} ids from a "
          f"{E4_LOOKUP[0]} x {E4_LOOKUP[1]} table split 4 ways bit-equal to index_select, one row_gather launch a "
          f"rank; {time.perf_counter() - t0:.1f} s (correctness only)")
    return True


def phase_mesh(dev, root=None):
    """The mesh layer's serving half at world size 1 (NCCL), then the E=4
    routing over gloo on this one card. ``root``: a directory holding the
    SANN world (:func:`save_world`); without it the world is built here.
    Returns the path's launches."""
    import torch.distributed as dist

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        if root is None:
            world = build_world(dev)
            save_world(world, tmp)
            root = tmp
        else:
            world = load_world(root, dev)
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store1')}", rank=0, world_size=1)
        try:
            mesh = meshlib.make_mesh(meshlib.MeshSpec(data=1, model=1))
            print(f"mesh: one NCCL rank, a 1x1 (data, model) mesh on {mesh.device}")
            lookup, timing = mesh_lookup(mesh, dev)
            sann, results, (want_ids, want_scores) = mesh_sann(mesh, world)
            s = foryou_world.FULL
            fy = foryou_world.build(s, users=CAND_R)
            cand = (fy, foryou_world.earlybird_index(fy, dev), foryou_world.engagement_graph(fy, dev))
            serve, tables, cols = mesh_serve(mesh, dev, (want_ids, want_scores), cand)
            mesh_search(mesh, cand, tables, cols)
            del tables, cand
        finally:
            dist.destroy_process_group()
        del world
        torch.cuda.empty_cache()
        e4 = mesh_four_ranks(root, results)
    launches = {k: lookup.get(k, 0) + sann.get(k, 0) + serve.get(k, 0) for k in ("run_collapse", "row_gather",
                                                                              "run_collapse_rows")}
    require(launches["run_collapse"] > 0 and launches["row_gather"] > 0, f"mesh path launches {launches}")
    print(f"mesh: launches of the path {launches} (the lookup's run {lookup}, the SANN forms and fetch {sann}, one "
          f"sharded serve batch {serve}); E=4 check {'run' if e4 else 'dropped'}")
    return {"launches": launches, "row_gather": timing}


# -- the mesh layer's training half ---------------------------------------------
#
# At world size 1 on the card (one NCCL rank, a 1x1 mesh): two-tower and TwHIN
# with explicit_lookup at tweet-mixer's widths (16,384 users x 2,000,000 items x
# 128) through the sharded Trainer, held to the one-device Trainer from the same
# init and batches, then trained to hits@100; bench.py's MaskNet step through
# the sharded Trainer with masknet.PARTITION_RULES, held to the one-device step.
# Then E=4 on this one card: four gloo ranks (correctness only).
MT_STEPS = 3  # steps the sharded Trainer is held to the one-device Trainer (and the E=4 ranks to world 1)
MT_SAVED = 2  # the E=4 two-tower's checkpoint: after this many steps on 2x2, restored on other meshes
MT_E4 = dict(users=16_384, items=262_144, dim=128, batch=1_024)  # the E=4 two-tower
MT_E4_MASKNET = dict(TRAIN_MODEL, dtype="float32")  # the E=4 MaskNet on 1x4, f32
MT_E4_LR = 1e-2
MT_E4_TIMEOUT = 300
MT_TIMEOUT = 420  # the mesh-training child's limit, inside the script's
MT_LOSS_RTOL = 1e-5  # the local-batch contract: the reported loss against the global batch's at world 1
# The E=4 MaskNet (F=6,000 f32, B=1,024, random labels) takes its first step
# within the Adam rule of world 1's, but its later steps amplify any change
# of summation order: on one CPU, 1 against 8 threads put 12% of the entries
# beyond 1e-5 after step 2 and 35% after step 3 (every entry within 2·steps·lr).
# Its first gradients agree to ~5e-7 of each parameter's largest entry when
# both sides sum alike (one CPU thread a rank), but a ReLU gate whose input
# sits within rounding of 0 may flip between two summation orders and move a
# column of mask_agg's gradient by one example's share (1.6% of the largest
# entry with 8 threads). So its gradients are held by cosine, as the bf16
# gradient checks of tests/test_torch_training.py are, its first step to the
# Adam rule and its third to the rule's bound alone.
MT_GRAD_COS = 1 - 1e-4  # a wrong block or sum sends a cosine far below; one flipped gate ~1e-5


def adam_rule(got, want, steps, lr, what):
    """The Adam rule of the card checks: no parameter entry of ``got`` off
    ``want``'s by more than 2·steps·lr, at most PARAM_OUTLIERS of them by
    more than PARAM_ATOL. Returns (max |diff|, share beyond, bit-equal)."""
    diffs = torch.cat([(got[k].float() - want[k].float()).abs().reshape(-1) for k in want])
    max_diff, share = float(diffs.max()), float((diffs > PARAM_ATOL).double().mean())
    require(max_diff <= 2 * steps * lr and share <= PARAM_OUTLIERS,
            f"{what}: max |diff| {max_diff:.3g} (limit {2 * steps * lr:g}), {share:.3g} beyond {PARAM_ATOL:g}")
    return max_diff, share, all(torch.equal(got[k], want[k]) for k in want)


def params_of(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def trainer_state(tr):
    """A Trainer's params and optimizer state by name (clones)."""
    names = {p: n for n, p in tr.model.named_parameters()}
    out = {f"param/{k}": v.detach().clone() for k, v in tr.model.named_parameters()}
    out.update({f"{k}/{names[p]}": v.clone() for p, st in tr.optimizer.state.items() for k, v in st.items()})
    return out


def mt_embedding(dev, mesh, name, planted, users):
    """One embedding model with explicit_lookup through the sharded Trainer
    on the 1x1 mesh against the one-device Trainer (same init, same
    batches): a counted step, the params after MT_STEPS steps, a step on
    CUDA events beside the one-device step, the owner's gather against
    index_select at the joint batch's shape, then the rest of the fit and
    hits@100. Returns the counted launches and the gather's numbers."""
    idx = 0 if name == "two_tower" else 1
    loss_fn = tweet_mixer_world.two_tower_train_loss if idx == 0 else tweet_mixer_world.twhin_train_loss
    make = tweet_mixer_world.two_tower_batches if idx == 0 else tweet_mixer_world.twhin_batches
    rules = two_tower.PARTITION_RULES if idx == 0 else twhin.PARTITION_RULES
    batches = make(planted, EMB_B)
    t0 = time.perf_counter()
    one = Trainer(loss_fn, embedding_models(dev)[idx], TrainerConfig(learning_rate=EMB_LR), device=dev)
    shd = Trainer(loss_fn, embedding_models(dev, explicit=True)[idx], TrainerConfig(learning_rate=EMB_LR),
                  mesh=mesh, partition_rules=rules)
    first = [put_batch(next(batches), dev) for _ in range(MT_STEPS)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _, launches = counted(lambda: shd.train_step(first[0]))
    require(launches == EMB_LAUNCHES[name], f"{name} sharded step launches {launches}, want {EMB_LAUNCHES[name]}")
    for b in first[1:]:
        shd.train_step(b)
    for b in first:
        one.train_step(b)
    max_diff, share, equal = adam_rule(params_of(shd.model), params_of(one.model), MT_STEPS, EMB_LR,
                                       f"{name}: the sharded Trainer against the one-device Trainer")
    timed = first[0]
    ms, one_ms = timed_pair(lambda: shd.train_step(timed), lambda: one.train_step(timed), reps=EMB_TIMED)
    print(f"mesh_training: {name} (explicit_lookup, {TM_SHAPE.num_users} x {TM_SHAPE.num_items} x "
          f"{TM_SHAPE.embed_dim}, B={EMB_B}, adam {EMB_LR}) on the 1x1 mesh, built beside the one-device model in "
          f"{setup_s:.1f} s (set-up): launches a step {launches}; params after {MT_STEPS} steps "
          f"{'bit-equal to' if equal else 'within the Adam rule of'} the one-device Trainer's (max |diff| "
          f"{max_diff:.3g}, share beyond {PARAM_ATOL:g} {share:.3g}); a step {ms:.3f} ms against the one-device "
          f"step's {one_ms:.3f} ms (CUDA events, {EMB_TIMED} steps each, in turns; not a benchmark)")
    del one
    # the owner's gather of the item table at this step's shape: the joint batch's block, clipped
    ids = put_batch(next(batches), dev)["items"].to(torch.int32).clamp(0, TM_SHAPE.num_items - 1).contiguous()
    timing = time_gather(ids, (shd.model.item_table.detach(),),
                         f"mesh_training: {ids.numel()} of {TM_SHAPE.num_items} x 512 B item rows (the sharded "
                         f"{name} step's owner gather at world 1)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    while shd.step < EMB_STEPS:
        out = shd.train_step(next(batches))
    loss = float(out["loss"])
    fit_s = time.perf_counter() - t0
    if idx == 0:
        hits = round(tweet_mixer_world.two_tower_hits(shd.model, planted, users, EMB_K), 4)
    else:
        hits = [round(h, 4) for h in tweet_mixer_world.twhin_hits(shd.model, planted, users, EMB_K)]
    require(all(h >= EMB_HITS for h in np.atleast_1d(hits)), f"{name}: sharded hits@{EMB_K} {hits} below {EMB_HITS}")
    print(f"mesh_training: {name} sharded fit to {EMB_STEPS} steps, loss {loss:.4f} ({fit_s:.1f} s on the host "
          f"clock); hits@{EMB_K} of the planted item over all {TM_SHAPE.num_items} items, {EMB_EVAL_USERS} users: "
          f"{hits} (at least {EMB_HITS} required)")
    del shd
    torch.cuda.empty_cache()
    return launches, timing


def masknet_trainers(dev, cfg, meshes):
    """A Trainer for each of ``meshes`` (None: one device; else sharded by
    masknet.PARTITION_RULES) over the same MaskNet init, each with bench.py's
    AdamBf16 (TRAIN_LR) for the config's adam."""
    loss_fn = lambda m, b: (masknet.multi_task_loss(m(b["x"]), b["y"]), {})  # noqa: E731
    out = []
    for m in meshes:
        model = masknet.MaskNet(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        if m is None:
            tr = Trainer(loss_fn, model, TrainerConfig(learning_rate=TRAIN_LR), device=dev)
        else:
            tr = Trainer(loss_fn, model, TrainerConfig(learning_rate=TRAIN_LR), mesh=m,
                         partition_rules=masknet.PARTITION_RULES)
        blocks = tr.optimizer.block_axes
        tr.optimizer = optimizers.AdamBf16(tr.model.parameters(), TRAIN_LR)  # bench.py's optimizer
        if m is not None:
            tr.optimizer.split_over(m, blocks)
        out.append(tr)
    return out


def masknet_batch(dev, cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, cfg.num_features)).astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.random((B, cfg.num_heads)) < 0.05).astype(np.float32)).to(dev)
    return {"x": x.to(torch.bfloat16) if cfg.dtype == "bfloat16" else x, "y": y}


def mt_masknet(dev, mesh):
    """bench.py's MaskNet step through the sharded Trainer on the 1x1 mesh
    against the one-device step: the params after MT_STEPS steps, and both
    steps on CUDA events."""
    cfg = masknet.MaskNetConfig(**TRAIN_MODEL)
    one, shd = masknet_trainers(dev, cfg, (None, mesh))
    batch = masknet_batch(dev, cfg, TRAIN_B)
    for _ in range(MT_STEPS):
        one.train_step(batch)
        shd.train_step(batch)
    max_diff, share, equal = adam_rule(params_of(shd.model), params_of(one.model), MT_STEPS, TRAIN_LR,
                                       "MaskNet: the sharded Trainer against the one-device Trainer")
    ms, one_ms = timed_pair(lambda: shd.train_step(batch), lambda: one.train_step(batch), reps=TRAIN_STEPS)
    print(f"mesh_training: bench.py's MaskNet step (F={cfg.num_features}, bf16, B={TRAIN_B}, AdamBf16({TRAIN_LR})) "
          f"through the sharded Trainer with masknet.PARTITION_RULES on the 1x1 mesh: params after {MT_STEPS} steps "
          f"{'bit-equal to' if equal else 'within the Adam rule of'} the one-device Trainer's (max |diff| "
          f"{max_diff:.3g}, share beyond {PARAM_ATOL:g} {share:.3g}); a step {ms:.3f} ms against {one_ms:.3f} ms "
          f"(CUDA events, {TRAIN_STEPS} steps each, in turns; not a benchmark)")
    del one, shd, batch
    torch.cuda.empty_cache()


def e4_two_tower(dev, explicit):
    s = MT_E4
    gen = torch.Generator(device=dev).manual_seed(7)
    return two_tower.TwoTower(two_tower.TwoTowerConfig(s["users"], s["items"], s["dim"], (s["dim"],),
                                                       explicit_lookup=explicit), device=dev, generator=gen)


def e4_batches():
    rng = np.random.default_rng(8)
    s = MT_E4
    return [{"users": rng.integers(0, s["users"], s["batch"]).astype(np.int32),
             "items": rng.integers(0, s["items"], s["batch"]).astype(np.int32)} for _ in range(MT_STEPS)]


def e4_runs(dev, mesh, rank=None, ckpt=None):
    """The E=4 check's three runs on ``mesh`` (world 1 in the parent, the
    2x2, 1x4 and 4x1 meshes on a rank): the explicit two-tower, the f32
    MaskNet and the implicit two-tower fed local batches. With ``ckpt`` the
    two-tower saves there after MT_SAVED steps, and Trainers on the 1x4 and
    4x1 meshes restore it (their state, then their next step). Returns numpy
    results by name, and the two sharded models' specs."""
    meshes = mesh if isinstance(mesh, dict) else {k: mesh for k in ("2x2", "1x4", "4x1")}
    res = {}
    cfg = TrainerConfig(learning_rate=MT_E4_LR, checkpoint_dir=ckpt)
    tt = Trainer(tweet_mixer_world.two_tower_train_loss, e4_two_tower(dev, True), cfg, mesh=meshes["2x2"],
                 partition_rules=two_tower.PARTITION_RULES)
    batches = e4_batches()
    _, n = counted(lambda: tt.train_step(batches[0]))
    for b in batches[1:]:
        if ckpt and tt.step == MT_SAVED:
            tt.save()
        tt.train_step(b)
    res["tt_launches"] = np.asarray([n["row_gather"], n["run_collapse_rows"]])
    res.update({f"tt/{k}": v.cpu().numpy() for k, v in params_of(tt.model).items()})
    specs = {"tt": tt.specs}
    del tt
    for key in ("1x4", "4x1") if ckpt else ():
        rt = Trainer(tweet_mixer_world.two_tower_train_loss, e4_two_tower(dev, True), cfg, mesh=meshes[key],
                     partition_rules=two_tower.PARTITION_RULES)
        res.update(restored_after(rt, batches[MT_SAVED], f"rs/{key}"))
        del rt
    cfg = masknet.MaskNetConfig(**MT_E4_MASKNET)
    (mn,) = masknet_trainers(dev, cfg, (meshes["1x4"],))
    batch = masknet_batch(dev, cfg, MT_E4["batch"], seed=9)
    mn.train_step(batch)  # the first step's gradients (after the gradient rule) and params
    res.update({f"mn1/{k}": v.cpu().numpy() for k, v in params_of(mn.model).items()})
    res.update({f"mng/{k}": p.grad.cpu().numpy() for k, p in mn.model.named_parameters()})
    for _ in range(MT_STEPS - 1):
        mn.train_step(batch)
    res.update({f"mn/{k}": v.cpu().numpy() for k, v in params_of(mn.model).items()})
    specs["mn"] = mn.specs
    del mn, batch
    m41 = meshes["4x1"]
    local = Trainer(tweet_mixer_world.two_tower_train_loss, e4_two_tower(dev, False),
                    TrainerConfig(learning_rate=MT_E4_LR), mesh=m41, partition_rules=two_tower.PARTITION_RULES,
                    local_batches=rank is not None)
    per = MT_E4["batch"] // m41.size(meshlib.DATA_AXIS)
    pos = m41.coord(meshlib.DATA_AXIS)
    feed = [b if rank is None else {k: v[pos * per:(pos + 1) * per] for k, v in b.items()} for b in batches]
    res["local_loss"] = np.asarray([float(local.train_step(b)["loss"]) for b in feed])
    del local
    torch.cuda.empty_cache()
    return res, specs


def restored_after(tr, batch, prefix):
    """``tr`` restored from its checkpoint_dir: its params and Adam state
    by name, its step, then its params after a step on ``batch`` (numpy)."""
    tr.restore()
    out = {f"{prefix}/{k}": v.cpu().numpy() for k, v in trainer_state(tr).items()}
    out[f"{prefix}/step"] = np.asarray(tr.step)
    tr.train_step(batch)
    out.update({f"{prefix}/next/{k}": v.cpu().numpy() for k, v in params_of(tr.model).items()})
    return out


def saved_globals(step_dir, names, specs, sizes, shapes):
    """The global arrays of a mesh checkpoint's params and Adam moments, by
    name as :func:`trainer_state` names them, assembled from the raw files
    (``state.<rank>.pt``, each rank's blocks at its mesh position) by
    :func:`spec_block`, and the Adam count."""
    out = {}
    count = None
    for j in range(int(np.prod(list(sizes.values())))):
        f = torch.load(os.path.join(step_dir, f"state.{j}.pt"), map_location="cpu")
        coords = {"data": j // sizes["model"], "model": j % sizes["model"]}
        for i, n in enumerate(names):
            st = f["optimizer"]["state"][i]
            count = int(st["count"]) if count is None else count
            for key, block in ((f"param/{n}", f["model"][n]), (f"mu/{n}", st["mu"]), (f"nu/{n}", st["nu"])):
                glob = out.setdefault(key, np.zeros(shapes[n], block.numpy().dtype))
                spec_block(glob, specs[n], coords, sizes)[...] = block.numpy()
    return out, count


def check_restored(got, saved, count, specs, sizes, coords, never_stopped, what):
    """A restored Trainer's state (``restored_after``'s) against the saved
    global arrays' blocks at ``coords`` of a mesh of ``sizes``, bit for
    bit, and its next step within the Adam rule of the run that never
    stopped. Returns the next step's max |diff|."""
    for key, glob in saved.items():
        n = key.split("/", 1)[1]
        require(np.array_equal(got[key], spec_block(glob, specs[n], coords, sizes)),
                f"{what}: the restored {key} is not the saved global array's block")
    require(int(got["step"]) == MT_SAVED and all(int(got[f"count/{n}"]) == count for n in specs)
            and all(got[f"count/{n}"].dtype == np.int32 for n in specs),
            f"{what}: restored step {got['step']}, counts not the saved int32 {count}")
    nxt = {n: torch.from_numpy(np.ascontiguousarray(got[f"next/{n}"])) for n in specs}
    ref = {n: torch.from_numpy(np.ascontiguousarray(spec_block(never_stopped[n], specs[n], coords, sizes)))
           for n in specs}
    return adam_rule(nxt, ref, MT_STEPS, MT_E4_LR, f"{what}: the step after the restore")[0]


def mt_rank(rank: int, root: str) -> int:
    """One of the E=4 check's ranks (``chip_smoke.py --mesh-training-rank r
    dir``): a gloo rank on cuda:0 running :func:`e4_runs` on 2x2, 1x4 and
    4x1 meshes, its results into ``root``."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'store4')}", rank=rank, world_size=4)
    try:
        meshes = {k: meshlib.make_mesh(meshlib.MeshSpec(data=d, model=m)) for k, (d, m) in
                  (("2x2", (2, 2)), ("1x4", (1, 4)), ("4x1", (4, 1)))}
        res, _ = e4_runs(dev, meshes, rank, ckpt=os.path.join(root, "tt_ckpt"))
        dist.barrier()
        np.savez(os.path.join(root, f"mt_rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
    return 0


def spec_block(x: np.ndarray, spec, coords: dict, sizes: dict) -> np.ndarray:
    """The block of global ``x`` under ``spec`` at mesh ``coords``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        pos, n = 0, 1
        for a in ((entry,) if isinstance(entry, str) else entry):
            pos, n = pos * sizes[a] + coords[a], n * sizes[a]
        per = x.shape[dim] // n
        x = x[(slice(None),) * dim + (slice(pos * per, (pos + 1) * per),)]
    return x


def mt_four_ranks(dev, mesh, root):
    """E=4 on this one card: four gloo ranks (each its own process on
    cuda:0) against the same runs at world 1. Correctness only: the
    exchange crosses the host, so no time of it is a rate."""
    res, specs = e4_runs(dev, mesh)
    want = {k: torch.from_numpy(v) for k, v in res.items()}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-training-rank", str(r), root])
             for r in range(4)]
    try:
        codes = [p.wait(timeout=MT_E4_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(codes == [0, 0, 0, 0], f"an E=4 mesh-training rank failed: exit codes {codes}")
    outs = [np.load(os.path.join(root, f"mt_rank{r}.npz")) for r in range(4)]
    shapes = {"tt": {"data": 2, "model": 2}, "mn": {"data": 1, "model": 4}}
    worst = {"tt": 0.0, "mn1": 0.0, "mn": 0.0, "mn_share": 0.0, "mng": 0.0}
    for r, o in enumerate(outs):
        rg, rows = (int(v) for v in o["tt_launches"])
        require(rg == 2 and rows == 2, f"E=4 rank {r}: a two-tower step launched {rg} row_gather, {rows} "
                                        "run_collapse_rows (want 2 + 2: each rank owns a block of both tables, "
                                        "gathers its peers' rows and collapses their cotangents)")
        for run in ("tt", "mng", "mn1", "mn"):
            model = run[:2]
            sizes = shapes[model]
            coords = {"data": r // sizes["model"], "model": r % sizes["model"]}
            got = {k: torch.from_numpy(o[f"{run}/{k}"]) for k in specs[model]}
            ref = {k: torch.from_numpy(np.ascontiguousarray(spec_block(want[f"{run}/{k}"].numpy(), specs[model][k],
                                                                       coords, sizes)))
                   for k in specs[model]}
            if run == "mng":  # each parameter's gradient block by cosine (MT_GRAD_COS's note)
                cos = min(float(torch.nn.functional.cosine_similarity(got[k].double().reshape(1, -1),
                                                                      ref[k].double().reshape(1, -1)))
                          for k in ref if ref[k].abs().max() > 0)
                require(cos >= MT_GRAD_COS, f"E=4 rank {r}: MaskNet gradients at cosine {cos:.8f} of world 1's")
                worst[run] = max(worst[run], 1 - cos)
            elif run == "mn":  # 3 steps: the rule's bound; the share is printed, not held (see MT_LOSS_RTOL's note)
                diffs = torch.cat([(got[k] - ref[k]).abs().reshape(-1) for k in ref])
                require(float(diffs.max()) <= 2 * MT_STEPS * TRAIN_LR,
                        f"E=4 rank {r}: MaskNet params after {MT_STEPS} steps off world 1's by {float(diffs.max()):.3g}")
                worst["mn"] = max(worst["mn"], float(diffs.max()))
                worst["mn_share"] = max(worst["mn_share"], float((diffs > PARAM_ATOL).double().mean()))
            else:
                steps, lr = (MT_STEPS, MT_E4_LR) if run == "tt" else (1, TRAIN_LR)
                worst[run] = max(worst[run], adam_rule(got, ref, steps, lr, f"E=4 rank {r} {run}")[0])
        loss = o["local_loss"]
        require(np.allclose(loss, want["local_loss"].numpy(), rtol=MT_LOSS_RTOL, atol=0),
                f"E=4 rank {r}: the local-batch loss {loss} against the global batch's {want['local_loss'].numpy()}")
    print(f"mesh_training E=4: four gloo ranks on the one card against the same runs at world 1: the explicit "
          f"two-tower ({MT_E4['users']} x {MT_E4['items']} x {MT_E4['dim']}, B={MT_E4['batch']}, adam {MT_E4_LR}) on "
          f"a 2x2 mesh, each rank's blocks after {MT_STEPS} steps within the Adam rule (max |diff| {worst['tt']:.3g}), "
          f"each rank's step launching 2 row_gather + 2 run_collapse_rows (the owner's gather and gradient of each "
          f"table); MaskNet (F={MT_E4_MASKNET['num_features']}, f32, B={MT_E4['batch']}, AdamBf16({TRAIN_LR})) with "
          f"PARTITION_RULES on a 1x4 mesh: the first step's gradients at cosine >= {1 - worst['mng']:.8f} of world "
          f"1's (limit {MT_GRAD_COS}), the params after it within the Adam rule (max |diff| "
          f"{worst['mn1']:.3g}), after {MT_STEPS} steps max |diff| {worst['mn']:.3g} (limit {2 * MT_STEPS * TRAIN_LR:g}; "
          f"share beyond {PARAM_ATOL:g} {worst['mn_share']:.3g}, not held: later steps amplify any change of "
          f"summation order); the implicit two-tower on 4x1 fed "
          f"a different quarter on each rank: the reported loss the global batch's within rtol {MT_LOSS_RTOL}; "
          f"{time.perf_counter() - t0:.1f} s (correctness only)")
    mt_restores(dev, mesh, root, outs, specs["tt"], {k[3:]: v.numpy() for k, v in want.items() if k.startswith("tt/")})


def mt_restores(dev, mesh, root, outs, specs, never_stopped):
    """The E=4 two-tower's 2x2 checkpoint (after MT_SAVED steps) restored on
    1x4 and 4x1 (the ranks' ``rs/`` results), on this process's 1x1 NCCL
    mesh and into a one-device Trainer (the implicit two-tower: the row
    exchange needs a mesh; the E=4 ids are in range, where both reads
    agree): each against the saved global arrays assembled from the files,
    and its next step against the world-1 run that never stopped."""
    t0 = time.perf_counter()
    names = list(specs)
    ckpt = os.path.join(root, "tt_ckpt")
    shapes = {n: never_stopped[n].shape for n in names}
    saved, count = saved_globals(os.path.join(ckpt, str(MT_SAVED)), names, specs, {"data": 2, "model": 2}, shapes)
    worst = {}
    for r, o in enumerate(outs):
        for key, sizes in (("1x4", {"data": 1, "model": 4}), ("4x1", {"data": 4, "model": 1})):
            got = {k[len(key) + 4:]: o[k] for k in o.files if k.startswith(f"rs/{key}/")}
            coords = {"data": r // sizes["model"], "model": r % sizes["model"]}
            worst[key] = max(worst.get(key, 0.0), check_restored(got, saved, count, specs, sizes, coords,
                                                                 never_stopped, f"E=4 rank {r} restored on {key}"))
    cfg = TrainerConfig(learning_rate=MT_E4_LR, checkpoint_dir=ckpt)
    batch = e4_batches()[MT_SAVED]
    one, origin = {"data": 1, "model": 1}, {"data": 0, "model": 0}
    for what, make in (("1x1 NCCL", lambda: Trainer(tweet_mixer_world.two_tower_train_loss, e4_two_tower(dev, True),
                                                     cfg, mesh=mesh, partition_rules=two_tower.PARTITION_RULES)),
                       ("one device", lambda: Trainer(tweet_mixer_world.two_tower_train_loss,
                                                      e4_two_tower(dev, False), cfg, device=dev))):
        got = {k[3:]: v for k, v in restored_after(make(), batch, "rs").items()}
        worst[what] = check_restored(got, saved, count, specs, one, origin, never_stopped, f"restored on {what}")
        torch.cuda.empty_cache()
    print(f"mesh_training: the E=4 two-tower's 2x2 checkpoint after {MT_SAVED} steps restored on 1x4 and 4x1 (each "
          f"rank), on the 1x1 NCCL mesh and into a one-device Trainer: params and Adam moments bit-equal to the saved "
          f"global arrays' blocks (assembled from the four files), the int32 count and the step; the next step within "
          f"the Adam rule of the world-1 run that never stopped (max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f"); {time.perf_counter() - t0:.1f} s")


def phase_mesh_training(dev):
    """The mesh layer's training half at world size 1 (NCCL), then E=4 on
    this one card over gloo. Returns the path's launches (the counted
    sharded steps) and the owner gather's numbers."""
    import torch.distributed as dist

    print(card_line())
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store1')}", rank=0, world_size=1)
        try:
            mesh = meshlib.make_mesh(meshlib.MeshSpec(data=1, model=1))
            print(f"mesh_training: one NCCL rank, a 1x1 (data, model) mesh on {mesh.device}; every collective of "
                  "the step is over an axis of one rank, so none is launched")
            planted = tweet_mixer_world.planted_engagements(TM_SHAPE)
            users = np.random.default_rng(5).permutation(TM_SHAPE.num_users)[:EMB_EVAL_USERS]
            tt, timing = mt_embedding(dev, mesh, "two_tower", planted, users)
            th, _ = mt_embedding(dev, mesh, "twhin", planted, users)
            mt_masknet(dev, mesh)
            mt_four_ranks(dev, mesh, tmp)
        finally:
            dist.destroy_process_group()
    launches = {k: tt[k] + th[k] for k in tt}
    print(f"mesh_training: launches of the path {launches} (a sharded two-tower step {tt}, a TwHIN step {th})")
    return {"launches": launches, "row_gather": timing}


# Phoenix training at full width (``PhoenixConfig()``: d 256, 4 layers, 8
# heads, L 256, 65,536 author buckets, bf16) on batches made from a served
# log, as the JAX round trip (tests/test_phoenix.py:406-482) makes them: each
# user favs a planted set of authors, which also fill most of its history
PT_CONFIG = phoenix.PhoenixConfig()
PT_B = 32  # requests a step
PT_C = 1400  # candidates a request: PhoenixUtils.scala's MaxCandidates, training_batch's max_candidates
PT_USERS = 128  # users served once each: PT_USERS / PT_B training batches
PT_HELD_OUT = 32  # users served for the preference AUC, never trained on
PT_AUTHORS = 4096  # FY_WORLD's authors
PT_LIKED = 32  # authors a user favs
PT_HISTORY_LIKED = 0.7  # share of a user's raw events on its liked authors
PT_LIKED_SHARE = 0.3  # share of a request's candidates by its liked authors
PT_EVENTS = 400  # raw events a user: aggregated, the history fills its 256 slots
PT_SEED = 18
PT_LR = 1e-3  # adam (TrainerConfig(optimizer="adam"): optax.adamw at decay 0)
PT_EPOCHS = 40  # passes over the training batches
PT_TIMED = 20  # loop-carried steps timed with CUDA events
PT_RETRAIN = 0.7  # the JAX round trip's bar: the last loss below 0.7 x the first
PT_TIMEOUT = 300  # the child's limit, inside the script's
# one step: author_emb's read of every request's history and candidates (one
# row_gather) and its gradient (one run_collapse_rows); the action, age and
# position tables are plain indexing
PT_LAUNCHES = {"run_collapse": 0, "row_gather": 1, "run_collapse_rows": 1}
# first-step f32 gradients, card against CPU: of each parameter's largest
# entry, plus a floor of the largest gradient entry's (a gradient whose
# terms cancel carries their f32 noise: tests/test_torch_phoenix_training.py)
PT_GRAD_FLOOR = 1e-7
# the JAX package's AUC recipe at its own shape (tests/test_phoenix.py:255-350)
PT_RECIPE = phoenix.PhoenixConfig(d_model=32, n_layers=1, n_heads=2, max_history=16, author_buckets=32,
                                  dtype="float32")
PT_RECIPE_C, PT_RECIPE_B, PT_RECIPE_STEPS, PT_RECIPE_EVAL = 8, 32, 300, 64
PT_RECIPE_AUC = 0.75
FAV = int(phoenix.ActionName.SERVER_TWEET_FAV)


def pt_user(u):
    """User ``u``'s planted world, drawn from (PT_SEED, u): its liked
    authors, its raw events (ts_ms, action, author) over the last 7 days, its
    candidates' authors and kinds (0 plain, 1 reply, 2 quote, 3 retweet)."""
    rng = np.random.default_rng([PT_SEED, int(u)])
    liked = rng.choice(PT_AUTHORS, PT_LIKED, replace=False)
    n = PT_EVENTS
    ts = foryou_world.NOW * 1000 - rng.integers(0, 7 * 86400 * 1000, n)
    authors = np.where(rng.random(n) < PT_HISTORY_LIKED, rng.choice(liked, n), rng.integers(0, PT_AUTHORS, n))
    events = list(zip(ts.tolist(), rng.integers(1, phoenix.NUM_ACTIONS, n).tolist(), authors.tolist()))
    c_auth = np.where(rng.random(PT_C) < PT_LIKED_SHARE, rng.choice(liked, PT_C), rng.integers(0, PT_AUTHORS, PT_C))
    return liked, events, c_auth, rng.integers(0, 4, PT_C)


PT_KIND_FEATURES = ({}, {"in_reply_to_tweet_id": 1}, {"quoted_tweet_id": 1}, {"source_tweet_id": 1})


def pt_serve(dev, model, users):
    """Serve each user's request once through the Phoenix scorer over
    ``model`` and log it with the side effect; then the log joined with the
    planted favs by ``training_batch``. Returns the per-request examples in
    user order and the (user, tweet) favs."""
    scorer = ps.PhoenixScorer(phoenix.scorer_predict_fn(model))
    side = pl.ScoredPhoenixCandidatesSideEffect(pl.PhoenixScoreStore())
    seqs, favs = {}, {}
    for u in users:
        liked, events, c_auth, kinds = pt_user(u)
        h = phoenix.aggregate_history(events, now_ms=foryou_world.NOW * 1000, max_length=PT_CONFIG.max_history)
        seqs[u] = phoenix.UserActionSequence(*(torch.from_numpy(h[k]) for k in phoenix.UserActionSequence._fields))
        cands = [Candidate(id=int(u) * PT_C + i, score=0.0, features={"author_id": int(a), **PT_KIND_FEATURES[k]})
                 for i, (a, k) in enumerate(zip(c_auth, kinds))]
        q = SimpleNamespace(user_id=int(u), now=foryou_world.NOW, features={"user_actions": seqs[u].to(dev)})
        scorer.score(q, cands, None)
        side.run(q, cands, None)
        liked = set(liked.tolist())
        favs.update({(int(u), c.id): [FAV] for c in cands if c.features["author_id"] in liked})
    require(len(side.log) == len(users) * PT_C, f"phoenix_training: the side effect logged {len(side.log)} of "
                                                f"{len(users) * PT_C} served candidates")
    return pl.training_batch(side.log, favs, seqs.__getitem__, PT_CONFIG.author_buckets, PT_C), favs


def pt_stack(examples):
    """Per-request (sequence, candidates, labels) stacked into one [B, ...]
    batch (the JAX tests stack with ``tree_map(jnp.stack, ...)``)."""
    seqs, cands, labels = zip(*examples)
    return (phoenix.UserActionSequence(*(torch.stack(f) for f in zip(*seqs))),
            phoenix.CandidateFeatures(*(torch.stack(f) for f in zip(*cands))), torch.stack(labels))


def pt_loss(model, batch):
    seq, cands, labels = batch
    return phoenix.multi_action_loss(model(seq, cands), labels, cands.valid), {}


def pt_fav_split(model, batch):
    """(fav probability of every valid candidate, its fav label) of a batch."""
    seq, cands, labels = batch
    with torch.no_grad():
        p = phoenix.predict_next_actions(model, seq, cands)[..., FAV]
    keep = cands.valid
    return p[keep].float().cpu(), labels[..., FAV][keep].cpu()


def pt_card_against_cpu(dev, init, batch):
    """The first step's f32 gradients at full width (TF32 off) on the card
    and on the CPU from the same init and batch, per parameter."""
    cfg = dataclasses.replace(PT_CONFIG, dtype="float32")
    grads = []
    for where in (dev, torch.device("cpu")):
        model = phoenix.PhoenixModel(cfg, device=where)
        model.load_state_dict(init)
        loss, _ = pt_loss(model, put_batch(batch, where))
        loss.backward()
        grads.append({k: p.grad.detach().cpu() for k, p in model.named_parameters()})
        del model, loss
    card, cpu = grads
    floor = PT_GRAD_FLOOR * max(float(g.abs().max()) for g in cpu.values())
    for k in cpu:
        require(float((card[k] - cpu[k]).abs().max()) <= GRAD_SCALE_TOL * float(cpu[k].abs().max()) + floor,
                f"phoenix_training: f32 gradients of {k} card vs CPU beyond {GRAD_SCALE_TOL} of its largest entry "
                f"+ {PT_GRAD_FLOOR:g} of the largest gradient's")
    require(bool(cpu["author_emb.embedding"].abs().max() > 0), "phoenix_training: author_emb has no gradient")
    return max(float((card[k] - cpu[k]).abs().max() / cpu[k].abs().max().clamp(min=1e-30)) for k in cpu)


def pt_recipe_sample(rng, n):
    """The JAX recipe's draw (tests/test_phoenix.py:271-302), a stacked batch:
    a history of 16 favs of 4 liked authors, 8 candidates, fav iff liked."""
    cfg, C = PT_RECIPE, PT_RECIPE_C
    L, nb = cfg.max_history, cfg.author_buckets
    out = []
    for _ in range(n):
        liked = rng.choice(nb, 4, replace=False)
        seq = phoenix.UserActionSequence(
            torch.full((L,), FAV, dtype=torch.int32), torch.from_numpy(rng.choice(liked, L).astype(np.int32)),
            torch.from_numpy((np.arange(L)[::-1] * 60).astype(np.int32)), torch.ones(L, dtype=torch.bool))
        c_auth = rng.choice(nb, C)
        lab = np.zeros((C, phoenix.NUM_ACTIONS), np.float32)
        lab[:, FAV] = np.isin(c_auth, liked)
        out.append((seq, phoenix.CandidateFeatures(torch.from_numpy(c_auth.astype(np.int32)),
                                                   torch.zeros((C, phoenix.NUM_BOOL_FEATURES)),
                                                   torch.ones(C, dtype=torch.bool)), torch.from_numpy(lab)))
    return pt_stack(out)


def pt_fav_weighted_loss(model, batch):
    """The JAX recipe's loss: positive-weighted BCE on the fav head
    (tests/test_phoenix.py:321-330)."""
    seq, cands, labels = batch
    lg, y = model(seq, cands)[..., FAV], labels[..., FAV]
    ce = torch.clamp(lg, min=0) - lg * y + torch.log1p(torch.exp(-lg.abs()))
    return torch.mean(ce * torch.where(y > 0, 3.0, 1.0)), {}


def pt_recipe(dev):
    """The JAX package's AUC recipe at its own shape on the card: 300 adam
    1e-3 steps of 32 users through the Trainer, then the fav head's AUC over
    64 new users."""
    rng = np.random.default_rng(0)
    model = phoenix.PhoenixModel(PT_RECIPE, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    tr = Trainer(pt_fav_weighted_loss, model, TrainerConfig(learning_rate=1e-3, optimizer="adam"), device=dev)
    t0 = time.perf_counter()
    for _ in range(PT_RECIPE_STEPS):
        tr.train_step(pt_recipe_sample(rng, PT_RECIPE_B))
    seq, cands, labels = put_batch(pt_recipe_sample(rng, PT_RECIPE_EVAL), dev)
    with torch.no_grad():
        probs = torch.sigmoid(model(seq, cands)[..., FAV])
    auc = float(metrics.auc(probs.reshape(-1), labels[..., FAV].reshape(-1)))
    require(auc > PT_RECIPE_AUC, f"phoenix_training: the JAX recipe's AUC {auc:.4f} (want > {PT_RECIPE_AUC})")
    return auc, time.perf_counter() - t0


def pt_restore_bits(dev, tr, batch):
    """Save ``tr``; its next step on ``batch``, the same step of a fresh
    Trainer restored from the save, and of ``tr`` restored: the restored
    params and moments the saved bits, all three steps bit-equal."""
    tr.save()
    saved = trainer_state(tr)
    tr.train_step(batch)
    after = params_of(tr.model)
    fresh = Trainer(pt_loss, phoenix.PhoenixModel(PT_CONFIG, device=dev), tr.config, device=dev)
    fresh.restore()
    got = trainer_state(fresh)
    require(fresh.step == tr.step - 1 and got.keys() == saved.keys()
            and all(torch.equal(got[k], saved[k]) for k in saved),
            "phoenix_training: the restored step, params or optimizer state are not the saved bits")
    fresh.train_step(batch)
    tr.restore()
    tr.train_step(batch)
    for other in (fresh, tr):
        require(all(torch.equal(v, after[k]) for k, v in params_of(other.model).items()),
                "phoenix_training: two equal steps from one saved state are not bit-equal")


def phase_phoenix_training(dev):
    """Phoenix trained at full width on a served log through the one-device
    Trainer: the counted step, the card against the CPU, steps bit-equal run
    to run and across a save and restore, the round trip's bars and the
    preference AUC, the JAX recipe's AUC, the step's time by part and both
    kernels at its shapes. Returns the path's launches."""
    t_start = time.perf_counter()
    print(f"phoenix_training: {card_line()}")
    cfg = PT_CONFIG
    model = phoenix.PhoenixModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(PT_SEED))
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    examples, favs = pt_serve(dev, model, range(PT_USERS + PT_HELD_OUT))
    serve_s = time.perf_counter() - t0
    require(all(bool(s.valid.all()) for s, _, _ in examples), "phoenix_training: a history is not full")
    batches = [put_batch(pt_stack(examples[i:i + PT_B]), dev) for i in range(0, PT_USERS, PT_B)]
    held_out = put_batch(pt_stack(examples[PT_USERS:]), dev)
    n_favs = sum(1 for u, _ in favs if u < PT_USERS)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        tr = Trainer(pt_loss, model, TrainerConfig(learning_rate=PT_LR, optimizer="adam", checkpoint_dir=root),
                     device=dev)
        out, launches = counted(lambda: tr.train_step(batches[0]))
        require(launches == PT_LAUNCHES, f"phoenix_training: a step launched {launches}, want {PT_LAUNCHES}")
        losses = [float(out["loss"])]
        worst = pt_card_against_cpu(dev, init, batches[0])
        step_ms = None
        while tr.step < PT_EPOCHS * len(batches):
            b = batches[tr.step % len(batches)]
            if step_ms is None and tr.step >= 2 * len(batches):  # a window of loop-carried steps, warm
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(PT_TIMED):
                    tr.train_step(batches[tr.step % len(batches)])
                end.record()
                end.synchronize()
                step_ms = start.elapsed_time(end) / PT_TIMED
                continue
            losses.append(float(tr.train_step(b)["loss"]))
        last = losses[-1]
        require(np.isfinite(last) and last < PT_RETRAIN * losses[0],
                f"phoenix_training: the loss went {losses[0]:.4f} -> {last:.4f} (want below {PT_RETRAIN} x the first)")
        p, y = pt_fav_split(model, batches[0])
        engaged, unengaged = float(p[y > 0].mean()), float(p[y == 0].mean())
        require(engaged > unengaged, f"phoenix_training: engaged candidates' mean fav probability {engaged:.4f} not "
                                     f"above the unengaged ones' {unengaged:.4f}")
        hp, hy = pt_fav_split(model, held_out)
        pref_auc = float(metrics.auc(hp, hy))
        pt_restore_bits(dev, tr, batches[0])
        parts, top = embedding_step_breakdown(model, pt_loss, tr.optimizer, batches[1])
        inputs = collapse_inputs(tr, batches[1])
    seq, cands, _ = batches[1]
    ids = torch.remainder(torch.cat([seq.author_hashes, cands.author_hashes], dim=1), cfg.author_buckets)
    gather_t = time_gather(ids.reshape(-1).to(torch.int32).contiguous(), (model.author_emb.embedding.detach(),),
                           f"Phoenix author_emb at the training step's shape ({PT_B} x ({cfg.max_history} + {PT_C}) "
                           f"ids x {cfg.d_model * 4} B from [{cfg.author_buckets}, {cfg.d_model}] f32)")
    require(len(inputs) == 1, f"phoenix_training: a step collapsed {len(inputs)} table gradients, want 1")
    rows_t = time_collapse_rows(*inputs[0], f"Phoenix author_emb's gradient ({inputs[0][0].numel()} slots into "
                                            f"[{cfg.author_buckets}, {cfg.d_model}])")
    recipe_auc, recipe_s = pt_recipe(dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phoenix_training: PhoenixConfig() (d {cfg.d_model}, {cfg.n_layers} layers, {cfg.n_heads} heads, L "
          f"{cfg.max_history}, {cfg.author_buckets} buckets, {cfg.dtype}; {n_params / 1e6:.2f}M f32 params), "
          f"{PT_USERS + PT_HELD_OUT} requests of {PT_C} candidates served by the Phoenix scorer and logged by the "
          f"side effect in {serve_s:.1f} s (host clock), {n_favs} planted favs in the {PT_USERS} trained requests; "
          f"one counted step {launches}; f32 first-step gradients card vs CPU (B={PT_B}, TF32 off) within {worst:.3g} "
          f"of each parameter's largest entry (limit {GRAD_SCALE_TOL} + {PT_GRAD_FLOOR:g} of the largest gradient's); "
          f"adam {PT_LR}, B={PT_B}, {tr.step} steps: loss {losses[0]:.4f} -> {last:.4f} (bar: below {PT_RETRAIN} x); "
          f"mean fav probability engaged {engaged:.4f} vs unengaged {unengaged:.4f}; preference AUC on "
          f"{PT_HELD_OUT} held-out requests {pref_auc:.4f} (no bar); saved, restored into a fresh Trainer and into "
          f"itself: the saved bits, and the next step of each bit-equal to the step taken right after the save")
    print(f"phoenix_training: a step {step_ms:.3f} ms over {PT_TIMED} loop-carried steps (CUDA events, not a "
          f"benchmark); device time by part (one profiler session): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.most_common()) + f"; total {sum(parts.values()):.3f} ms; "
          "longest kernels " + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
    print(f"phoenix_training: the JAX recipe at its own shape (d 32, 1 layer, 2 heads, L 16, 32 buckets, f32; "
          f"{PT_RECIPE_STEPS} steps of {PT_RECIPE_B} users, adam 1e-3) AUC {recipe_auc:.4f} on {PT_RECIPE_EVAL} new "
          f"users (bar > {PT_RECIPE_AUC}) in {recipe_s:.1f} s; the phase {time.perf_counter() - t_start:.1f} s")
    return {"launches": launches, "row_gather": gather_t, "run_collapse_rows": rows_t}

# Moonlight-16B-A3B's routed layer at the Phoenix cell's batch (BENCHMARK.json:
# foryou.phoenix_moonlight_b16, 16 requests x 1,024 history slots)
PM_T, PM_E, PM_K, PM_D, PM_I = 16384, 64, 6, 2048, 1408
PM_PEAK_FLOPS = 989.4e12  # H100 SXM dense bf16 (NVIDIA's data sheet)
PM_WRAPPERS = {"expert_swiglu": expert_gemm.expert_swiglu, "expert_down": expert_gemm.expert_down,
               "moe_combine": expert_gemm.moe_combine}


def pm_close(got, want, what):
    """Kernel and plain version both sum in f32 and round once to bf16, in
    other orders: within a bf16 step (2^-7) of the result's largest entry."""
    err, scale = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
    require(err <= 2.0 ** -7 * scale, f"phoenix_moonlight: {what} {err:.4g} from its plain version "
                                      f"(limit {2.0 ** -7 * scale:.4g})")
    return err / scale


def pm_layer(dev, T, E, k, D, I, seed):
    """A routed layer's inputs: bf16 tokens and expert weights of the
    layer's scale, top-k of uniform scores (the cell's routing is near
    uniform), f32 weights, the shared expert's output and the residual."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(T, D, generator=g, device=dev).to(torch.bfloat16)
    idx = torch.topk(torch.rand(T, E, generator=g, device=dev), k, dim=-1).indices
    wg, wu = ((torch.randn(E, I, D, generator=g, device=dev) / D ** 0.5).to(torch.bfloat16) for _ in range(2))
    wd = (torch.randn(E, D, I, generator=g, device=dev) / I ** 0.5).to(torch.bfloat16)
    w = torch.rand(T, k, generator=g, device=dev)
    shared, res = (torch.randn(T, D, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    return x, idx, wg, wu, wd, w, shared, res


def pm_bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PM_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3


def pm_routed_layer(dev):
    """The three kernels at the cell's shape against their plain versions,
    with device times, bounds and the library loop."""
    T, E, k, D, I = PM_T, PM_E, PM_K, PM_D, PM_I
    x, idx, wg, wu, wd, w, shared, res = pm_layer(dev, T, E, k, D, I, seed=24)
    S = T * k
    with torch.inference_mode():
        d = expert_gemm.dispatch(idx, E)
        h = expert_gemm.expert_swiglu(x, wg, wu, d)
        y = expert_gemm.expert_down(h, wd, d)
        out = expert_gemm.moe_combine(y, w, shared, res)
        torch.cuda.synchronize()
        errs = {"expert_swiglu": pm_close(h, expert_gemm.expert_swiglu_plain(x, wg, wu, d), "expert_swiglu"),
                "expert_down": pm_close(y, expert_gemm.expert_down_plain(h, wd, d), "expert_down"),
                "moe_combine": pm_close(out, expert_gemm.moe_combine_plain(y, w, shared, res), "moe_combine")}
        offs = d.offsets.tolist()
        rows = [x[d.src[offs[e]:offs[e + 1]].long()] for e in range(E)]  # the library loop's gathered rows

        def library():
            for e in range(E):
                he = torch.nn.functional.silu(rows[e] @ wg[e].T) * (rows[e] @ wu[e].T)
                he @ wd[e].T

        calls = {"expert_swiglu": (lambda: expert_gemm.expert_swiglu(x, wg, wu, d),
                                   lambda: expert_gemm.expert_swiglu_plain(x, wg, wu, d)),
                 "expert_down": (lambda: expert_gemm.expert_down(h, wd, d),
                                 lambda: expert_gemm.expert_down_plain(h, wd, d)),
                 "moe_combine": (lambda: expert_gemm.moe_combine(y, w, shared, res),
                                 lambda: expert_gemm.moe_combine_plain(y, w, shared, res))}
        work = {"expert_swiglu": (2.0 * S * D * 2 * I, 2 * (T * D + 2 * E * I * D + S * I)),
                "expert_down": (2.0 * S * I * D, 2 * (S * I + E * D * I + S * D)),
                "moe_combine": (3.0 * S * D, 2 * (S * D + 3 * T * D) + 4 * S)}
        times = {}
        for name, (kernel, plain) in calls.items():
            ms, ev_ms = device_ms(kernel, 20, kernels_only=True), cuda_ms(kernel, 20)
            plain_ms = cuda_ms(plain, 3)
            times[name] = {"shape": f"{S} slots of {T} tokens over {E} experts, D {D}, I {I}", "device_ms": ms,
                           "cuda_events_ms": ev_ms, "bound_ms": pm_bound_ms(*work[name]),
                           "plain_ms": plain_ms, "max_rel_err": errs[name]}
        pair = times["expert_swiglu"]["device_ms"] + times["expert_down"]["device_ms"]
        lib_ms = cuda_ms(library, 10)
        times["expert_swiglu"]["library_ms"] = lib_ms  # the pair's yardstick: 64 x 3 library products
    for name, t in times.items():
        print(f"phoenix_moonlight: {name} at {t['shape']}: {t['device_ms']:.4f} ms device time "
              f"({t['cuda_events_ms']:.4f} ms on CUDA events), bound {t['bound_ms']:.4f} ms "
              f"({100 * t['bound_ms'] / t['device_ms']:.1f}%), plain version {t['plain_ms']:.3f} ms; within "
              f"{t['max_rel_err']:.3g} of the plain version's largest entry")
    print(f"phoenix_moonlight: the grouped GEMM pair {pair:.4f} ms against {lib_ms:.3f} ms for a loop of "
          f"{E} x 3 library products over pre-gathered rows (CUDA events)")
    return times


def pm_checked_layers(forward, gaps):
    """A ``MoE.forward`` that runs the layer as ``forward`` does, then holds
    the kernels to the plain versions on the layer's own inputs and
    dispatch, appending the gaps (a routed layer's inputs would differ
    between two whole forwards after the first, so each layer is held on its
    own)."""

    def checked(self, x, residual):
        out = forward(self, x, residual)
        idx, w = self.route(x)
        d = expert_gemm.dispatch(idx, self.c.n_routed_experts)
        e = self.experts
        h = expert_gemm.expert_swiglu(x, e.gate_proj, e.up_proj, d)
        y = expert_gemm.expert_down(h, e.down_proj, d)
        gaps.append(max(pm_close(h, expert_gemm.expert_swiglu_plain(x, e.gate_proj, e.up_proj, d), "expert_swiglu"),
                        pm_close(y, expert_gemm.expert_down_plain(h, e.down_proj, d), "expert_down")))
        want = expert_gemm.moe_combine_plain(y, w, self.shared_experts(x), residual)
        gaps.append(pm_close(expert_gemm.moe_combine(y, w, self.shared_experts(x), residual), want, "moe_combine"))
        return out

    return checked


def pm_small_forward(dev):
    """A small decoder-kind Phoenix: one counted forward, then one whose
    routed layers are each held against the plain versions."""
    cfg = phoenix.PhoenixConfig(d_model=256, n_layers=4, n_heads=4, max_history=64, author_buckets=1024,
                                decoder=dataclasses.replace(moe_transformer.MoEDecoderConfig(), n_routed_experts=16,
                                                            moe_intermediate_size=128, intermediate_size=512))
    model = phoenix.PhoenixModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    B, L, C = 2, 64, 40
    g = torch.Generator(device=dev).manual_seed(1)
    valid = torch.arange(L, device=dev)[None, :] >= torch.tensor([[0], [24]], device=dev)  # one left-padded
    seq = phoenix.UserActionSequence(torch.randint(0, phoenix.NUM_ACTIONS, (B, L), generator=g, device=dev,
                                                   dtype=torch.int32),
                                     torch.randint(0, 1 << 20, (B, L), generator=g, device=dev, dtype=torch.int32),
                                     torch.randint(0, 10 ** 6, (B, L), generator=g, device=dev, dtype=torch.int32),
                                     valid)
    cands = phoenix.CandidateFeatures(torch.randint(0, 1 << 20, (B, C), generator=g, device=dev, dtype=torch.int32),
                                      torch.rand((B, C, phoenix.NUM_BOOL_FEATURES), generator=g, device=dev),
                                      torch.ones((B, C), dtype=torch.bool, device=dev))
    routed = len(model.moe_layers())
    with torch.inference_mode():
        phoenix.predict_next_actions(model, seq, cands)  # warm
        for f in PM_WRAPPERS.values():
            f.launches = 0
        probs, launches = counted(lambda: phoenix.predict_next_actions(model, seq, cands))
        launches.update({name: _build.launches(f) for name, f in PM_WRAPPERS.items()})
        want = {"row_gather": 1, "run_collapse": 0, "run_collapse_rows": 0,
                **{name: routed for name in PM_WRAPPERS}}
        require(launches == want, f"phoenix_moonlight: a decoder forward launched {launches}, want {want}")
        require(bool(torch.isfinite(probs).all()), "phoenix_moonlight: a decoder forward's probabilities not finite")
        forward, gaps = moe_transformer.MoE.forward, []
        moe_transformer.MoE.forward = pm_checked_layers(forward, gaps)
        try:
            phoenix.predict_next_actions(model, seq, cands)
        finally:
            moe_transformer.MoE.forward = forward
    require(len(gaps) == 2 * routed, f"phoenix_moonlight: {len(gaps) // 2} of {routed} routed layers held")
    return launches, routed, max(gaps)


def phase_phoenix_moonlight(dev):
    """The grouped expert GEMM and the combine at the Phoenix cell's shape;
    a small decoder-kind forward's launches and layers."""
    t0 = time.perf_counter()
    times = pm_routed_layer(dev)
    launches, routed, gap = pm_small_forward(dev)
    print(f"phoenix_moonlight: a decoder-kind Phoenix (d 256, 4 layers of which {routed} routed over 16 experts, "
          f"L 64, 2 requests of 40 candidates, bf16): one counted forward {launches}; every routed layer's kernels "
          f"within {gap:.3g} of the plain versions' largest entry on its own inputs; the phase "
          f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "kernels": times}


def main() -> int:
    t_start = time.perf_counter()
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
    kernels["sort_by_id"] = phase_sort_kernel(world[0], world[6], world[7], cand_world)
    phase_gather_sweep(dev)
    phase_collapse_sweep(dev)
    phase_ranking(dev)
    by_path["training"] = phase_apart("--training", "training")
    by_path["exact_tier"], tier_scans = phase_exact_tier(world, (sann_ids, sann_scores), sann_recall, fy)
    by_path["live"], live_times = phase_live_updates(dev, world, fy)
    phase_new_path_times(tier_scans, live_times)
    t0 = time.perf_counter()
    fy["frs"] = frs_world.build(device=dev)  # the who-to-follow flow's world (run B) and the products phase's
    print(f"frs world: {fy['frs'].shape.num_users} users' follows, the follower adjacency "
          f"{fy['frs'].followers.shape}, the sims graph, the UUG and RealGraph tables and the host tables built in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")
    by_path["home_pipeline"], home = phase_home_pipeline(dev, fy)
    by_path["edge"] = phase_edge(dev, fy, home)
    del home
    by_path.update(phase_products(dev, fy, cand_world, world))
    by_path["write_path"] = phase_write_path(dev, fy)
    by_path["offline_simclusters"] = phase_apart("--offline-simclusters", "offline_simclusters")
    by_path.update(phase_apart("--offline-simclusters-2", "offline_simclusters_2"))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        save_world(world, root)  # the SANN world for these children, built once
        by_path["tweet_mixer"] = phase_apart("--tweet-mixer", "tweet_mixer", root)
        emb = phase_apart("--embedding-training", "embedding_training", root)
        by_path["embedding_training"] = emb["launches"]
        phase_apart("--collapse-rows", "run_collapse_rows sweep")
        kernels["run_collapse_rows"] = emb["run_collapse_rows"]
        by_path["mesh"] = phase_apart("--mesh", "mesh", root, timeout=MESH_TIMEOUT)["launches"]
    by_path["mesh_training"] = phase_apart("--mesh-training", "mesh_training", timeout=MT_TIMEOUT)["launches"]
    by_path["phoenix_training"] = phase_apart("--phoenix-training", "phoenix_training", timeout=PT_TIMEOUT)["launches"]
    pm = phase_apart("--phoenix-moonlight", "phoenix_moonlight")
    by_path["phoenix_moonlight"] = pm["launches"]
    kernels.update(pm["kernels"])
    sources = {
        "run_collapse": ("the_algorithm_tpu_torch/csrc/seg_scan.cu", "the_algorithm_tpu/ops/seg_scan.py:101"),
        "row_gather": ("the_algorithm_tpu_torch/csrc/gather.cu", "the_algorithm_tpu/ops/gather.py:55"),
        "run_collapse_rows": ("the_algorithm_tpu_torch/csrc/seg_scan.cu", "the_algorithm_tpu/ops/seg_scan.py:134"),
        "sort_by_id": ("the_algorithm_tpu_torch/csrc/id_sort.cu",
                       "none: the JAX package's lax.sort, the_algorithm_tpu/ops/retrieval.py:89, left to XLA"),
        "expert_swiglu": ("the_algorithm_tpu_torch/csrc/experts/expert_gemm.cu",
                          "none: the JAX package has no mixture of experts"),
        "expert_down": ("the_algorithm_tpu_torch/csrc/experts/expert_gemm.cu",
                        "none: the JAX package has no mixture of experts"),
        "moe_combine": ("the_algorithm_tpu_torch/tsrc/expert_gemm.py", "none: the JAX package has no mixture of experts"),
    }
    counted_everywhere = ("run_collapse", "row_gather", "run_collapse_rows")  # the rest on the paths that count them
    print(f"profiler: {PROFILER['sessions']} device-time sessions, {PROFILER['again']} of them opened again after "
          f"one that saw too little; {PROFILER['short']} times taken over kernel events the profiler left out, most "
          f"often of {PROFILER['left_out'].most_common(3)}")
    print(f"chip_smoke: {card_line()}; the whole script took {time.perf_counter() - t_start:.1f} s")
    # launches: the counted batches of every path together (sort_by_id's and the experts' on the paths that
    # count them); the times are at the SANN shapes and, for the experts' kernels, at the Phoenix cell's
    print(json.dumps({"kernels": [
        {"name": name, "route": "triton" if src.endswith(".py") else "cuda", "source": src, "replaces": rep,
         "launches": sum(n.get(name, 0) for n in by_path.values()),
         "launches_by_path": {path: n.get(name, 0) for path, n in by_path.items()
                              if name in counted_everywhere or name in n}, **kernels[name]}
        for name, (src, rep) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ROOT = sys.argv[2] if sys.argv[2:] else None  # a child's saved SANN world
    CHILD_PHASES = {"--training": phase_training, "--tweet-mixer": lambda dev: phase_tweet_mixer_alone(dev, ROOT),
                    "--embedding-training": lambda dev: phase_embedding_training(dev, ROOT),
                    "--collapse-rows": phase_collapse_rows_sweep,
                    "--mesh": lambda dev: phase_mesh(dev, ROOT),
                    "--mesh-training": phase_mesh_training,
                    "--offline-simclusters": phase_offline_simclusters_alone,
                    "--offline-simclusters-2": phase_offline_part_two,
                    "--phoenix-training": phase_phoenix_training,
                    "--phoenix-moonlight": phase_phoenix_moonlight}
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--mesh-training-rank"]:
        sys.exit(mt_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(child_main(CHILD_PHASES[sys.argv[1]]) if sys.argv[1:] and sys.argv[1] in CHILD_PHASES else main())
