"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip elsewhere. This file imports no JAX,
so it also runs on a machine without it, where ``tests/conftest.py`` (which
imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch
from torch_port_util import assert_same_topk, cuda_device  # noqa: F401

from the_algorithm_tpu_torch.data import foryou_world, sann_world
from the_algorithm_tpu_torch.graph import graphjet, uteg
from the_algorithm_tpu_torch.mixers import device_hydration as dh
from the_algorithm_tpu_torch.mixers import wide_hydrators as wh
from the_algorithm_tpu_torch.mixers.home_mixer import ForYouQuery
from the_algorithm_tpu_torch.ops import gather, seg_scan
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.search import earlybird
from the_algorithm_tpu_torch.simclusters import ann

pytestmark = pytest.mark.gpu


def _sums64(ids, vals):
    """Float64 run totals at each run's last slot of sorted [Q, W] rows, 0
    elsewhere and on PAD runs."""
    Q, W = ids.shape
    head = np.ones((Q, W), bool)
    head[:, 1:] = ids[:, 1:] != ids[:, :-1]
    last = np.ones((Q, W), bool)
    last[:, :-1] = head[:, 1:]
    last &= ids != PAD_ID
    run = np.cumsum(head.reshape(-1)) - 1  # every row starts a run
    return [np.where(last, np.bincount(run, weights=v.reshape(-1).astype(np.float64))[run].reshape(Q, W), 0.0)
            for v in vals]


def _collapse_rows(rng, Q, W, tile):
    """Sorted rows, by q % 5: runs of one tile's length that cross every tile
    edge, random runs with a PAD tail, one run over the whole row, random
    runs, all PAD."""
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
    return ids


# (Q, W, pointer offset in slots): W at 1 and 3 slots, around a tile (the
# unaligned W = 3 and 4,097 take the kernel's scalar head and tail), around
# one pass of a full cluster (5 rows get 8 CTAs each), at SANN and at ten
# times it; one row and 1,000 rows (one CTA each); an offset of 1 slot puts
# every row off 16-byte alignment; UTEG's [32, 256] (clusters of 5 CTAs of
# one warp) and UTG's [256, 4,096] (one CTA a row, two passes)
_REACH = seg_scan.MAX_CLUSTER * seg_scan.SHAPE.tile_max
COLLAPSE_CASES = [(5, 1, 0), (5, 3, 0), (5, 2048, 0), (5, 4095, 0), (5, 4096, 0), (5, 4097, 0),
                  (5, _REACH - 1, 0), (5, _REACH + 1, 0), (5, 20_000, 0), (5, 200_000, 0), (1, 20_000, 0),
                  (1000, 4097, 0), (5, 20_000, 1), (32, 256, 0), (256, 4096, 0)]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("Q,W,offset", COLLAPSE_CASES)
def test_run_collapse_kernel_matches_plain(cuda_device, k, Q, W, offset):
    rng = np.random.default_rng(W + k + Q)
    plan = seg_scan._plan(Q, W, k, torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    ids = _collapse_rows(rng, Q, W, plan.tile)
    vals = [rng.random((Q, W)).astype(np.float32) for _ in range(k)]

    def on_card(a):  # contiguous, `offset` slots into its storage
        t = torch.empty(a.size + offset, dtype=torch.from_numpy(a).dtype, device=cuda_device)
        t = t[offset:].view(a.shape)
        t.copy_(torch.from_numpy(a))
        return t

    args = [on_card(a) for a in (ids, *vals)]
    before = seg_scan.run_collapse_sorted.launches
    got = seg_scan.run_collapse_sorted(*args)
    torch.cuda.synchronize()
    assert seg_scan.run_collapse_sorted.launches == before + 1
    want = seg_scan.run_collapse_sorted_plain(*args)
    assert torch.equal(got[0], want[0])  # both fill run ends
    # run totals against float64: a 200,000-term run sums to ~1e5, where two
    # f32 summation orders may differ by more than 1e-5
    for g, w in zip(got[1:], _sums64(ids, vals)):
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=1e-5, atol=1e-6)


def test_row_gather_kernel_matches_plain_on_both_access_widths(cuda_device):
    rng = np.random.default_rng(2)
    R = 1000
    wide = [  # 16-byte rows: the SANN layout
        torch.from_numpy(rng.integers(0, 1 << 30, size=(R, 400)).astype(np.int32)),
        torch.from_numpy(rng.standard_normal((R, 400)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 1 << 30, size=(R, 400)).astype(np.int32)),
    ]
    narrow = [  # 28- and 12-byte rows: 4-byte words only
        torch.from_numpy(rng.standard_normal((R, 7)).astype(np.float32)),
        torch.from_numpy(rng.integers(-5, 5, size=(R, 3)).astype(np.int32)),
    ]
    ids = torch.from_numpy(rng.integers(0, R, size=(50, 37)).astype(np.int32)).to(cuda_device)
    for group in (wide, narrow):
        group = [t.to(cuda_device) for t in group]
        before = gather.row_gather.launches
        got = gather.row_gather(ids, *group)
        torch.cuda.synchronize()
        assert gather.row_gather.launches == before + 1
        for g, w in zip(got, gather.row_gather_plain(ids, *group)):
            assert g.shape == w.shape and torch.equal(g, w)


def _table(rng, R, cols, dtype):
    if dtype == np.int32:
        return torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, size=(R, cols)).astype(np.int32))
    return torch.from_numpy(rng.standard_normal((R, cols)).astype(dtype))


# (R, [(columns, dtype) per table], B, ids, path): edge cases of both kernels'
# launch plans; ids "rand" draw with repeats, "same" are all one row
SANN = [(400, np.int32), (400, np.float32), (400, np.int32)]
GATHER_CASES = {
    "B=1": (1000, SANN, 1, "rand", "ring"),
    "B below one stage": (1000, [(4, np.float32)], 5, "rand", "ring"),
    "B not a multiple of rows_per_stage": (1000, SANN, 12_805, "rand", "ring"),
    "B far above the grid": (1000, SANN, 100_000, "rand", "ring"),
    "all ids equal": (1000, [(400, np.int32), (400, np.float32)], 4096, "same", "ring"),
    "k=1": (500, [(128, np.float32)], 3000, "rand", "ring"),
    "k=2, two widths": (500, [(4, np.float32), (64, np.int32)], 3000, "rand", "ring"),
    "k=3, three widths": (500, [(12, np.int32), (400, np.float32), (4, np.float64)], 3000, "rand", "ring"),
    "16-byte row": (100_000, [(4, np.float32)], 262_144, "rand", "ring"),
    "32 KB rows, many": (64, [(8192, np.float32)], 2000, "rand", "ring"),
    "row wider than a stage, B=1": (64, [(32_768, np.float32)], 1, "rand", "ring"),
    "row wider than a stage": (64, [(32_768, np.float32)], 300, "rand", "ring"),
    "wide row beside narrow ones": (64, [(4, np.int32), (32_768, np.float32), (100, np.float32)], 77,
                                    "rand", "ring"),
    "wide rows, every CTA wraps its ring": (64, [(32_768, np.float32)], 132 * 8, "rand", "ring"),
    "wide rows, all ids equal": (64, [(16_400, np.float32), (16_400, np.int32)], 50, "same", "ring"),
    "4-byte words, k=3": (1000, [(7, np.float32), (3, np.int32), (45, np.float32)], 20_001, "rand", "words"),
    "4-byte words, one word": (1000, [(1, np.float32)], 5000, "rand", "words"),
    "4-byte words, wide rows": (64, [(32_769, np.float32)], 100, "rand", "words"),
    "UTEG seed fetch, 128-byte rows": (16_384, [(32, np.int32)] * 3, 256, "rand", "ring"),
    "UTG two-hop fetch, 128-byte rows": (16_384, [(32, np.int32)] * 2, 32_768, "rand", "ring"),
    "UTG source fetch, 512-byte rows": (32_768, [(128, np.int32)] * 2, 256, "rand", "ring"),
}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_row_gather_kernel_matches_plain_at_plan_edges(cuda_device, case):
    R, widths, B, kind, path = GATHER_CASES[case]
    rng = np.random.default_rng(len(case))
    tables = [_table(rng, R, cols, dt).to(cuda_device) for cols, dt in widths]
    ids_np = np.full(B, R // 2, np.int32) if kind == "same" else rng.integers(0, R, size=B).astype(np.int32)
    ids = torch.from_numpy(ids_np).to(cuda_device)
    row_bytes = [t.shape[1] * t.element_size() for t in tables]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = gather._plan(row_bytes, [t.data_ptr() for t in tables], B, sms)
    assert plan.path == path
    if path == "ring":
        r = plan.rows_per_stage
        units = -(-B // r) if r else B * sum(-(-b // plan.piece) for b in row_bytes)
        if case == "B below one stage":
            assert B * sum(row_bytes) < gather.RING.stage_bytes
        if case == "B not a multiple of rows_per_stage":
            assert r > 1 and B % r != 0
        if case in ("B far above the grid", "wide rows, every CTA wraps its ring"):
            assert units > 4 * plan.grid * plan.stages  # every CTA reuses each stage many times
        if case.startswith("row wider") or case.startswith("wide row") or case == "32 KB rows, many":
            assert r == 0 and units > len(tables) * B  # rows split into pieces
    before = gather.row_gather.launches
    got = gather.row_gather(ids, *tables)
    torch.cuda.synchronize()
    assert gather.row_gather.launches == before + 1
    for g, w in zip(got, gather.row_gather_plain(ids, *tables)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))


def test_row_gather_rejects_rows_it_cannot_copy_in_words(cuda_device):
    t = torch.zeros(10, 7, dtype=torch.bfloat16, device=cuda_device)  # 14-byte rows
    with pytest.raises(ValueError):
        gather.row_gather(torch.zeros(3, dtype=torch.int32, device=cuda_device), t)


def test_sann_batch_on_the_card_matches_the_cpu(cuda_device):
    shape = sann_world.WorldShape(n_comm=16, cpc=60, M=40, N=10, X=30, T=20_000, KT=8, Q=16)
    tweet_ids, tweet_scores, _, comm = sann_world.build_corpus(shape)
    index_np = sann_world.build_index(shape, tweet_ids, tweet_scores)
    q_ids, q_scores = sann_world.draw_queries(shape, comm)
    cfg = ann.SimClustersANNConfig(max_scan_clusters=shape.N, max_top_tweets_per_cluster=shape.M,
                                   max_num_results=shape.X)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        index = ClusterTweetIndex(*(torch.from_numpy(a).to(dev) for a in index_np))
        src = SparseEmbedding(torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_scores).to(dev))
        out[dev.type] = [t.cpu().numpy() for t in ann.get_tweet_candidates_batch(index, src, cfg)]
    assert_same_topk(*out["cuda"], *out["cpu"])


def test_candidate_sources_on_the_card_match_the_cpu(cuda_device):
    """The earlybird in-network scan, UTEG and UTG on a small For You world.
    Earlybird's float32 sums run in another order on each device, so its
    lists agree as score-aligned sets (rtol 1e-5, atol 1e-5); the graph
    scores are exact sums and one division: ids (in order) and counts equal
    the CPU run's, scores rtol 1e-5."""
    shape = foryou_world.ForYouShape(num_users=2048, num_authors=256, eb_docs=16_384, tweet_space=4096,
                                     utg_sources=64)
    world = foryou_world.build(shape, users=8)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        graph = foryou_world.engagement_graph(world, dev)
        right = foryou_world.right_index(world, dev)
        ids, scores = earlybird.search_in_network_batch(
            foryou_world.earlybird_index(world, dev), foryou_world.in_network_query().to(dev),
            torch.from_numpy(world.follows).to(dev), max_results=300)
        seeds = torch.from_numpy(world.seeds[:8]).to(dev)
        rec = uteg.recommend(graph, seeds, torch.ones(seeds.shape, device=dev), max_results=400)
        rel = graphjet.related_tweets(graph, right, torch.from_numpy(world.utg_sources).to(dev), max_results=200)
        out[dev.type] = [[t.cpu() for t in r] for r in ((ids, scores), rec, rel)] + [[t.cpu() for t in graph + right]]
    (ids, scores), (want_ids, want_scores) = out["cuda"][0], out["cpu"][0]
    assert_same_topk(ids.numpy(), scores.numpy(), want_ids.numpy(), want_scores.numpy(), rtol=1e-5, atol=1e-5)
    for got, want in zip(out["cuda"][1:], out["cpu"][1:]):
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
        for g, w in zip(got[2:], want[2:]):
            assert torch.equal(g, w)


def _hydration_batch(dev, R=3, PB=128):
    """A small hydration world built on the CPU and copied to ``dev``, and R
    columnar requests of PB slots (PAD slots after the candidates, unknown
    authors among them)."""
    world = wh.synthetic_world(seed=3, num_users=40, num_authors=48, num_tweets=4096, engagement_width=8, device="cpu")
    tables, fns, res = dh.build_from_world(world, world.pop("device_spec"))
    tables = tables.to(dev)
    builder = dh.HostRequestBuilder(res, pad_b=PB)
    rng = np.random.default_rng(5)
    reqs = []
    for r in range(R):
        n = 50 + 30 * r
        ids = rng.integers(0, 1 << 20, n)
        authors = np.where(rng.random(n) < 0.1, -1, ids % 48)
        cols = {"ids": ids, "author_id": authors, "created_ts": 10_000_000 - ids % 86400, "topic_id": ids % 16,
                "source_idx": rng.integers(-1, 72, n)}
        reqs.append(builder.build_columnar(ForYouQuery(user_id=7 * r, followed_authors=[1, 5, 9], now=10_000_000),
                                           cols, n))
    req = dh.batch_requests(reqs)
    return tables, fns, dh.DeviceRequests(*(torch.from_numpy(a).to(dev) for a in req)), builder.n_sources


def test_hydration_multiget_on_the_card_matches_the_cpu(cuda_device):
    """gather_rows through the row-gather kernel (packed aggregate stores)
    against the CPU's index_select: every row bit-exact; the assembled block
    at rtol 1e-5, atol 1e-6 (float32 sums in another order on each device)."""
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        tables, fns, req, n_sources = _hydration_batch(dev)
        agg = tables.agg_packed
        before = gather.row_gather.launches
        rows = dh.gather_rows(tables, req, agg_packed=agg)
        launches = gather.row_gather.launches - before
        x = dh.assemble(tables, fns, req, n_sources=n_sources, agg_packed=agg)
        out.append((rows, x.cpu(), launches))
    (want_rows, want_x, _), (rows, x, launches) = out
    assert launches == 15  # the keyed groups in launches of <= 3 tables, and the packed stores in 2

    def flat(d):
        for k, v in sorted(d.items()):
            if isinstance(v, dict):
                yield from flat(v)
            elif isinstance(v, tuple):
                yield from v
            else:
                yield v

    for g, w in zip(flat(rows), flat(want_rows)):
        assert torch.equal(g.cpu(), w)
    torch.testing.assert_close(x, want_x, rtol=1e-5, atol=1e-6)


def test_row_gather_at_the_hydration_groups_matches_index_select(cuda_device):
    """Each launch the multiget makes on the hydration tables: the 16-byte
    groups on the TMA ring, the groups holding a 4-byte row on the word
    kernel, every row bit-exact against index_select."""
    tables, _, _, _ = _hydration_batch(cuda_device)
    rng = np.random.default_rng(6)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    agg = tables.agg_packed
    groups = [g for _, g in sorted(dh.keyed_table_plan(tables).items())] + [{"av": agg.values, "al": agg.last_ts}]
    paths = []
    for group in groups:
        flat = {n: dh._as_rows(t) for n, t in group.items()}
        for names in dh.launch_groups(flat):
            tabs = [flat[n] for n in names]
            ids = torch.from_numpy(rng.integers(0, tabs[0].shape[0], 3 * 128).astype(np.int32)).to(cuda_device)
            plan = gather._plan([t.shape[1] * t.element_size() for t in tabs], [t.data_ptr() for t in tabs],
                                ids.numel(), sms)
            paths.append(plan.path)
            assert plan.path == ("ring" if all(dh._ring_rows(t) for t in tabs) else "words")
            for g, w in zip(gather.row_gather(ids, *tabs), gather.row_gather_plain(ids, *tabs)):
                assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    assert paths.count("words") == 3 and len(paths) == 15
