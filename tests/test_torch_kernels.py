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
from the_algorithm_tpu_torch.ops import gather, id_sort, retrieval, seg_scan
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.search import earlybird
from the_algorithm_tpu_torch.simclusters import ann
from the_algorithm_tpu_torch.simclusters import index_generation as ig

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


@pytest.mark.parametrize("k", [1, 2, 3, 4])
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


INT_MIN = -(2**31)
SORT_KINDS = 8  # row kinds of _sort_rows, by q % 8


def _sort_rows(rng, Q, W):
    """[Q, W] int32 ids, by q % 8: SANN-like ids below 2M with repeats and a
    PAD_ID tail, one id repeated, only PAD_ID, negative ids with INT_MIN
    among them, descending ids, any int32 with repeats, ids that differ in
    their top byte only, and few distinct ids (long runs)."""
    ids = np.empty((Q, W), np.int32)
    for q in range(Q):
        kind = q % SORT_KINDS
        if kind == 0:
            row = rng.integers(0, 2_000_000, size=W)
            row[rng.random(W) < 0.1] = PAD_ID
        elif kind == 1:
            row = np.full(W, rng.integers(INT_MIN, 2**31))
        elif kind == 2:
            row = np.full(W, PAD_ID)
        elif kind == 3:
            row = rng.integers(INT_MIN, 0, size=W)
            row[rng.random(W) < 0.05] = INT_MIN
            row[rng.random(W) < 0.05] = -1
        elif kind == 4:
            row = np.sort(rng.integers(INT_MIN, 2**31, size=W))[::-1]
        elif kind == 5:
            row = rng.integers(INT_MIN, 2**31, size=W)
            row[rng.random(W) < 0.3] = row[0]
        elif kind == 6:
            row = rng.integers(-128, 128, size=W) << 24
        else:
            row = rng.integers(0, 7, size=W) * 1000 - 3000
        ids[q] = row.astype(np.int64).astype(np.int32)
    return ids


def _bits(rng, Q, W):
    """float32 [Q, W] of any 32-bit pattern: -0.0, NaNs with payloads,
    infinities and denormals among them."""
    words = rng.integers(INT_MIN, 2**31, size=(Q, W)).astype(np.int32)
    words[:, ::7] = np.int32(INT_MIN)  # -0.0
    words[:, 3::11] = np.int32(0x7FC01234)  # a quiet NaN with a payload
    words[:, 5::13] = np.int32(-0x3FFFFF)  # 0xffc00001: a negative NaN with a payload
    return words.view(np.float32)


# (Q, W, k): the callers' shapes (SANN single-device and merge, UTEG, UTG,
# Home's single SANN query and UTEG families), every k, each thread tile,
# W = W_MAX, W that fill no warp evenly, one and three slots
SORT_CASES = [(1024, 20_000, 2), (256, 20_000, 2), (32, 256, 2), (256, 4096, 1), (1, 20_000, 2), (1, 512, 2),
              (1, 1536, 2), (1, 2048, 2), (1, 4096, 1), (16, 4096, 3), (16, 4096, 4), (16, 20_000, 4),
              (8, id_sort.W_MAX, 2), (8, id_sort.W_MAX - 1, 1), (16, 12_345, 3), (16, 8_193, 2), (16, 4_097, 1),
              (16, 1_000, 2), (16, 33, 4), (16, 3, 1), (16, 1, 2)]


@pytest.mark.parametrize("Q,W,k", SORT_CASES)
def test_sort_kernel_equals_the_stable_sort_bit_for_bit(cuda_device, Q, W, k):
    rng = np.random.default_rng(Q * 7 + W + k)
    ids = torch.from_numpy(_sort_rows(rng, Q, W)).to(cuda_device)
    vals = [torch.from_numpy(_bits(rng, Q, W)).to(cuda_device) for _ in range(k)]
    before = id_sort.sort_by_id.launches
    got = id_sort.sort_by_id(ids, *vals)
    torch.cuda.synchronize()
    assert id_sort.sort_by_id.launches == before + 1
    want = id_sort.sort_by_id_plain(ids, *vals)  # torch.sort(stable=True) + take_along_dim, on the card
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32 and torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("W", [20_000, 4096])
def test_sort_kernel_on_rows_not_16_byte_aligned(cuda_device, W):
    """Contiguous rows one word off 16-byte alignment take the kernel's
    4-byte copies; bit-equal all the same."""
    rng = np.random.default_rng(W)
    Q = 8
    ids = torch.from_numpy(_sort_rows(rng, Q, W)).to(cuda_device)
    vals = [torch.empty(Q * W + 1, device=cuda_device)[1:].view(Q, W).copy_(torch.from_numpy(_bits(rng, Q, W)))
            for _ in range(2)]
    before = id_sort.sort_by_id.launches
    got = id_sort.sort_by_id(ids, *vals)
    torch.cuda.synchronize()
    assert id_sort.sort_by_id.launches == before + 1
    want = id_sort.sort_by_id_plain(ids, *vals)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_sort_rows_past_w_max_take_the_stable_sort(cuda_device):
    rng = np.random.default_rng(5)
    W = id_sort.W_MAX + 1
    ids = torch.from_numpy(_sort_rows(rng, 8, W)).to(cuda_device)
    vals = torch.from_numpy(_bits(rng, 8, W)).to(cuda_device)
    before = id_sort.sort_by_id.launches
    got = retrieval.sort_by_id(ids, vals)
    torch.cuda.synchronize()
    assert id_sort.sort_by_id.launches == before
    want = id_sort.sort_by_id_plain(ids, vals)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def test_sort_kernel_raises_on_what_it_does_not_take(cuda_device):
    ids = torch.zeros((4, 64), dtype=torch.int32, device=cuda_device)
    v = torch.zeros((4, 64), device=cuda_device)
    for bad in ((ids, v.double()), (ids, v[:, :32]), (ids.t().contiguous().t(), v), (ids, v.t().contiguous().t()),
                (ids.long(), v)):
        with pytest.raises(ValueError):
            id_sort.sort_by_id(*bad)


def test_served_sann_lists_equal_the_stable_sort_path(cuda_device, monkeypatch):
    """One SANN batch through the kernel and through torch.sort +
    take_along_dim: equal ids reach the collapse in one order, so the
    served ids and scores are the same bits."""
    shape = sann_world.WorldShape(n_comm=16, cpc=60, M=40, N=10, X=30, T=20_000, KT=8, Q=64)
    tweet_ids, tweet_scores, _, comm = sann_world.build_corpus(shape)
    index_np = sann_world.build_index(shape, tweet_ids, tweet_scores)
    q_ids, q_scores = sann_world.draw_queries(shape, comm)
    cfg = ann.SimClustersANNConfig(max_scan_clusters=shape.N, max_top_tweets_per_cluster=shape.M,
                                   max_num_results=shape.X)
    index = ClusterTweetIndex(*(torch.from_numpy(a).to(cuda_device) for a in index_np))
    src = SparseEmbedding(torch.from_numpy(q_ids).to(cuda_device), torch.from_numpy(q_scores).to(cuda_device))
    before = id_sort.sort_by_id.launches
    got = ann.get_tweet_candidates_batch(index, src, cfg)
    torch.cuda.synchronize()
    assert id_sort.sort_by_id.launches == before + 1
    monkeypatch.setattr(id_sort, "engages", lambda *a: False)
    want = ann.get_tweet_candidates_batch(index, src, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


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
    # offline SimClusters part 2: the InterestedIn join / RMS multiget (K = 50:
    # 200-byte rows), the eigen matvec (k = 8: 32-byte rows), the IVF member
    # vectors (D = 128: 512-byte rows)
    "InterestedIn join, 200-byte rows": (65_536, [(50, np.int32), (50, np.float32)], 40_000, "rand", "words"),
    "eigen matvec, 32-byte rows": (4096, [(8, np.float32)], 4096 * 64, "rand", "ring"),
    "IVF member vectors, 512-byte rows": (262_144, [(128, np.float32)], 8 * 1100, "rand", "ring"),
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


def test_hashed_lr_gradient_through_the_kernels(cuda_device):
    """The light ranker's step at its shape (1,024 examples × 40 features
    into 2**18 buckets): the forward reads the weights in one row_gather
    launch, the backward sums their gradient in one run_collapse launch; the
    gradient is bit-equal across two runs, and its sums equal the plain
    accumulating scatter (``index_put_(accumulate=True)``, what autograd of
    ``weights[idx]`` does) of the same contributions within rtol 1e-6 and
    1e-6 of the largest entry (f32 sums of ~64 terms in another order)."""
    from the_algorithm_tpu_torch.models import light_ranker
    from the_algorithm_tpu_torch.ops import hashed_lr

    rng = np.random.default_rng(7)
    B, W, N = 1024, 40, 1 << 18
    # 40 features × 16 bins: ~64 examples share each (feature, bin) bucket
    idx = torch.from_numpy(rng.integers(0, 40 * 16, (B, W)).astype(np.int32) * 409 % N).to(cuda_device)
    vals = torch.ones(B, W, device=cuda_device)
    batch = hashed_lr.SparseBatch(idx, vals, torch.ones(B, W, dtype=torch.bool, device=cuda_device))
    y = torch.from_numpy((rng.random(B) < 0.3).astype(np.float32)).to(cuda_device)
    params = light_ranker.init_params(light_ranker.LightRankerConfig(), device=cuda_device)
    with torch.no_grad():
        params.weights.copy_(torch.from_numpy(rng.normal(size=N).astype(np.float32) * 0.1))
    grads = []
    for _ in range(2):
        params.zero_grad()
        g0, s0 = gather.row_gather.launches, seg_scan.run_collapse_sorted.launches
        light_ranker.loss_fn(params, batch, y).backward()
        torch.cuda.synchronize()
        assert (gather.row_gather.launches - g0, seg_scan.run_collapse_sorted.launches - s0) == (1, 1)
        grads.append(params.weights.grad.clone())
    assert torch.equal(grads[0], grads[1])
    with torch.no_grad():
        dl = ((torch.sigmoid(light_ranker.logits_fn(params, batch)) - y) / B)[:, None].contiguous()
    got = hashed_lr.weight_grad(idx, vals, dl, N)
    want = torch.zeros(N, 1, device=cuda_device).index_put_((idx.reshape(-1).long(),), (vals * dl).reshape(-1, 1),
                                                            accumulate=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


def test_kernels_at_the_tweet_mixer_per_query_shapes(cuda_device):
    """One Home request's kernel shapes: a SANN query's sorted entries
    ([1, 20,000], two sums), its cluster-row fetch (50 rows x 3 tables of
    1,600 B) and the dense lookups' 512-byte rows (TwHIN / two-tower, one
    row and 16 rows) against the plain versions: the same (row, id) slots
    with sums at rtol 1e-5 / atol 1e-6, rows bit-exact."""
    rng = np.random.default_rng(8)
    ids = np.sort(rng.integers(0, 9000, (1, 20_000)).astype(np.int32), axis=1)
    ids[0, -700:] = PAD_ID
    vals = [torch.from_numpy(rng.uniform(0, 1, ids.shape).astype(np.float32)).to(cuda_device) for _ in range(2)]
    entries = (torch.from_numpy(ids).to(cuda_device), *vals)
    got, want = seg_scan.run_collapse_sorted(*entries), seg_scan.run_collapse_sorted_plain(*entries)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)

    C, M = 5000, 400
    tables = (torch.from_numpy(rng.integers(0, 1 << 21, (C, M)).astype(np.int32)).to(cuda_device),
              torch.from_numpy(rng.random((C, M)).astype(np.float32)).to(cuda_device),
              torch.zeros((C, M), dtype=torch.int32, device=cuda_device))
    dense = torch.from_numpy(rng.normal(size=(100_000, 128)).astype(np.float32)).to(cuda_device)
    for rows, tabs in ((rng.integers(0, C, 50), tables), (rng.integers(0, 100_000, 1), (dense,)),
                       (rng.integers(0, 100_000, 16), (dense,))):
        r = torch.from_numpy(rows.astype(np.int32)).to(cuda_device)
        for g, w in zip(gather.row_gather(r, *tabs), gather.row_gather_plain(r, *tabs)):
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))


def test_home_product_on_the_card_matches_the_cpu(cuda_device):
    """tweet-mixer's Home product on a small world: each of the 20
    pipelines' lists on the card against the same world moved to the CPU
    (score-aligned sets, rtol 1e-5, atol 1e-5: float32 sums in another
    order), non-empty, and one request's launches equal to the count from
    the routed pipelines."""
    from the_algorithm_tpu_torch.data import tweet_mixer_world as tmw
    from the_algorithm_tpu_torch.mixers import candidate_pipeline_catalog as cat
    from the_algorithm_tpu_torch.mixers import tweet_mixer_products as tmp

    shape = tmw.TweetMixerShape(
        sann=sann_world.WorldShape(n_comm=8, cpc=64, M=40, N=10, X=50, T=8192, KT=8, Q=32),
        foryou=foryou_world.ForYouShape(num_users=512, num_authors=128, eb_docs=4096, tweet_space=4096, follows=12,
                                        follow_width=16, utg_width=32, utg_sources=16),
        embed_dim=128, users=4)
    card = tmw.build(shape, device=cuda_device)
    home = tmp.TweetMixerProduct.HOME_RECOMMENDED_TWEETS
    lists = {}
    for w in (card, card.to("cpu")):
        catalog = cat.build_catalog(w.source_world())
        for q in w.queries:
            for pipe in tmp.product_pipelines(catalog, home, q, tmp.Params()):
                lists.setdefault((q.user_id, pipe.name), []).append(pipe.source.get(q, tmp.Params()))
    assert len(lists) == 20 * shape.users
    for got, want in lists.values():
        assert want and len(got) == len(want)
        assert_same_topk(np.array([[c.id for c in got]]), np.array([[c.score for c in got]], np.float32),
                         np.array([[c.id for c in want]]), np.array([[c.score for c in want]], np.float32),
                         rtol=1e-5, atol=1e-5)
    catalog = cat.build_catalog(card.source_world())
    q = card.queries[0]
    names = [s.name for s, p in catalog if p in tmp.product_pipelines(catalog, home, q, tmp.Params())]
    g0, s0 = gather.row_gather.launches, seg_scan.run_collapse_sorted.launches
    assert tmp.run_product(catalog, home, q)
    assert {"row_gather": gather.row_gather.launches - g0,
            "run_collapse": seg_scan.run_collapse_sorted.launches - s0} == tmw.expected_launches(names, q)


# (n slots, N table rows, id draw, D, dy offset in floats): a two-tower batch
# of distinct users and items, TwHIN's 6-row relation table (runs of ~680
# slots), random repeats, a width off the 16-byte path (D = 13), a width of
# three 128-column chunks less one vector, and dy 4 bytes off 16-byte alignment;
# one run of 100,000 slots into one row (its parts summed over every resident
# CTA); every slot dropped; runs of thousands of slots across many CTAs' shares
# on both column paths; and merges of one CTA's least share of items
# (_rows_plan's ROWS_MIN_SHARE, slots + rows) and of one item less and more
COLLAPSE_ROWS_CASES = [(4096, 16_384, "distinct", 128, 0), (4096, 2_000_000, "distinct", 128, 0),
                       (4096, 6, "runs", 128, 0), (100_000, 1000, "random", 128, 0), (37, 50, "random", 13, 0),
                       (5000, 300, "random", 380, 0), (3000, 100, "random", 128, 1), (1, 1, "random", 4, 0),
                       (100_000, 1, "random", 128, 0), (5000, 100, "dropped", 128, 0),
                       (30_000, 7, "random", 380, 0), (30_000, 5, "random", 13, 0), (20_000, 3, "random", 128, 1),
                       *[(n, seg_scan.ROWS_MIN_SHARE - n + d, "random", 128, 0) for n in (1, 40) for d in (-1, 0, 1)]]


def _collapse_rows_case(rng, n, N, draw):
    """Sorted ids of a case, the stable sort's permutation, and the unsorted ids."""
    if draw == "distinct":
        ids = rng.permutation(N)[:n]
    elif draw == "dropped":  # every id outside [0, N)
        ids = rng.choice(np.array([-7, -1, N, N + 5, PAD_ID], np.int64), n)
    else:
        ids = rng.integers(0, N, n)
    ids = ids.astype(np.int32)
    if draw != "dropped":
        ids[rng.random(n) < 0.05] = PAD_ID
        if n > 3:
            ids[:3] = [-1, N, N + 5]
    perm = np.argsort(ids, kind="stable")
    return ids[perm], perm, ids


@pytest.mark.parametrize("n,N,draw,D,offset", COLLAPSE_ROWS_CASES)
def test_run_collapse_rows_kernel_matches_plain(cuda_device, n, N, draw, D, offset):
    """The D-wide collapse against float64 run sums, as is its plain
    version on the card and on the CPU: each an f32 sum of a run's m terms,
    within m·2⁻²⁴ of the sum of their magnitudes (the bound of any order of
    summation); bit-equal run to run; one launch a call; ids past the table
    and PAD_ID dropped; a row no slot names exactly 0."""
    rng = np.random.default_rng(n + N + D)
    sorted_ids, perm, ids = _collapse_rows_case(rng, n, N, draw)
    dy_np = rng.normal(size=(n, D)).astype(np.float32)
    buf = torch.empty(n * D + offset, device=cuda_device)
    dy = buf[offset:].view(n, D)
    dy.copy_(torch.from_numpy(dy_np))
    args = (torch.from_numpy(sorted_ids).to(cuda_device), torch.from_numpy(perm).to(cuda_device), dy, N)
    before = seg_scan.run_collapse_rows.launches
    got = seg_scan.run_collapse_rows(*args)
    again = seg_scan.run_collapse_rows(*args)
    torch.cuda.synchronize()
    assert seg_scan.run_collapse_rows.launches == before + 2
    assert got.shape == (N, D) and torch.equal(got, again)
    keep = (ids >= 0) & (ids < N)
    want = np.zeros((N, D))
    magnitude = np.zeros((N, D))
    np.add.at(want, ids[keep], dy_np[keep].astype(np.float64))
    np.add.at(magnitude, ids[keep], np.abs(dy_np[keep]).astype(np.float64))
    terms = np.bincount(ids[keep], minlength=N)[:, None]
    bound = terms * 2.0 ** -24 * magnitude + 1e-30
    for side in (got.cpu(), seg_scan.run_collapse_rows_plain(*args).cpu(),
                 seg_scan.run_collapse_rows_plain(*(a.cpu() if torch.is_tensor(a) else a for a in args))):
        assert (np.abs(side.numpy() - want) <= bound).all()
    assert (got.cpu().numpy()[terms[:, 0] == 0] == 0.0).all()


def busy_stream(device, ms: float = 50.0):
    """A second stream of this process kept busy with f32 products over
    every SM for about ``ms`` (its work is returned, so it stays alive)."""
    side = torch.cuda.Stream(device)
    a = torch.randn(4096, 4096, device=device)
    torch.cuda.synchronize(device)
    out = []
    with torch.cuda.stream(side):
        for _ in range(max(1, int(ms / 2))):  # ~2 ms a 4,096³ product at f32
            out.append(a @ a)
    return side, out


@pytest.mark.parametrize("n,N,draw,D,offset", COLLAPSE_ROWS_CASES)
def test_run_collapse_rows_beside_a_busy_stream(cuda_device, n, N, draw, D, offset):
    """Fault 6: the kernel's CTAs wait on earlier CTAs' flags, so all of its
    grid must be resident at once. The cooperative launch guarantees that:
    launched while another stream of the process fills the card, the call
    finishes and gives the bits of a quiet run."""
    rng = np.random.default_rng(n + N + D)
    sorted_ids, perm, _ = _collapse_rows_case(rng, n, N, draw)
    buf = torch.empty(n * D + offset, device=cuda_device)
    dy = buf[offset:].view(n, D)
    dy.copy_(torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32)))
    args = (torch.from_numpy(sorted_ids).to(cuda_device), torch.from_numpy(perm).to(cuda_device), dy, N)
    quiet = seg_scan.run_collapse_rows(*args)
    torch.cuda.synchronize()
    side, work = busy_stream(cuda_device)
    busy = seg_scan.run_collapse_rows(*args)  # the default stream, beside the products
    assert not side.query()  # the other stream was still busy at the launch
    torch.cuda.synchronize()
    assert torch.equal(busy.view(torch.int32), quiet.view(torch.int32))
    del work


@pytest.mark.parametrize("n,N,draw", [(4096, 2_000_000, "distinct"), (4096, 6, "runs"), (5000, 100, "dropped")])
def test_run_collapse_rows_writes_zeros_over_dirty_memory(cuda_device, monkeypatch, n, N, draw):
    """The kernel writes every row, the untouched ones as 0.0, whatever the
    allocator hands back: a block of the output's size is filled with NaN
    and freed just before the call (no torch.zeros fill first, at any size)."""
    monkeypatch.setattr(seg_scan, "FILL_BYTES", None)
    rng = np.random.default_rng(n + N)
    sorted_ids, perm, ids = _collapse_rows_case(rng, n, N, draw)
    args = (torch.from_numpy(sorted_ids).to(cuda_device), torch.from_numpy(perm).to(cuda_device),
            torch.from_numpy(rng.normal(size=(n, 128)).astype(np.float32)).to(cuda_device), N)
    dirty = torch.full((N, 128), float("nan"), device=cuda_device)
    del dirty
    got = seg_scan.run_collapse_rows(*args)
    torch.cuda.synchronize()
    named = np.zeros(N, bool)
    named[ids[(ids >= 0) & (ids < N)]] = True
    assert torch.isfinite(got).all()
    assert (got[torch.from_numpy(~named).to(cuda_device)] == 0.0).all()
    assert torch.equal(got, seg_scan.run_collapse_rows(*args))


def test_table_read_gradient_on_the_card_matches_the_cpu(cuda_device):
    """A two-tower step's table gradients through row_gather and the D-wide
    collapse: one launch of each a table read, the card against the CPU."""
    from the_algorithm_tpu_torch.models import two_tower

    rng = np.random.default_rng(11)
    users = rng.integers(-3, 70, 256).astype(np.int32)
    items = rng.integers(0, 500, 256).astype(np.int32)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        model = two_tower.TwoTower(two_tower.TwoTowerConfig(64, 500, 128, (128,)), device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(0))
        if grads:
            model.load_state_dict(ref)
        ref = {k: v.cpu() for k, v in model.state_dict().items()}
        g0, c0 = gather.row_gather.launches, seg_scan.run_collapse_rows.launches
        u, v = model(torch.from_numpy(users).to(dev), torch.from_numpy(items).to(dev))
        two_tower.in_batch_softmax_loss(u, v, 0.05, torch.from_numpy(items).to(dev)).backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (gather.row_gather.launches - g0, seg_scan.run_collapse_rows.launches - c0) == (2, 2)
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    for k in grads[1]:
        scale = float(grads[1][k].abs().max())
        np.testing.assert_allclose(grads[0][k].numpy(), grads[1][k].numpy(), rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_launch_counter_counts_every_thread(cuda_device):
    """8 threads launching row_gather at once: the counter gains exactly their
    launches (the recommendation engine launches from its pool threads)."""
    import threading

    from the_algorithm_tpu_torch import _build

    table = torch.arange(4096 * 64, dtype=torch.float32, device=cuda_device).reshape(4096, 64)
    ids = torch.arange(0, 4096, 7, dtype=torch.int32, device=cuda_device)
    want = gather.row_gather_plain(ids, table)[0]
    per_thread, threads = 200, 8
    start, errors = threading.Barrier(threads), []

    def launch():
        start.wait()
        for _ in range(per_thread):
            (got,) = gather.row_gather(ids, table)
            if not torch.equal(got, want):
                errors.append("row_gather disagreed with its plain version")

    before = _build.launches(gather.row_gather)
    workers = [threading.Thread(target=launch) for _ in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    torch.cuda.synchronize()
    assert not errors, errors[:1]
    assert _build.launches(gather.row_gather) - before == threads * per_thread


def test_index_job_collapse_row_matches_plain(cuda_device):
    """The index job's one [1, E·K] k = 1 row of dense run indices (runs of
    1 to ~40 slots) against the plain version and float64."""
    rng = np.random.default_rng(17)
    W = 1 << 20
    ids = np.cumsum(rng.random(W) < 0.3).astype(np.int32)[None] - 1
    vals = rng.random((1, W)).astype(np.float32)
    got = seg_scan.run_collapse_sorted(*(torch.from_numpy(a).to(cuda_device) for a in (ids, vals)))
    want = seg_scan.run_collapse_sorted_plain(*(torch.from_numpy(a) for a in (ids, vals)))
    assert torch.equal(got[0].cpu(), want[0])
    np.testing.assert_allclose(got[1].cpu().numpy(), _sums64(ids, [vals])[0], rtol=1e-5, atol=1e-6)


def test_index_job_on_the_card_matches_the_cpu(cuda_device):
    """The index job at a cut world: one row_gather and one run_collapse
    launch; the index equal to the CPU's (ids; scores rtol 1e-5), both held
    to float64."""
    from the_algorithm_tpu_torch import _build

    shape = sann_world.IndexJobShape(sann=sann_world.WorldShape(n_comm=16, cpc=64, M=40, N=10, X=50, T=1, KT=1, Q=1),
                                     users=1024, tweets=8192, events=16_384, K=10)
    w = sann_world.build_index_job_world(shape, seed=3)
    cfg = ig.IndexGenerationConfig(num_clusters=1024, num_tweets=8192, tweets_per_cluster=40)
    events = ig.EventLog(*map(torch.from_numpy, (w.user_rows, w.tweet_ids, w.event_type, w.timestamps)))
    ii = (torch.from_numpy(w.ii_ids), torch.from_numpy(w.ii_scores))
    torch.cuda.synchronize()
    g0, c0 = _build.launches(gather.row_gather), _build.launches(seg_scan.run_collapse_sorted)
    card = ig.generate_cluster_to_tweet_index(events.to(cuda_device), *(t.to(cuda_device) for t in ii), cfg, w.now)
    torch.cuda.synchronize()
    assert (_build.launches(gather.row_gather) - g0, _build.launches(seg_scan.run_collapse_sorted) - c0) == (1, 1)
    cpu = ig.generate_cluster_to_tweet_index(events, *ii, cfg, w.now)
    assert torch.equal(card.tweet_ids.cpu(), cpu.tweet_ids)
    np.testing.assert_allclose(card.scores.cpu().numpy(), cpu.scores.numpy(), rtol=1e-5)
    for index in (card, cpu):
        got = ig.compare_with_float64(index, events, w.ii_ids, w.ii_scores, cfg, w.now)
        assert got["far"] == 0 and got["out_of_order"] == 0 and got["max_rel_err"] <= 1e-5, got


def test_offline_part_two_on_the_card_matches_the_cpu(cuda_device):
    """RMS (cached), the wrapper source, the eigen solver, the IVF query and
    the entity embeddings on the card against the CPU, small."""
    from the_algorithm_tpu_torch.ann_lib import ClusteredScanIndex
    from the_algorithm_tpu_torch.core.config import Params
    from the_algorithm_tpu_torch.simclusters import candidate_source as cs
    from the_algorithm_tpu_torch.simclusters import entity_embeddings as ee
    from the_algorithm_tpu_torch.simclusters import evaluation as ev
    from the_algorithm_tpu_torch.simclusters import known_for as kf
    from the_algorithm_tpu_torch.simclusters import representation_manager as rm

    rng = np.random.default_rng(5)
    C, M, U, K = 256, 16, 64, 10
    index_np = (rng.integers(0, 5000, (C, M)).astype(np.int32), rng.random((C, M)).astype(np.float32),
                np.zeros((C, M), np.int32))
    ii_ids = np.stack([rng.choice(C, K, replace=False) for _ in range(U)]).astype(np.int32)
    ii_sc = rng.random((U, K)).astype(np.float32)
    eid = rm.EmbeddingId(rm.EmbeddingKind.FAV_BASED_USER_INTERESTED_IN, rm.EntityKind.USER)
    lists = []
    for dev in (cuda_device, torch.device("cpu")):
        rms = rm.RepresentationManager()
        rms.register(eid, rm.store_from_pairs(range(U), ii_ids, ii_sc, cached=True, device=dev))
        src = cs.SimClustersANNWrapperCandidateSource(
            rms, ClusterTweetIndex(*(torch.from_numpy(a).to(dev) for a in index_np)),
            cs.SimClustersANNWrapperConfig(embedding=eid, ann_config=ann.SimClustersANNConfig(
                max_scan_clusters=6, max_top_tweets_per_cluster=M, max_num_results=20)))
        lists.append([[(c.id, c.score) for c in src.get({"user_id": u}, Params())] for u in range(0, U, 7)])
    for a, b in zip(*lists):  # a tweet in one scanned cluster scores its cluster's cosine: ties
        assert len(a) == len(b)
        assert_same_topk(np.asarray([[t for t, _ in a]]), np.asarray([[x for _, x in a]], np.float32),
                         np.asarray([[t for t, _ in b]]), np.asarray([[x for _, x in b]], np.float32), rtol=1e-5)

    A = rng.random((128, 128)).astype(np.float32)
    A = (A + A.T) / 2 + 8 * np.eye(128, dtype=np.float32)
    g = kf.Graph(torch.from_numpy(np.tile(np.arange(128, dtype=np.int32), (128, 1))), torch.from_numpy(A))
    vals_card, q_card = ev.top_eigenvectors(g.to(cuda_device), 4, iterations=40)
    vals_cpu, q_cpu = ev.top_eigenvectors(g, 4, iterations=40)
    np.testing.assert_allclose(vals_card.cpu().numpy(), vals_cpu.numpy(), rtol=1e-4)
    np.testing.assert_allclose((q_card @ q_card.T).cpu().numpy(), (q_cpu @ q_cpu.T).numpy(), atol=1e-4)

    x = rng.normal(size=(4096, 128)).astype(np.float32)
    ivf = [ClusteredScanIndex(128, n_clusters=16, n_probes=4, device=d) for d in (cuda_device, "cpu")]
    for i in ivf:
        i.append(np.arange(4096), x)
        i.build()
    ivf[1]._load(ivf[0]._centroids.cpu(), ivf[0]._members.cpu().numpy())  # the card's cells on both
    got, want = ivf[0].query(x[:8], 10), ivf[1].query(x[:8], 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)

    ent = torch.from_numpy(rng.integers(0, 32, 2000).astype(np.int32))
    usr = torch.from_numpy(rng.integers(0, U, 2000).astype(np.int32))
    wts = torch.from_numpy(rng.random(2000).astype(np.float32))
    interests = SparseEmbedding(torch.from_numpy(ii_ids), torch.from_numpy(ii_sc))
    out = [ee.entity_embeddings_from_engagements(
        ent.to(d), usr.to(d), wts.to(d), SparseEmbedding(*(t.to(d) for t in interests)), num_entities=32,
        num_clusters=C, top_k=20) for d in (cuda_device, torch.device("cpu"))]
    assert_same_topk(out[0].ids.cpu().numpy(), out[0].scores.cpu().numpy(), out[1].ids.numpy(),
                     out[1].scores.numpy(), rtol=1e-5, atol=1e-7)
