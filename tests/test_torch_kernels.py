"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip elsewhere. This file imports no JAX,
so it also runs on a machine without it, where ``tests/conftest.py`` (which
imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch
from torch_port_util import assert_same_collapse, assert_same_topk, collapse_to_dict, cuda_device  # noqa: F401

from the_algorithm_tpu_torch.data import sann_world
from the_algorithm_tpu_torch.ops import gather, seg_scan
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.simclusters import ann

pytestmark = pytest.mark.gpu


def _sums64(ids_row, vals_row):
    """{id: (float64 run totals...)} of one sorted row, PAD dropped."""
    out = {}
    for i, t in enumerate(ids_row):
        if t != PAD_ID:
            out[int(t)] = tuple(a + float(v[i]) for a, v in zip(out.get(int(t), (0.0,) * len(vals_row)), vals_row))
    return out


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("W", [1, 2048, 4096, 20_000])
def test_run_collapse_kernel_matches_plain(cuda_device, k, W):
    rng = np.random.default_rng(W + k)
    Q = 5
    # runs far longer than a 2,048-slot chunk, runs across chunk edges, a PAD tail
    ids = np.sort(rng.integers(0, max(1, W // 500), size=(Q, W)).astype(np.int32), axis=1)
    ids[1, -(W // 7 + 1):] = PAD_ID
    ids[2] = 5  # one run over the whole row
    vals = [rng.random((Q, W)).astype(np.float32) for _ in range(k)]
    args = [torch.from_numpy(a).to(cuda_device) for a in (ids, *vals)]
    before = seg_scan.run_collapse_sorted.launches
    got = seg_scan.run_collapse_sorted(*args)
    torch.cuda.synchronize()
    assert seg_scan.run_collapse_sorted.launches == before + 1
    want = seg_scan.run_collapse_sorted_plain(*args)
    assert torch.equal(got[0], want[0])  # both fill run ends
    empty = got[0] == PAD_ID
    assert all(bool((g[empty] == 0).all()) for g in got[1:])
    # run totals against float64: a 20,000-term run sums to ~1e4, where two
    # f32 summation orders may differ by more than 1e-5
    for q in range(Q):
        assert_same_collapse(
            collapse_to_dict(*(g[q].cpu() for g in got)),
            _sums64(ids[q], [v[q].astype(np.float64) for v in vals]),
            rtol=1e-5, atol=1e-6,
        )


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
