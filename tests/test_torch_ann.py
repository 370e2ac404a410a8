"""Port SimClusters-ANN service (the_algorithm_tpu_torch/simclusters/ann.py)
against the JAX package's batched query path on the same seeded index.
Ids compare as score-aligned sets, scores at rtol 1e-5 (see
test_torch_retrieval.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_retrieval import make_index
from torch_port_util import assert_same_topk

from the_algorithm_tpu.ops import retrieval as jr
from the_algorithm_tpu.ops import sparse as js
from the_algorithm_tpu.simclusters import ann as jax_ann
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex, ScoringAlgorithm
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.simclusters import ann

C, M, Q, N_IN = 64, 16, 4, 12


def _sources(seed=2):
    """[Q, 12] embeddings in shuffled score order: the service truncates to N."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(C, size=N_IN, replace=False) for _ in range(Q)]).astype(np.int32)
    scores = rng.uniform(0.2, 1.0, size=(Q, N_IN)).astype(np.float32)
    scores[1, :4] = 0.5  # ties at the truncation boundary keep input order
    return ids, scores


def _index():
    ids, scores, _ = make_index(C=C, M=M)
    ts = np.random.default_rng(3).integers(0, 72 * 3600, size=(C, M))
    return ids, scores, ts.astype(np.int32)


CFG = dict(max_scan_clusters=8, max_top_tweets_per_cluster=12, max_num_results=20,
           min_score=0.1, max_tweet_candidate_age_hours=30, min_tweet_candidate_age_hours=2)


@pytest.mark.parametrize("now", [None, 40 * 3600])
def test_batch_matches_jax(now):
    index_np, src_np = _index(), _sources()
    cfg = ann.SimClustersANNConfig(scoring_algorithm=ScoringAlgorithm.LOG_COSINE, **CFG)
    got = ann.get_tweet_candidates_batch(
        ClusterTweetIndex(*(torch.from_numpy(a) for a in index_np)),
        SparseEmbedding(*(torch.from_numpy(a) for a in src_np)), cfg, now=now,
    )
    jcfg = jax_ann.SimClustersANNConfig(scoring_algorithm=jr.ScoringAlgorithm.LOG_COSINE, **CFG)
    want = jax_ann.get_tweet_candidates_batch(
        jr.ClusterTweetIndex(*(jnp.asarray(a) for a in index_np)),
        js.SparseEmbedding(*(jnp.asarray(a) for a in src_np)), jcfg,
        now=None if now is None else jnp.int32(now),
    )
    assert got[0].shape == (Q, 20)
    assert_same_topk(got[0].numpy(), got[1].numpy(), *(np.asarray(w) for w in want))
    assert (got[0] != PAD_ID).sum() > Q * 5  # neither filter emptied the lists


def test_single_query_with_exclusion_is_one_row_of_the_batch():
    index_np, src_np = _index(), _sources()
    index = ClusterTweetIndex(*(torch.from_numpy(a) for a in index_np))
    cfg = ann.SimClustersANNConfig(**CFG)
    batch_ids, batch_scores = ann.get_tweet_candidates_batch(
        index, SparseEmbedding(*(torch.from_numpy(a) for a in src_np)), cfg, now=40 * 3600)
    src = SparseEmbedding(torch.from_numpy(src_np[0][2]), torch.from_numpy(src_np[1][2]))
    ids, scores = ann.get_tweet_candidates(index, src, cfg, now=40 * 3600)
    assert torch.equal(ids, batch_ids[2]) and torch.equal(scores, batch_scores[2])
    best = int(ids[0])
    ex_ids, _ = ann.get_tweet_candidates(index, src, cfg, now=40 * 3600, exclude_tweet_id=best)
    assert best not in ex_ids.tolist()
    assert ex_ids[0] == ids[1]
