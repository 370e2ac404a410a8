"""The offline SimClusters jobs of the port (``simclusters/known_for.py``'s
iteration, ``interested_in.py``, ``producer_embeddings.py``) against the JAX
package's on the same numpy inputs: one ``update_iteration`` from JAX's
state on a graph of dyadic weights, where every sum is exact in any order
(cluster ids equal, scores within rtol 1e-6); a random-weight sweep held to
a float64 oracle (ids equal but where the oracle's best two scores lie
within 1e-5); ``iterate`` from JAX's initial KnownFor on the planted graph
of the JAX tests, with their recovery bounds; InterestedIn and the producer
matrix within stated bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.data import synthetic as jsyn
from the_algorithm_tpu.simclusters import interested_in as jii
from the_algorithm_tpu.simclusters import known_for as jkf
from the_algorithm_tpu.simclusters import producer_embeddings as jpe
from the_algorithm_tpu.simclusters import sims_graph as jsg
from the_algorithm_tpu_torch.data import synthetic
from the_algorithm_tpu_torch.simclusters import interested_in as ii
from the_algorithm_tpu_torch.simclusters import known_for as kf
from the_algorithm_tpu_torch.simclusters import producer_embeddings as pe

C = 64
NEAR_TIE = 1e-5


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.fixture(scope="module")
def planted():
    """The JAX tests' planted world (512 users, 128 producers, 8
    communities), its sims graph from the JAX package, and JAX's 6
    iterations from a JAX draw."""
    cfg = jsyn.CommunityGraphConfig(num_users=512, num_producers=128, num_communities=8, follows_per_user=24, seed=3)
    world = jsyn.community_graph(cfg)
    jg = jsg.symmetrize(jsg.cosine_similarity_graph(
        jsg.follow_matrix_from_adjacency(jnp.asarray(world.producer_ids), 128), top_k=16))
    init = jkf.initialize_random(jax.random.PRNGKey(0), 128, C)
    known = jkf.iterate(jg, init, jkf.KnownForParams(num_clusters=C), num_iterations=6)
    return world, jg, init, known


def _graphs(rng, P, D, dyadic):
    ids = np.stack([rng.choice(P, D, replace=False) for _ in range(P)]).astype(np.int32)
    ids[rng.random((P, D)) < 0.15] = PAD_ID
    if dyadic:
        w = (2.0 ** -rng.integers(0, 4, (P, D))).astype(np.float32)
    else:
        w = rng.random((P, D)).astype(np.float32)
    w[ids == PAD_ID] = 0.0
    return ids, w


def _state(rng, P, dyadic):
    cluster = rng.integers(-1, 12, P).astype(np.int32)  # few clusters: many candidates share one
    score = np.where(cluster >= 0, 1.0 if dyadic else rng.random(P), 0.0).astype(np.float32)
    return cluster, score


def _update64(ids, w, cluster, score, params):
    """float64 ``update_iteration``: per node, the eligible candidates' scores
    in ascending cluster order."""
    P, D = ids.shape
    valid = ids != PAD_ID
    assigned = cluster >= 0
    sizes = np.bincount(cluster[assigned], minlength=params.num_clusters).astype(np.float64)
    membs = np.bincount(cluster[assigned], weights=score[assigned].astype(np.float64), minlength=params.num_clusters)
    avg_w = w[valid].astype(np.float64).sum() / max(valid.sum(), 1)
    avg_m = score[assigned].astype(np.float64).sum() / max(assigned.sum(), 1)
    out = []
    for u in range(P):
        nb = ids[u][valid[u]]
        wu = w[u][valid[u]].astype(np.float64)
        nsc = np.where(cluster[nb] >= 0, score[nb].astype(np.float64), avg_m)
        sum_w, sum_mw = wu.sum(), (wu * nsc).sum()
        cands = []
        for c in sorted(set(cluster[nb][cluster[nb] >= 0].tolist())):
            m = cluster[nb] == c
            cnt, tp, mw_tp, sm = m.sum(), wu[m].sum(), (wu * nsc)[m].sum(), nsc[m].sum()
            if cnt < params.min_neighbors_in_cluster or len(nb) < params.min_neighbors_in_cluster:
                continue
            mw_fp = (membs[c] - sm) * avg_w
            cands.append((mw_tp / max(mw_tp + mw_fp + (sum_mw - mw_tp), 1e-20), c))
        out.append(cands)
    return out


def _held_to_oracle(got, oracle):
    """Cluster ids equal but where the oracle's best two lie within NEAR_TIE;
    scores rtol 1e-5. Returns the number of near-tie places."""
    ties = 0
    cl, sc = got.cluster.numpy(), got.score.numpy()
    for u, cands in enumerate(oracle):
        if not cands:
            assert cl[u] == -1 and sc[u] == 0
            continue
        best = max(s for s, _ in cands)
        winners = [c for s, c in cands if s >= best * (1 - NEAR_TIE)]
        ties += len(winners) > 1
        assert cl[u] in winners, (u, cl[u], cands)
        np.testing.assert_allclose(sc[u], best, rtol=1e-5)
    return ties


def test_update_iteration_exact_on_dyadic_weights():
    rng = np.random.default_rng(11)
    params = kf.KnownForParams(num_clusters=16)
    jparams = jkf.KnownForParams(num_clusters=16)
    for trial in range(3):
        ids, w = _graphs(rng, 96, 12, dyadic=True)
        cluster, score = _state(rng, 96, dyadic=True)
        got = kf.update_iteration(kf.Graph(*_t(ids, w)), kf.KnownFor(*_t(cluster, score)), params)
        want = jax.jit(lambda g, k: jkf.update_iteration(g, k, jparams))(
            jkf.Graph(jnp.asarray(ids), jnp.asarray(w)), jkf.KnownFor(jnp.asarray(cluster), jnp.asarray(score)))
        np.testing.assert_array_equal(got.cluster.numpy(), np.asarray(want.cluster))
        np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), rtol=1e-6)
        assert (got.cluster.numpy() >= 0).mean() > 0.5
        assert _held_to_oracle(got, _update64(ids, w, cluster, score, params)) >= 0


def test_update_iteration_random_weights_held_to_float64():
    rng = np.random.default_rng(12)
    params = kf.KnownForParams(num_clusters=16)
    jparams = jkf.KnownForParams(num_clusters=16)
    ids, w = _graphs(rng, 128, 16, dyadic=False)
    cluster, score = _state(rng, 128, dyadic=False)
    oracle = _update64(ids, w, cluster, score, params)
    got = kf.update_iteration(kf.Graph(*_t(ids, w)), kf.KnownFor(*_t(cluster, score)), params)
    want = jkf.update_iteration(jkf.Graph(jnp.asarray(ids), jnp.asarray(w)),
                                jkf.KnownFor(jnp.asarray(cluster), jnp.asarray(score)), jparams)
    _held_to_oracle(got, oracle)
    _held_to_oracle(kf.KnownFor(*_t(want.cluster, want.score)), oracle)


def test_stats_and_final_scores_match_jax(planted):
    _, jg, init, known = planted
    g = kf.Graph(*_t(jg.nbr_ids, jg.nbr_weights))
    for state in (init, known):
        k = kf.KnownFor(*_t(state.cluster, state.score))
        for got, want in zip(kf.cluster_stats(k, C), jkf.cluster_stats(state, C)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        for got, want in zip(kf.global_stats(g, k), jkf.global_stats(jg, state)):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        got = kf.final_scores(g, k, kf.KnownForParams(num_clusters=C))
        want = jkf.final_scores(jg, state, jkf.KnownForParams(num_clusters=C))
        np.testing.assert_array_equal(got.cluster.numpy(), np.asarray(want.cluster))
        np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), rtol=1e-5, atol=1e-7)


def _recovery(cluster, community):
    assigned = cluster >= 0
    purities = [np.bincount(community[cluster == c]).max() / (cluster == c).sum()
                for c in np.unique(cluster[assigned]) if (cluster == c).sum() >= 3]
    return assigned.mean(), np.mean(purities)


def test_iterate_recovers_planted_communities_as_jax(planted):
    world, jg, init, known = planted
    got = kf.iterate(kf.Graph(*_t(jg.nbr_ids, jg.nbr_weights)), kf.KnownFor(*_t(init.cluster, init.score)),
                     kf.KnownForParams(num_clusters=C), num_iterations=6)
    np.testing.assert_array_equal(got.cluster.numpy(), np.asarray(known.cluster))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(known.score), rtol=1e-5, atol=1e-7)
    share, purity = _recovery(got.cluster.numpy(), world.producer_community)
    assert share > 0.8 and purity > 0.8  # the JAX test's bounds (tests/test_simclusters_offline.py:120-138)
    sc = got.score.numpy()[got.cluster.numpy() >= 0]
    assert sc.min() >= 0.0 and sc.max() <= 1.0 + 1e-6


def test_initialize_random_draws_assignments():
    a = kf.initialize_random(torch.Generator().manual_seed(3), 1000, 40, fraction=0.7)
    b = kf.initialize_random(torch.Generator().manual_seed(3), 1000, 40, fraction=0.7)
    assert torch.equal(a.cluster, b.cluster) and a.cluster.dtype == torch.int32
    assigned = a.cluster >= 0
    assert 0.6 < assigned.float().mean() < 0.8 and int(a.cluster.max()) < 40
    assert torch.equal(a.score, assigned.float())


def _follow_fav(world, port):
    arrays = (world.producer_ids, world.followed, world.fav_score, world.log_fav_score)
    return ii.FollowFavGraph(*_t(*arrays)) if port else jii.FollowFavGraph(*(jnp.asarray(a) for a in arrays))


def test_interested_in_matches_jax(planted):
    world, _, _, known = planted
    params = dict(num_clusters=C, max_clusters_per_user=10)
    got = ii.interested_in_from_known_for(_follow_fav(world, True), kf.KnownFor(*_t(known.cluster, known.score)),
                                          ii.InterestedInParams(**params))
    want = jax.jit(lambda g, k: jii.interested_in_from_known_for(g, k, jii.InterestedInParams(**params)))(
        _follow_fav(world, False), known)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert (got.ids != PAD_ID).any(1).float().mean() > 0.9
    for g, w in zip(got[1:], want[1:]):  # JAX's sums are prefix-sum differences over a row of 24
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    for kind in ("follow", "fav", "log_fav", "fav_norm", "log_fav_norm"):
        assert torch.equal(got.embedding(kind).scores, getattr(got, {
            "follow": "follow_score", "fav": "fav_score", "log_fav": "log_fav_score",
            "fav_norm": "fav_cluster_normalized", "log_fav_norm": "log_fav_cluster_normalized"}[kind]))
    # one producer below the social-proof threshold: no interest
    one = ii.interested_in_from_known_for(
        ii.FollowFavGraph(*_t([[0, PAD_ID]], [[True, False]], np.float32([[1.0, 0]]), np.float32([[0.7, 0]]))),
        kf.KnownFor(*_t(np.int32([5]), np.float32([1.0]))), ii.InterestedInParams(num_clusters=8))
    assert (one.ids == PAD_ID).all()


def test_producer_embeddings_match_jax(planted):
    world, _, _, known = planted
    interest = jii.interested_in_from_known_for(_follow_fav(world, False), known,
                                                jii.InterestedInParams(num_clusters=C, max_clusters_per_user=10))
    P = world.config.num_producers
    args = (world.producer_ids, world.fav_score, interest.ids, interest.fav_cluster_normalized)
    got = pe.producer_cluster_matrix(*_t(*args), P, C).numpy()
    want = np.asarray(jpe.producer_cluster_matrix(*(jnp.asarray(a) for a in args), P, C))
    dense64 = np.zeros((P, C))
    pids, fav, iids, isc = (np.asarray(a) for a in args)
    for u in range(pids.shape[0]):
        for p, wt in zip(pids[u], fav[u]):
            if p != PAD_ID:
                for c, s in zip(iids[u], isc[u]):
                    if c != PAD_ID:
                        dense64[p, c] += float(wt) * float(s)
    np.testing.assert_allclose(got, dense64, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    kw = dict(num_producers=P, num_clusters=C, top_k_clusters=8, top_k_producers=16)
    g = pe.producer_embeddings_from_interested_in(*_t(*args), **kw)
    w = jpe.producer_embeddings_from_interested_in(*(jnp.asarray(a) for a in args), **kw)
    for a, b in ((g.by_producer.ids, w.by_producer.ids), (g.cluster_top_producers_ids, w.cluster_top_producers_ids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in ((g.by_producer.scores, w.by_producer.scores),
                 (g.cluster_top_producers_scores, w.cluster_top_producers_scores)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        pe.producer_cluster_matrix(*_t(*args), 1 << 16, 1 << 15)


def test_port_community_graph_matches_jax():
    cfg = dict(num_users=64, num_producers=32, num_communities=4, follows_per_user=8, seed=5)
    got = synthetic.community_graph(synthetic.CommunityGraphConfig(**cfg))
    want = jsyn.community_graph(jsyn.CommunityGraphConfig(**cfg))
    for name in ("producer_ids", "followed", "fav_score", "log_fav_score", "user_community", "producer_community"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
