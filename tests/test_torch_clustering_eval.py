"""The port's clustering library, entity embeddings, multi-type graph,
cluster evaluation and tweet-similarity model against the JAX package's on
the same numpy inputs.

Labels, masks, ids and host results compare exactly; sums within rtol 1e-5
(the port sums through the run collapse, JAX by scatter-add: another
order); the eigen solver from its own start (JAX draws its start from
``PRNGKey``): eigenvalues within rtol 1e-4 and the projector Q·Qᵀ within
atol 1e-4 of JAX's and of ``numpy.linalg.eigh``'s; the pair MLP from JAX's
own init within rtol 1e-5, and within rtol 1e-4 after Adam steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.ops.sparse import SparseEmbedding as JEmb
from the_algorithm_tpu.simclusters import clustering as jcl
from the_algorithm_tpu.simclusters import entity_embeddings as jee
from the_algorithm_tpu.simclusters import evaluation as jev
from the_algorithm_tpu.simclusters import known_for as jkf
from the_algorithm_tpu.simclusters import multi_type_graph as jmt
from the_algorithm_tpu.simclusters import tweet_similarity as jts
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
from the_algorithm_tpu_torch.simclusters import clustering as cl
from the_algorithm_tpu_torch.simclusters import entity_embeddings as ee
from the_algorithm_tpu_torch.simclusters import evaluation as ev
from the_algorithm_tpu_torch.simclusters import known_for as kf
from the_algorithm_tpu_torch.simclusters import multi_type_graph as mt
from the_algorithm_tpu_torch.simclusters import tweet_similarity as ts
from the_algorithm_tpu_torch.training import metrics
from the_algorithm_tpu_torch.training.optimizers import Adam

RTOL, ATOL = 1e-5, 1e-6


def _emb(seed, N=48, K=6, C=24, pad=0.2, levels=None):
    """[N, K] embeddings: distinct clusters a row, PAD slots, scores
    descending (from a few levels when ``levels`` is given: ties)."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(C, K, replace=False) for _ in range(N)]).astype(np.int32)
    sc = (rng.choice(np.float32(levels), (N, K)) if levels else rng.uniform(0.1, 1.0, (N, K))).astype(np.float32)
    sc = -np.sort(-sc, axis=1)
    ids[rng.random((N, K)) < pad] = PAD_ID
    sc[ids == PAD_ID] = 0.0
    return ids, sc


def _both(ids, sc):
    return SparseEmbedding(torch.from_numpy(ids), torch.from_numpy(sc)), JEmb(jnp.asarray(ids), jnp.asarray(sc))


# -- clustering ---------------------------------------------------------------


@pytest.mark.parametrize("threshold", [0.45, 0.7])
def test_clustering_methods_match_jax(threshold):
    e, je = _both(*_emb(1, levels=[0.25, 0.5, 1.0]))
    sim = cl.similarity_matrix(e)
    jsim = jcl.similarity_matrix(je)
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), rtol=RTOL, atol=ATOL)
    labels = cl.connected_components(sim, threshold)
    jlabels = jcl.connected_components(jsim, threshold)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert 1 < len(set(labels.tolist())) < 48
    np.testing.assert_array_equal(cl.largest_dimension(e).numpy(), np.asarray(jcl.largest_dimension(je)))
    np.testing.assert_array_equal(cl.louvain(sim.numpy().astype(np.float64), threshold),
                                  jcl.louvain(np.asarray(jsim).astype(np.float64), threshold))
    np.testing.assert_array_equal(cl.medoid_representative(e, labels).numpy(),
                                  np.asarray(jcl.medoid_representative(je, jlabels)))
    w = np.random.default_rng(2).choice(np.float32([1.0, 2.0, 3.0]), 48)  # ties within clusters
    np.testing.assert_array_equal(cl.max_weight_representative(labels, torch.from_numpy(w)).numpy(),
                                  np.asarray(jcl.max_weight_representative(jlabels, jnp.asarray(w))))


def test_connected_components_no_edges_and_a_chain():
    assert len(set(cl.connected_components(torch.eye(3), 0.5).tolist())) == 3
    chain = torch.eye(6) + torch.diag(torch.ones(5), 1) + torch.diag(torch.ones(5), -1)
    assert cl.connected_components(chain, 0.5).tolist() == [0] * 6


# -- entity embeddings ----------------------------------------------------------


def _events(seed, B=400, U=40, E=20):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, E, B).astype(np.int32), rng.integers(0, U, B).astype(np.int32),
            rng.uniform(0.5, 2.0, B).astype(np.float32), rng.integers(0, 3, B).astype(np.int32))


def _same_sparse(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_entity_embeddings_match_jax(normalize):
    interests, jinterests = _both(*_emb(3, N=40, K=6, C=32))
    ent, usr, w, _ = _events(4)
    got = ee.entity_embeddings_from_engagements(torch.from_numpy(ent), torch.from_numpy(usr), torch.from_numpy(w),
                                                interests, num_entities=20, num_clusters=32, top_k=8,
                                                l2_normalize=normalize)
    want = jee.entity_embeddings_from_engagements(jnp.asarray(ent), jnp.asarray(usr), jnp.asarray(w), jinterests,
                                                  num_entities=20, num_clusters=32, top_k=8, l2_normalize=normalize)
    _same_sparse(got, want)
    assert (got.ids != PAD_ID).sum() > 100


def test_locale_and_fav_tfg_embeddings_match_jax():
    interests, jinterests = _both(*_emb(5, N=40, K=6, C=32))
    ent, usr, w, loc = _events(6, E=8)
    got = ee.locale_entity_embeddings(*map(torch.from_numpy, (ent, loc, usr, w)), interests, num_entities=8,
                                      num_locales=3, num_clusters=32, top_k=6)
    want = jee.locale_entity_embeddings(*map(jnp.asarray, (ent, loc, usr, w)), jinterests, num_entities=8,
                                        num_locales=3, num_clusters=32, top_k=6)
    _same_sparse(got, want)
    assert ee.locale_row(5, 2, 3) == jee.locale_row(5, 2, 3) == 17
    favs = np.random.default_rng(7).integers(0, 40, ent.shape[0]).astype(np.float32)
    got = ee.fav_tfg_topic_embeddings(*map(torch.from_numpy, (ent, loc, usr, favs)), interests, num_topics=8,
                                      num_locales=3, num_clusters=32, top_k=6)
    want = jee.fav_tfg_topic_embeddings(*map(jnp.asarray, (ent, loc, usr, favs)), jinterests, num_topics=8,
                                        num_locales=3, num_clusters=32, top_k=6)
    _same_sparse(got, want)


def test_reverse_cluster_index_matches_jax():
    e, je = _both(*_emb(8, N=30, K=5, C=16, levels=[0.25, 0.5, 0.75]))
    got = ee.reverse_cluster_index(e, num_clusters=16, top_m=6)
    want = jee.reverse_cluster_index(je, num_clusters=16, top_m=6)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


def test_entity_embeddings_raise_past_int32_slots():
    """JAX's int32 ``e · C + c`` wraps at 2³¹ dense slots (ROADMAP §3); the
    port's scatter raises before allocating."""
    interests, _ = _both(*_emb(9, N=4, K=2, C=8))
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="slots"):
        ee.entity_embeddings_from_engagements(one, one, torch.ones(1), interests, num_entities=1 << 16,
                                              num_clusters=1 << 15)


# -- the multi-type graph ---------------------------------------------------------


def _edges(seed, B=300, L=50, R=12, T=3):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, L, B).astype(np.int32)
    right = rng.integers(-1, R + 1, B).astype(np.int32)  # a few out of range
    etype = rng.integers(0, T, B).astype(np.int32)
    w = rng.choice(np.float32([0.0, -0.0, 0.5, 1.0, 2.0]), B)  # signed zeros and ties
    return left, right, etype, w


def test_multi_type_graph_matches_jax_with_signed_zero_weights():
    left, right, etype, w = _edges(10)
    got = mt.assemble(*map(torch.from_numpy, (left, right, etype, w)), num_right=12, num_types=3, top_k=5)
    want = jmt.assemble(*map(jnp.asarray, (left, right, etype, w)), num_right=12, num_types=3, top_k=5)
    np.testing.assert_array_equal(got.left_ids.numpy(), np.asarray(want.left_ids))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    # lax.sort ranks −0.0 equal to +0.0: both kept in input order, signs as given
    np.testing.assert_array_equal(np.signbit(got.weights.numpy()), np.signbit(np.asarray(want.weights)))
    signs = np.signbit(got.weights.numpy()[got.weights.numpy() == 0])
    assert signs.any() and not signs.all()
    a, b = np.arange(12), np.roll(np.arange(12), 3)
    sims = mt.truncated_similarity(got, torch.from_numpy(a), torch.from_numpy(b))
    for i in range(12):
        np.testing.assert_allclose(float(sims[i]), float(jmt.truncated_similarity(want, a[i], b[i])), rtol=RTOL)


# -- evaluation ---------------------------------------------------------------


def _graph(seed, U=64, D=10, C=6):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(U, D, replace=False) for _ in range(U)]).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (U, D)).astype(np.float32)
    ids[rng.random((U, D)) < 0.2] = PAD_ID
    w[ids == PAD_ID] = 0.0
    cluster = rng.integers(-1, C, U).astype(np.int32)
    return ids, w, cluster, np.where(cluster >= 0, rng.random(U), 0.0).astype(np.float32)


def test_evaluate_clusters_and_host_metrics_match_jax():
    ids, w, cluster, score = _graph(11)
    got = ev.evaluate_clusters(kf.Graph(*map(torch.from_numpy, (ids, w))),
                               kf.KnownFor(*map(torch.from_numpy, (cluster, score))), 6)
    want = jev.evaluate_clusters(jkf.Graph(*map(jnp.asarray, (ids, w))),
                                 jkf.KnownFor(*map(jnp.asarray, (cluster, score))), 6)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=RTOL, atol=ATOL)
    other = np.random.default_rng(12).integers(-1, 4, 64).astype(np.int32)
    a = kf.KnownFor(torch.from_numpy(cluster), torch.from_numpy(score))
    b = kf.KnownFor(torch.from_numpy(other), torch.from_numpy(score))
    assert ev.compare_known_for(a, b, 6) == jev.compare_known_for(jkf.KnownFor(jnp.asarray(cluster), score),
                                                                  jkf.KnownFor(jnp.asarray(other), score), 6)
    rng = np.random.default_rng(13)
    args = (cluster, rng.integers(0, 64, 200).astype(np.int32), rng.integers(0, 30, 200).astype(np.int32),
            rng.integers(-1, 6, 30).astype(np.int32))
    assert ev.bipartite_engagement_eval(*map(torch.from_numpy, args)) == jev.bipartite_engagement_eval(
        *map(jnp.asarray, args))


def _spectrum_graph(N=48, seed=14):
    """A dense symmetric graph with a known, well separated spectrum."""
    rng = np.random.default_rng(seed)
    v, _ = np.linalg.qr(rng.normal(size=(N, N)))
    lam = np.concatenate([[12.0, -9.0, 7.0, 5.0], rng.uniform(-1.0, 1.0, N - 4)])
    A = (v * lam) @ v.T
    return np.tile(np.arange(N, dtype=np.int32), (N, 1)), A.astype(np.float32), lam


@pytest.mark.parametrize("k", [2, 4])
def test_top_eigenvectors_match_jax_and_numpy(k):
    ids, A, lam = _spectrum_graph()
    vals, vecs = ev.top_eigenvectors(kf.Graph(torch.from_numpy(ids), torch.from_numpy(A)), k, iterations=60)
    jvals, jvecs = jev.top_eigenvectors(jkf.Graph(jnp.asarray(ids), jnp.asarray(A)), k, iterations=60)
    want = lam[np.argsort(-np.abs(lam))][:k]
    np.testing.assert_allclose(np.sort(vals.numpy()), np.sort(want), rtol=1e-4)
    np.testing.assert_allclose(np.sort(vals.numpy()), np.sort(np.asarray(jvals)), rtol=1e-4)
    proj = (vecs @ vecs.T).numpy()
    np.testing.assert_allclose(proj, np.asarray(jvecs @ jvecs.T), atol=1e-4)
    w, v = np.linalg.eigh(A.astype(np.float64))
    top = v[:, np.argsort(-np.abs(w))[:k]]
    np.testing.assert_allclose(proj, top @ top.T, atol=1e-4)


# -- the tweet-similarity model -----------------------------------------------------


def test_collect_training_pairs_matches_jax():
    rng = np.random.default_rng(15)
    u, t, stamps = rng.integers(0, 20, 300), rng.integers(0, 60, 300), rng.integers(0, 3000, 300)
    for kw in (dict(coengagement_window_s=500), dict(coengagement_window_s=100, max_pairs_per_user=3,
                                                     negatives_per_positive=2.0, seed=4)):
        got, want = ts.collect_training_pairs(u, t, stamps, **kw), jts.collect_training_pairs(u, t, stamps, **kw)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)


def _learn_world():
    """The JAX test's world: 4 communities of 16 clusters, users faving
    within one."""
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
    ds = ts.collect_training_pairs(np.asarray(eu), np.asarray(et), np.asarray(ets), coengagement_window_s=100,
                                   negatives_per_positive=1.0)
    return t_ids, t_scores, ds


def test_pair_model_matches_jax_and_learns():
    t_ids, t_scores, ds = _learn_world()
    a, ja = _both(t_ids[ds.tweet_a], t_scores[ds.tweet_a])
    b, jb = _both(t_ids[ds.tweet_b], t_scores[ds.tweet_b])
    feats = ts.pair_features_batch(a, b)
    jfeats = jts.pair_features_batch(ja, jb)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=RTOL, atol=ATOL)
    assert ts.FEATURE_NAMES == jts.FEATURE_NAMES

    cfg = jts.TweetSimilarityModelConfig()
    jparams = jts.init_params(cfg, jax.random.PRNGKey(0))
    model = ts.params_from_jax(ts.TweetSimilarityModel(ts.TweetSimilarityModelConfig(), device="cpu"),
                               jax.tree_util.tree_map(np.asarray, jparams))
    labels = torch.from_numpy(ds.label)
    batch = {"features": feats, "label": labels}
    np.testing.assert_allclose(model(feats).detach().numpy(), np.asarray(jts.forward(jparams, jfeats)), rtol=RTOL,
                               atol=ATOL)
    jbatch = {"features": jfeats, "label": jnp.asarray(ds.label)}
    np.testing.assert_allclose(float(ts.loss_fn(model, batch)[0]), float(jts.loss_fn(jparams, jbatch)[0]),
                               rtol=RTOL)

    opt, jopt = Adam(model.parameters(), lr=1e-2), optax.adam(1e-2)
    jstate = jopt.init(jparams)

    @jax.jit
    def jstep(p, s):
        g = jax.grad(lambda q: jts.loss_fn(q, jbatch)[0])(p)
        u, s = jopt.update(g, s)
        return optax.apply_updates(p, u), s

    def step():
        opt.zero_grad()
        ts.loss_fn(model, batch)[0].backward()
        opt.step()

    for _ in range(5):
        step()
        jparams, jstate = jstep(jparams, jstate)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[name]), rtol=1e-4, atol=1e-6)
    for _ in range(195):
        step()
    auc = float(metrics.auc(model(feats).detach(), labels))
    assert auc > 0.8, f"AUC {auc}"
