"""data/foryou_world.py against bench.py's For You candidate world: the draw
sequence re-stated here at a small size, bench.py's own draws read from its
source, and the graphs it builds against the JAX package's builders."""

import ast
import os

import jax.numpy as jnp
import numpy as np

from the_algorithm_tpu.graph import graphjet as jg
from the_algorithm_tpu.graph import uteg as ju
from the_algorithm_tpu.search import earlybird as je
from the_algorithm_tpu_torch.data import foryou_world
from the_algorithm_tpu_torch.ops.sparse import PAD_ID

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = foryou_world.ForYouShape(num_users=64, num_authors=16, eb_docs=300, events_per_user=4, tweet_space=200,
                                 uteg_width=6, seeds=3, follows=5, follow_width=8, utg_width=5, utg_sources=12)


def test_bench_draws_in_this_order():
    """The numpy draws of bench.py's For You world, in source order: the
    sequence :func:`foryou_world.build` follows."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "bench_foryou_batched")
    calls = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                    and isinstance(n.func.value, ast.Name) and n.func.value.id == "rng"),
                   key=lambda n: (n.lineno, n.col_offset))
    assert [ast.unparse(c) for c in calls][:8] == [
        "rng.integers(1, 50000, (EB_DOCS, 8))",
        "rng.integers(0, 40 * 3600, EB_DOCS)",
        "rng.random((EB_DOCS, len(eb.DOC_FEATURES)))",
        "rng.integers(0, NU, n_ev)",
        "rng.integers(0, 1 << 15, n_ev)",
        "rng.integers(NOW - 86400, NOW, n_ev)",
        "rng.integers(0, NU, (NU, 8))",
        "rng.choice(A, 48, False)",
    ]
    src = ast.unparse(fn)
    for const in ("NOW = 10000000", "NU, A, NT = (16384, 4096, 1 << 17)", "EB_DOCS = 1 << 18",
                  "rng = np.random.default_rng(7)", "n_ev = NU * 16", "init_graph(NU, width=32)",
                  "max_results=700", "max_results=400", "np.arange(3000000, 3000000 + EB_DOCS"):
        assert const in src, const
    assert foryou_world.FULL == foryou_world.ForYouShape(
        num_users=16_384, num_authors=4_096, eb_docs=1 << 18, eb_tokens=8, vocab=50_000, eb_age_s=144_000,
        events_per_user=16, tweet_space=1 << 15, uteg_width=32, seeds=8, follows=48, follow_width=64)


def test_world_is_benchs_draw_sequence():
    s, R = SMALL, 7
    w = foryou_world.build(s, users=R)
    rng = np.random.default_rng(7)  # bench.py:426, then its draws in order
    np.testing.assert_array_equal(w.eb_tokens, rng.integers(1, 50_000, (s.eb_docs, 8)).astype(np.int32))
    np.testing.assert_array_equal(w.eb_author, np.arange(s.eb_docs) % s.num_authors)
    np.testing.assert_array_equal(w.eb_created, foryou_world.NOW - rng.integers(0, 40 * 3600, s.eb_docs))
    np.testing.assert_array_equal(w.eb_features, rng.random((s.eb_docs, 184)).astype(np.float32))
    np.testing.assert_array_equal(w.eb_tweet_ids, np.arange(3_000_000, 3_000_000 + s.eb_docs))
    n_ev = s.num_users * 4
    np.testing.assert_array_equal(w.ev_users, rng.integers(0, s.num_users, n_ev))
    np.testing.assert_array_equal(w.ev_tweets, rng.integers(0, s.tweet_space, n_ev))
    np.testing.assert_array_equal(w.ev_ts, np.sort(rng.integers(foryou_world.NOW - 86_400, foryou_world.NOW, n_ev)))
    assert (w.ev_types == int(ju.EngagementType.FAVORITE)).all()
    np.testing.assert_array_equal(w.seeds, rng.integers(0, s.num_users, (s.num_users, s.seeds)))
    for i in range(R):
        follows = [int(a) for a in np.sort(rng.choice(s.num_authors, s.follows, False))]
        assert w.follows[i].tolist() == follows + [PAD_ID] * (s.follow_width - s.follows)
    engaged = np.unique(w.ev_tweets)
    np.testing.assert_array_equal(w.utg_sources, np.random.default_rng(11).choice(engaged, s.utg_sources, False))
    for a in (w.eb_tokens, w.eb_author, w.eb_created, w.eb_tweet_ids, w.ev_users, w.ev_tweets, w.ev_ts, w.seeds,
              w.follows, w.utg_sources):
        assert a.dtype == np.int32
    assert w.eb_features.dtype == np.float32


def test_world_states_equal_the_jax_builders():
    w = foryou_world.build(SMALL, users=2)
    s = SMALL
    graph = foryou_world.engagement_graph(w, device="cpu")
    want = ju.record_engagements(ju.init_graph(s.num_users, width=s.uteg_width), jnp.asarray(w.ev_users),
                                 jnp.asarray(w.ev_tweets), jnp.asarray(w.ev_types), jnp.asarray(w.ev_ts))
    for g, x in zip(graph, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    right = foryou_world.right_index(w, device="cpu")
    want = jg.record_right(jg.init_right_index(s.tweet_space, width=s.utg_width), w.ev_tweets, w.ev_users, w.ev_ts)
    for g, x in zip(right, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert (np.asarray(want.user_ids)[w.utg_sources] != PAD_ID).any(1).all()
    index = foryou_world.earlybird_index(w, device="cpu")
    assert index.write_pos == s.eb_docs and index.tokens.shape == (s.eb_docs, 8)
    # bench.py's in-network query (batched_foryou.EarlybirdBatchSource)
    kw = je.parse_query("from:follows")
    kw.pop("from_follows")
    q = foryou_world.in_network_query()
    assert q.require_all and q.min_ts == 0 and q.max_ts == foryou_world.NOW and q.followed_authors is None
    np.testing.assert_array_equal(q.tokens.numpy(), np.asarray(kw["tokens"]))
    assert q.tokens.shape == (16,)
