"""The port's spans (``core/metrics.span``) on the CPU: the SANN batch's
stage spans in a ``torch.profiler`` trace, nothing created with no profiler
collecting, and ``StatsReceiver.time``'s span. Imports no JAX."""

import json

import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread per worker)
from the_algorithm_tpu_torch.core import metrics
from the_algorithm_tpu_torch.core.metrics import StatsReceiver, span
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
from the_algorithm_tpu_torch.simclusters import ann

STAGES = ("retrieval.multiget", "retrieval.scan", "retrieval.sort", "retrieval.collapse", "retrieval.score",
          "retrieval.top_k")
C, M, Q, N = 32, 8, 3, 6


def _batch():
    """A small index and [Q, N] sources, drawn from a fixed seed."""
    g = torch.Generator().manual_seed(7)
    index = ClusterTweetIndex(torch.randint(0, 100, (C, M), generator=g, dtype=torch.int32),
                              torch.rand((C, M), generator=g),
                              torch.zeros((C, M), dtype=torch.int32))
    ids = torch.stack([torch.randperm(C, generator=g)[:N] for _ in range(Q)]).to(torch.int32)
    sources = SparseEmbedding(ids, torch.rand((Q, N), generator=g) + 0.1)
    config = ann.SimClustersANNConfig(max_scan_clusters=4, max_top_tweets_per_cluster=M, max_num_results=10)
    return index, sources, config


def _annotations(run, tmp_path):
    """The ``user_annotation`` ranges a CPU profile of ``run()`` holds, as
    (name, start, end) in start order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(spans, key=lambda s: s[1])


def test_a_sann_batch_opens_its_stage_spans_in_order_inside_sann_query(tmp_path):
    index, sources, config = _batch()
    spans = _annotations(lambda: ann.get_tweet_candidates_batch(index, sources, config), tmp_path)
    names = [n for n, _, _ in spans]
    assert names == ["sann.query", *STAGES]
    _, q0, q1 = spans[0]
    for name, s, e in spans[1:]:
        assert q0 <= s <= e <= q1, name
    for (a, _, a_end), (b, b_start, _) in zip(spans[1:], spans[2:]):  # stages do not overlap
        assert a_end <= b_start, (a, b)


def test_no_record_function_is_made_with_no_profiler_collecting(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a RecordFunction was made with no profiler collecting")

    monkeypatch.setattr(metrics, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    index, sources, config = _batch()
    ids, scores = ann.get_tweet_candidates_batch(index, sources, config)
    assert ids.shape == scores.shape == (Q, 10)
    with StatsReceiver().time("section"):
        pass
    assert span("a") is span("b")  # one shared null context
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="RecordFunction"):
            span("collecting")


def test_stats_time_opens_a_span_of_its_scoped_name(tmp_path):
    stats = StatsReceiver()

    def run():
        with stats.scope("scorer/ranker").time("latency"):
            torch.ones(4).sum()

    spans = _annotations(run, tmp_path)
    assert [n for n, _, _ in spans] == ["scorer/ranker/latency"]
    assert stats.stat_summary("scorer/ranker/latency_ms")["count"] == 1.0
