"""The port's serving edge (serving/{segdense,product_front,warmup,server}.py)
against the JAX package's: the segdense spec and densifier on the wide
schema's 6,823 columns, sparse ``records`` predicts over HTTP, the timeline
endpoint, ``BatchedTimelineFront``'s coalescing, warmup, and the slice as a
whole: JAX's server and front over JAX's batched engine beside the port's
over the port's, on ``test_torch_batched_foryou``'s small world.

Every HTTP call has a timeout; every server and front is closed in a
``finally``."""

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread per worker)
from test_torch_batched_foryou import RTOL, _setup, engines, fixed_sources, query
from the_algorithm_tpu.core import hashing as jax_hashing
from the_algorithm_tpu.mixers import batched_foryou as jbf
from the_algorithm_tpu.mixers import feature_schema as jfs
from the_algorithm_tpu.mixers import home_mixer as jhm
from the_algorithm_tpu.mixers import home_products as jhp
from the_algorithm_tpu.serving import batcher as jbatcher
from the_algorithm_tpu.serving import model_registry as jmr
from the_algorithm_tpu.serving import product_front as jpf
from the_algorithm_tpu.serving import segdense as jsd
from the_algorithm_tpu.serving import server as jserver
from the_algorithm_tpu.serving import warmup as jwu
from the_algorithm_tpu_torch.core.hashing import feature_id
from the_algorithm_tpu_torch.core.metrics import StatsReceiver
from the_algorithm_tpu_torch.mixers import batched_foryou as bf
from the_algorithm_tpu_torch.mixers import feature_schema as fs
from the_algorithm_tpu_torch.mixers import home_mixer as hm
from the_algorithm_tpu_torch.mixers import home_products as hp
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.pipeline import urt
from the_algorithm_tpu_torch.pipeline.component import Candidate, CandidatePipeline, CandidateSource
from the_algorithm_tpu_torch.pipeline.mixer import MixerCandidatePipeline, MixerPipeline, SortByRecency
from the_algorithm_tpu_torch.serving import segdense as sd
from the_algorithm_tpu_torch.serving import warmup as wu
from the_algorithm_tpu_torch.serving.batcher import BatcherConfig
from the_algorithm_tpu_torch.serving.model_registry import ModelRegistry, save_params_npz
from the_algorithm_tpu_torch.serving.product_front import BatchedTimelineFront, default_timeline_builder
from the_algorithm_tpu_torch.serving.server import InferenceServer

TIMEOUT = 30  # seconds an HTTP call may take


def post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.read()


def sparse_records(rows, names, ids, rng):
    """Each row's non-zero columns as a record: string names for the even
    rows, precomputed feature ids for the odd ones."""
    out = []
    for b, row in enumerate(rows):
        nz = np.flatnonzero(row)
        keys = names if b % 2 == 0 else ids
        out.append({keys[j]: float(row[j]) for j in nz})
    return out


def wide_rows(rng, B):
    """[B, 6,823] f32 rows, about a third of each row's columns non-zero."""
    F = fs.total_width(fs.WIDE_SCHEMA)
    x = rng.normal(size=(B, F)).astype(np.float32)
    x[rng.random((B, F)) < 0.66] = 0.0
    return x


def test_spec_round_trips_between_packages(tmp_path):
    spec = sd.SegdenseSpec(("a", "b", "c"), ("label_x",))
    spec.save(str(tmp_path / "port.json"))
    assert sd.SegdenseSpec.load(str(tmp_path / "port.json")) == spec
    assert jsd.SegdenseSpec.load(str(tmp_path / "port.json")) == jsd.SegdenseSpec(("a", "b", "c"), ("label_x",))
    jsd.SegdenseSpec(("z",), ()).save(str(tmp_path / "jax.json"))
    assert sd.SegdenseSpec.load(str(tmp_path / "jax.json")) == sd.SegdenseSpec(("z",))
    assert (tmp_path / "port.json").read_bytes() == _jax_bytes(tmp_path, ("a", "b", "c"), ("label_x",))


def _jax_bytes(tmp_path, features, labels):
    jsd.SegdenseSpec(features, labels).save(str(tmp_path / "jax2.json"))
    return (tmp_path / "jax2.json").read_bytes()


def test_wide_schema_spec_is_the_expanded_schema():
    spec, jspec = sd.spec_from_schema(fs.WIDE_SCHEMA), jsd.spec_from_schema(jfs.WIDE_SCHEMA)
    assert spec.feature_names == tuple(fs.expand(fs.WIDE_SCHEMA)) == jspec.feature_names
    assert spec.width == fs.total_width(fs.WIDE_SCHEMA) == 6823
    np.testing.assert_array_equal(spec.feature_ids(), jspec.feature_ids())


def test_densify_is_bit_equal_on_the_wide_schema():
    rng = np.random.default_rng(11)
    spec = sd.spec_from_schema(fs.WIDE_SCHEMA, label_names=("is_favorited", "is_replied"))
    d, jd = sd.RequestDensifier(spec), jsd.RequestDensifier(
        jsd.spec_from_schema(jfs.WIDE_SCHEMA, label_names=("is_favorited", "is_replied")))
    names = spec.feature_names
    ids = [int(i) for i in spec.feature_ids()]
    x = wide_rows(rng, 6)
    records = sparse_records(x, names, ids, rng)
    (vals, mask), (jvals, jmask) = d.densify(records), jd.densify(records)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(vals, x)  # the source rows, bit for bit
    np.testing.assert_array_equal(mask, x != 0)
    labelled = [(r, {"is_replied": float(b % 2), feature_id("is_favorited"): 1.0}) for b, r in enumerate(records)]
    (f, lab), (jf, jlab) = d.densify_with_labels(labelled), jd.densify_with_labels(labelled)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(lab, jlab)
    np.testing.assert_array_equal(lab, [[1.0, b % 2] for b in range(6)])
    assert feature_id(names[5]) == jax_hashing.feature_id(names[5])


def test_densify_orders_and_accepts_ids():
    d = sd.RequestDensifier(sd.SegdenseSpec(("z_feat", "a_feat", "m_feat")))
    vals, mask = d.densify([{"a_feat": 2.0, "z_feat": 1.0}, {feature_id("m_feat"): 3.0}])
    np.testing.assert_array_equal(vals, [[1.0, 2.0, 0.0], [0.0, 0.0, 3.0]])
    np.testing.assert_array_equal(mask, [[1, 1, 0], [0, 0, 1]])


def test_records_predict_over_http(tmp_path):
    """Sparse ``records`` and dense ``instances`` through both packages'
    servers with a segdense densifier (tests/test_segdense.py:90-127)."""
    d = tmp_path / "models" / "lr" / "1"
    d.mkdir(parents=True)
    save_params_npz(str(d), {"w": np.asarray([1.0, 2.0], np.float32)})
    answers = []
    for pkg_sd, reg_cls, cfg_cls, srv_cls in ((sd, ModelRegistry, BatcherConfig, InferenceServer),
                                             (jsd, jmr.ModelRegistry, jbatcher.BatcherConfig,
                                              jserver.InferenceServer)):
        reg = reg_cls(str(tmp_path / "models"))
        reg.scan_once()
        srv = srv_cls(reg, predict_builder=lambda params: (lambda x: x @ params["w"]),
                      batcher_config=cfg_cls(max_batch_size=8, max_delay_ms=2.0),
                      densifiers={"lr": pkg_sd.RequestDensifier(pkg_sd.SegdenseSpec(("feat_a", "feat_b")))})
        srv.start()
        try:
            rec = json.loads(post(srv.port, "/v1/models/lr:predict",
                                  {"records": [{"feat_a": 3.0}, {"feat_b": 4.0, "feat_a": 1.0}]}))
            ins = json.loads(post(srv.port, "/v1/models/lr:predict", {"instances": [[3.0, 0.0], [1.0, 4.0]]}))
            codes = []
            for model, payload in (("ghost", {"instances": [[1.0, 2.0]]}), ("ghost", {"records": [{"feat_a": 1.0}]})):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    post(srv.port, f"/v1/models/{model}:predict", payload)
                codes.append(ei.value.code)
            # an unknown model answers 404; records with no densifier leave no instances: 400
            assert codes == [404, 400]
            answers.append((rec, ins))
        finally:
            srv.close()
    (rec, ins), (jrec, jins) = answers
    np.testing.assert_allclose(rec["predictions"], [3.0, 9.0])
    assert rec == ins == jrec == jins


def test_records_carry_precomputed_ids_over_json(tmp_path):
    """Fault 9: JSON object keys are strings, so a record keyed by
    precomputed feature ids reaches the server as digit strings. The JAX
    server hashes them as names and drops the features; the port's reads
    them as ids and answers as for the names."""
    d = tmp_path / "models" / "lr" / "1"
    d.mkdir(parents=True)
    save_params_npz(str(d), {"w": np.asarray([1.0, 2.0], np.float32)})
    by_id = {"records": [{feature_id("feat_a"): 3.0}, {feature_id("feat_b"): 4.0, "feat_a": 1.0}]}
    answers = []
    for pkg_sd, reg_cls, srv_cls in ((sd, ModelRegistry, InferenceServer), (jsd, jmr.ModelRegistry,
                                                                             jserver.InferenceServer)):
        reg = reg_cls(str(tmp_path / "models"))
        reg.scan_once()
        srv = srv_cls(reg, predict_builder=lambda params: (lambda x: x @ params["w"]),
                      densifiers={"lr": pkg_sd.RequestDensifier(pkg_sd.SegdenseSpec(("feat_a", "feat_b")))})
        srv.start()
        try:
            answers.append(json.loads(post(srv.port, "/v1/models/lr:predict", by_id))["predictions"])
        finally:
            srv.close()
    np.testing.assert_allclose(answers[0], [3.0, 9.0])  # the port: the ids' features
    np.testing.assert_allclose(answers[1], [0.0, 1.0])  # JAX: only the named feature survives


class _Recent(CandidateSource):
    def get(self, query, params):
        return [Candidate(id=100 + i, features={"author_id": i}) for i in range(3)]


class _Query:
    def __init__(self, payload):
        self.user_id = payload.get("user_id", 0)
        self.max_results = payload.get("max_results", 10)
        self.features = {}


def test_timeline_endpoint_serves_urt(tmp_path):
    """POST /v1/timelines/<product> → the product pipeline → its URT
    response, counted; an unknown product answers 404
    (tests/test_serving.py:157-224)."""
    products = hp.HomeProductPipelineRegistry()
    products.register("following", MixerPipeline(
        candidate_pipelines=[MixerCandidatePipeline(pipeline=CandidatePipeline(source=_Recent()))],
        entry_selectors=[SortByRecency()]))
    srv = InferenceServer(ModelRegistry(str(tmp_path)), lambda h: (lambda x: x), products=products,
                          query_builder=lambda product, payload: _Query(payload))
    srv.start()
    try:
        raw = post(srv.port, "/v1/timelines/following", {"user_id": 7, "max_results": 5})
        body = json.loads(raw)
        entries = body["timeline"]["instructions"][0]["addEntries"]["entries"]
        assert [e["content"]["item"]["id"] for e in entries if e["content"]["kind"] == "item"] == [102, 101, 100]
        assert "cursor" in {e["content"]["kind"] for e in entries}
        assert raw == urt.marshal_timeline(products.get("following").run(_Query({"user_id": 7}))).to_json().encode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(srv.port, "/v1/timelines/ghost", {})
        assert ei.value.code == 404
        counters = srv.stats.counters()
        assert counters.get("timeline_requests/following") == 1 and "errors" not in counters
    finally:
        srv.close()


def test_batched_front_coalesces_http_requests(tmp_path):
    """Concurrent timeline requests coalesce into one serve batch and each
    caller gets its own timeline (tests/test_serving.py:226-301)."""
    batch_sizes = []

    class Engine:
        def serve_batch(self, queries, params=None):
            batch_sizes.append(len(queries))
            return [[Candidate(id=1000 * int(q.user_id) + i, score=1.0 - 0.1 * i, features={"author_id": i})
                     for i in range(3)] for q in queries]

    front = BatchedTimelineFront(Engine(), BatcherConfig(max_batch_size=8, max_delay_ms=60.0))
    products = hp.HomeProductPipelineRegistry()
    products.register("for_you", front)
    srv = InferenceServer(ModelRegistry(str(tmp_path)), lambda h: (lambda x: x), products=products,
                          query_builder=lambda product, payload: _Query(payload))
    srv.start()
    try:
        with ThreadPoolExecutor(max_workers=6) as ex:
            bodies = list(ex.map(lambda u: json.loads(post(srv.port, "/v1/timelines/for_you", {"user_id": u})),
                                 range(6)))
        for u, body in enumerate(bodies):
            entries = body["timeline"]["instructions"][0]["addEntries"]["entries"]
            ids = [e["content"]["item"]["id"] for e in entries if e["content"]["kind"] == "item"]
            assert ids == [1000 * u, 1000 * u + 1, 1000 * u + 2]  # each caller got its timeline
        assert max(batch_sizes) > 1 and sum(batch_sizes) == 6
        tl = default_timeline_builder(None, Engine().serve_batch([_Query({"user_id": 2})])[0])
        assert (tl.top_cursor, tl.bottom_cursor) == (2002, 2000)
    finally:
        srv.close()
        front.close()


def _item_scores(doc):
    """A URT document's entries with their items' scores taken out, and the
    [(id, score)] of its items in order."""
    body = json.loads(doc)
    items = []
    for e in body["timeline"]["instructions"][0]["addEntries"]["entries"]:
        if e["content"]["kind"] == "item":
            items.append((e["content"]["item"]["id"], e["content"]["item"]["metadata"].pop("score")))
    return body, items


def test_the_slice_serves_jax_timelines(tmp_path):
    """JAX's InferenceServer + BatchedTimelineFront over JAX's batched engine,
    and the port's over the port's, on the small world: the same queries,
    one at a time, give the same URT JSON (ids equal but among near-ties,
    scores within RTOL)."""
    _setup()
    jeng, eng = engines(lambda pkg: fixed_sources(jbf if pkg == "jax" else bf), True)
    sides = []
    for pkg_hm, registry, front_cls, cfg_cls, reg_cls, srv_cls, engine in (
            (hm, hp.HomeProductPipelineRegistry, BatchedTimelineFront, BatcherConfig, ModelRegistry,
             InferenceServer, eng),
            (jhm, jhp.HomeProductPipelineRegistry, jpf.BatchedTimelineFront, jbatcher.BatcherConfig,
             jmr.ModelRegistry, jserver.InferenceServer, jeng)):
        front = front_cls(engine, cfg_cls(max_batch_size=4, max_delay_ms=1.0))
        products = registry()
        products.register("for_you", front)
        srv = srv_cls(reg_cls(str(tmp_path)), lambda h: (lambda x: x), products=products,
                      query_builder=lambda product, payload, pkg=pkg_hm: query(pkg, int(payload["user_id"])))
        srv.start()
        try:
            sides.append([post(srv.port, "/v1/timelines/for_you", {"user_id": u}) for u in range(4)])
        finally:
            srv.close()
            front.close()
    same = 0
    for got, want in zip(*sides):
        (g, g_items), (w, w_items) = _item_scores(got), _item_scores(want)
        assert 0 < len(g_items) == len(w_items)
        g_ids, w_ids = [i for i, _ in g_items], [i for i, _ in w_items]
        w_score = dict(w_items)
        for r, (a, b) in enumerate(zip(g_ids, w_ids)):
            if a != b:  # a near-tie: the two scores within RTOL
                assert abs(w_score[b] - dict(g_items)[a]) <= RTOL * abs(w_score[b]), (r, a, b)
        np.testing.assert_allclose([s for _, s in g_items], [s for _, s in w_items], rtol=RTOL)
        if g_ids == w_ids:
            assert g == w  # every other field of the document
            same += 1
        assert set(g_ids) == set(w_ids)
    assert same > 0, "no document equal field by field"


def test_warmup_drives_every_bucket():
    calls = []
    spec = wu.WarmupSpec(model_name="m", predict_fn=lambda x: calls.append(x.shape) or torch.from_numpy(x).sum(-1),
                         make_input=lambda b: np.zeros((b, 4), np.float32), batch_buckets=(1, 8))
    (report,) = wu.run_warmup([spec], repeats=2)
    assert report.ok and report.error is None
    assert calls == [(1, 4), (1, 4), (8, 4), (8, 4)]
    assert set(report.bucket_seconds) == {1, 8} and report.total_seconds >= 0


def test_warmup_fails_closed():
    """A predict that raises, or an input of the wrong width, reports not
    ready with a reason and raises nothing; the stats count it."""
    def bad(x):
        raise RuntimeError("build exploded")

    model = masknet.MaskNet(masknet.MaskNetConfig(num_features=6, num_heads=2, mask_blocks=1, block_dim=4,
                                                  aggregation_dim=2, head_hidden=(4,), dtype="float32"), device="cpu")
    stats = StatsReceiver()
    reports = wu.run_warmup([wu.WarmupSpec("bad", bad, lambda b: np.zeros((b, 2)), batch_buckets=(1, 8)),
                             wu.WarmupSpec("wide", masknet.predict_fn(model), lambda b: np.zeros((b, 5), np.float32)),
                             wu.WarmupSpec("ok", masknet.predict_fn(model), lambda b: np.zeros((b, 6), np.float32),
                                           batch_buckets=(1, 2))], stats=stats)
    jr = jwu.run_warmup([jwu.WarmupSpec("bad", bad, lambda b: np.zeros((b, 2)), batch_buckets=(1, 8))])[0]
    assert [r.ok for r in reports] == [False, False, True]
    assert "build exploded" in reports[0].error and reports[0].error == jr.error
    assert reports[0].bucket_seconds == {} and 8 not in reports[0].bucket_seconds
    assert reports[1].error.startswith("bucket 1: RuntimeError")
    assert stats.counters() == {"warmup/bad/failed": 1, "warmup/wide/failed": 1, "warmup/ok/ok": 1}


def test_registry_warmup_specs(tmp_path):
    d = tmp_path / "models" / "ranker" / "1"
    d.mkdir(parents=True)
    save_params_npz(str(d), {"w": np.ones(4, np.float32)})
    reg = ModelRegistry(str(tmp_path / "models"))
    reg.scan_once()
    specs = wu.registry_warmup_specs(reg, predict_builder=lambda name, params: (lambda x: x @ params["w"]),
                                     input_makers={"ranker": lambda b: np.ones((b, 4), np.float32)},
                                     batch_buckets=(1, 4))
    reports = wu.run_warmup(specs)
    assert [r.model_name for r in reports] == ["ranker"] and all(r.ok for r in reports)
    assert set(reports[0].bucket_seconds) == {1, 4}
