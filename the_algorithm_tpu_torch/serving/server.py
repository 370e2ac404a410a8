"""HTTP inference front: JSON predict endpoint over batcher + registry.

Counterpart of ``the_algorithm_tpu/serving/server.py``
(``navi/navi/src/{predict_service,bootstrap}.rs``): requests hit
``POST /v1/models/<name>:predict`` with JSON ``{"instances": [[...], ...]}``
(TF-Serving REST shape), or sparse ``{"records": [{name: value}, ...]}``
through a segdense densifier, are dynamically batched onto the model, and
return ``{"predictions": [...]}``. ``POST /v1/timelines/<product>`` runs a
product pipeline and answers its URT wire response. ``GET /metrics`` serves
Prometheus text (``metrics.rs:268-290``), ``GET /v1/models`` lists serving
versions.

Any exception answers 500 and counts ``errors``, and the server keeps
serving: a caller that needs to know the card ran reads that counter, not a
200.

Two differences from the JAX package's server: a ``records`` key of decimal
digits is a precomputed feature id (JSON has no int keys; the JAX server
hashes it as a name, so the feature is dropped), and the listen backlog is
128 connections where the JAX server keeps socketserver's 5.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np

from the_algorithm_tpu_torch.core.metrics import StatsReceiver
from the_algorithm_tpu_torch.pipeline import urt
from the_algorithm_tpu_torch.serving.batcher import BatcherConfig, DynamicBatcher
from the_algorithm_tpu_torch.serving.model_registry import ModelRegistry


def _is_feature_id(key: str) -> bool:
    """A JSON key of decimal digits (with an optional minus sign)."""
    digits = key[1:] if key[:1] == "-" else key
    return digits.isascii() and digits.isdigit()


def _wire_records(records):
    """Sparse records as JSON carries them, with the keys a client meant as
    precomputed feature ids made ints again: a JSON object's keys are always
    strings, and the densifier hashes a string key as a feature name."""
    return [{int(k) if _is_feature_id(k) else k: v for k, v in r.items()} for r in records]


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 resets connections when
    # a few dozen clients connect at once
    request_queue_size = 128


class InferenceServer:
    def __init__(
        self,
        registry: ModelRegistry,
        predict_builder: Callable[[object], Callable[[np.ndarray], np.ndarray]],
        port: int = 0,
        batcher_config: BatcherConfig = BatcherConfig(),
        stats: Optional[StatsReceiver] = None,
        densifiers: Optional[Dict[str, object]] = None,
        products=None,  # HomeProductPipelineRegistry
        query_builder: Optional[Callable[[str, dict], object]] = None,
    ):
        """``predict_builder(model_handle) -> batched predict fn``: it runs
        once per served (model, version), so a version bump swaps models.

        ``densifiers``: optional per-model
        :class:`~the_algorithm_tpu_torch.serving.segdense.RequestDensifier` —
        requests may then POST sparse ``{"records": [{name: value}, ...]}``
        (the thrift-BPR shape) instead of dense ``instances``; the segdense
        spec densifies them in native code before batching.

        ``products`` + ``query_builder``: optional product edge — with a
        :class:`~the_algorithm_tpu_torch.mixers.home_products.
        HomeProductPipelineRegistry` (or any object whose ``get(product)``
        has ``run(query)``) bound, ``POST /v1/timelines/<product>`` runs the
        product pipeline on ``query_builder(product, payload)`` and returns
        the URT-marshalled wire response (the home-mixer Thrift endpoint as
        the HTTP edge); an unknown product answers 404."""
        self.registry = registry
        self.densifiers = densifiers or {}
        self.products = products
        self.query_builder = query_builder
        self.stats = stats or StatsReceiver()
        self._batchers: Dict[str, DynamicBatcher] = {}
        self._batcher_versions: Dict[str, int] = {}
        self._batcher_config = batcher_config
        self._predict_builder = predict_builder
        self._lock = threading.Lock()

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    self._send(200, server.stats.export_prometheus().encode(), "text/plain")
                elif self.path == "/v1/models":
                    models = {
                        m: {"version": server.registry.version(m)}
                        for m in server.registry.models()
                    }
                    self._send(200, json.dumps(models).encode())
                elif self.path == "/health":
                    self._send(200, b'{"status":"ok"}')
                else:
                    self._send(404, b'{"error":"not found"}')

            def do_POST(self):
                try:
                    if self.path.startswith("/v1/timelines/") and server.products is not None:
                        product = self.path[len("/v1/timelines/"):]
                        length = int(self.headers.get("Content-Length", 0))
                        payload = json.loads(self.rfile.read(length) or b"{}")
                        pipeline = server.products.get(product)
                        query = server.query_builder(product, payload) if server.query_builder else payload
                        server.stats.counter(f"timeline_requests/{product}")
                        tl = pipeline.run(query)
                        self._send(200, urt.marshal_timeline(tl).to_json().encode())
                        return
                    if not (
                        self.path.startswith("/v1/models/")
                        and self.path.endswith(":predict")
                    ):
                        self._send(404, b'{"error":"not found"}')
                        return
                    model = self.path[len("/v1/models/") : -len(":predict")]
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    if "records" in payload and model in server.densifiers:
                        instances, _ = server.densifiers[model].densify(_wire_records(payload["records"]))
                    else:
                        instances = np.asarray(payload.get("instances", []), np.float32)
                    if instances.size == 0:
                        self._send(400, b'{"error":"empty instances"}')
                        return
                    server.stats.counter(f"requests/{model}")
                    preds = server._get_batcher(model).predict(instances)
                    self._send(
                        200, json.dumps({"predictions": np.asarray(preds).tolist()}).encode()
                    )
                except KeyError as e:
                    self._send(404, json.dumps({"error": str(e)}).encode())
                except Exception as e:  # noqa: BLE001 — the edge answers 500 and keeps serving
                    server.stats.counter("errors")
                    self._send(500, json.dumps({"error": str(e)}).encode())

        self._httpd = _HTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def _get_batcher(self, model: str) -> DynamicBatcher:
        """Batcher per (model, version): hot-swap rebuilds on version bump."""
        version = self.registry.version(model)  # raises KeyError if absent
        with self._lock:
            if self._batcher_versions.get(model) != version:
                old = self._batchers.pop(model, None)
                if old:
                    old.close()
                handle = self.registry.get(model)
                self._batchers[model] = DynamicBatcher(
                    self._predict_builder(handle),
                    self._batcher_config,
                    self.stats.scope(f"batcher/{model}"),
                )
                self._batcher_versions[model] = version
            return self._batchers[model]

    def start(self) -> None:
        self.registry.start_watcher()
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        for b in self._batchers.values():
            b.close()
        self.registry.close()
