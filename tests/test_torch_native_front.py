"""The port's native predict front (serving/native_front.py over its copy of
native/src/serving_core.cc, built with g++ at first use): the binary
protocol's round trip, keep-alive, coalescing, health, stats and errors
(tests/test_native_front.py, which the JAX suite runs as slow), the drain
buffer handed to a predict function that keeps its input, and fault 8 in
both packages: a predict function that raises leaves its batch and every
later request unanswered while ``/healthz`` answers "ok"; the port keeps
the exception on the front.

Every socket has a timeout; every front is closed in a ``finally``."""

import json
import socket
import threading

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread per worker)
from the_algorithm_tpu.serving import native_front as jax_front
from the_algorithm_tpu_torch.serving.native_front import NativeClient, NativeFrontConfig, NativePredictFront

F, O = 16, 3
TIMEOUT = 20.0  # seconds a socket operation may take where an answer is due
SILENT = 1.5  # seconds a client waits where no answer may come


def _model(batch: np.ndarray) -> np.ndarray:
    """A per-row function, so that answers can be checked row by row."""
    s = batch.sum(axis=1, keepdims=True)
    return np.concatenate([s, s * 2.0, -s], axis=1)


def _torch_model(batch: np.ndarray) -> torch.Tensor:
    """The same function, answering a tensor as a port model does."""
    return torch.from_numpy(_model(batch))


@pytest.fixture(params=["numpy", "torch"])
def front(request):
    cfg = NativeFrontConfig(feature_width=F, out_width=O, max_batch_rows=64, max_delay_ms=3.0)
    f = NativePredictFront(_model if request.param == "numpy" else _torch_model, cfg)
    try:
        yield f
    finally:
        f.close()


def test_single_request_roundtrip(front):
    c = NativeClient(front.port, F, O, timeout=TIMEOUT)
    try:
        rows = np.random.default_rng(0).random((5, F)).astype(np.float32)
        np.testing.assert_allclose(c.predict(rows), _model(rows), rtol=1e-6)
    finally:
        c.close()
    assert front.error is None


def test_keep_alive_multiple_requests(front):
    c = NativeClient(front.port, F, O, timeout=TIMEOUT)
    try:
        rng = np.random.default_rng(1)
        for _ in range(4):
            rows = rng.random((3, F)).astype(np.float32)
            np.testing.assert_allclose(c.predict(rows), _model(rows), rtol=1e-6)
    finally:
        c.close()


def test_concurrent_clients_are_batched(front):
    rng = np.random.default_rng(2)
    inputs = [rng.random((2, F)).astype(np.float32) for _ in range(16)]
    outputs = [None] * 16

    def worker(i):
        c = NativeClient(front.port, F, O, timeout=TIMEOUT)
        try:
            outputs[i] = c.predict(inputs[i])
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    for i in range(16):
        np.testing.assert_allclose(outputs[i], _model(inputs[i]), rtol=1e-6)
    st = front.stats()
    assert (st["requests"], st["rows"], st["http_errors"]) == (16, 32, 0)
    assert st["batches"] < 16 and st["avg_batch_rows"] > 2.0  # deadline batching coalesced


def test_health_stats_and_errors(front):
    c = NativeClient(front.port, F, O, timeout=TIMEOUT)
    try:
        assert c.get("/healthz") == b"ok"
        c.predict(np.zeros((1, F), np.float32))
        assert json.loads(c.get("/stats"))["requests"] >= 1
    finally:
        c.close()
    c2 = NativeClient(front.port, F, O, timeout=TIMEOUT)
    try:
        with pytest.raises(RuntimeError, match="400"):
            c2.predict(np.zeros((1000, F), np.float32))  # past max_batch_rows
    finally:
        c2.close()
    assert front.stats()["http_errors"] == 1


def _two_batches(front_cls, client_cls, timeout_kw):
    """Two batches in flight one after the other through a front whose
    predict function keeps each input it is given. Returns the rows sent
    and the inputs kept."""
    kept = []

    def keeping(x):
        kept.append(x)  # held past the call, as a copy to the card started from it would be
        return _model(x)

    cfg = NativeFrontConfig(feature_width=F, out_width=O, max_batch_rows=64, max_delay_ms=1.0)
    rng = np.random.default_rng(3)
    sent = [rng.random((4, F)).astype(np.float32) for _ in range(2)]
    f = front_cls(keeping, cfg)
    try:
        for rows in sent:
            c = client_cls(f.port, F, O, **timeout_kw)
            try:
                np.testing.assert_allclose(c.predict(rows), _model(rows), rtol=1e-6)
            finally:
                c.close()
    finally:
        f.close()
    return sent, kept


def test_drain_buffer_is_not_handed_out():
    """The port hands each batch's own rows: the first batch's input, kept
    past its call, still holds the first batch after the second is drained.
    The JAX front hands a view of its one drain buffer, which the second
    batch overwrites."""
    sent, kept = _two_batches(NativePredictFront, NativeClient, {"timeout": TIMEOUT})
    np.testing.assert_array_equal(kept[0], sent[0])
    np.testing.assert_array_equal(kept[1], sent[1])
    jsent, jkept = _two_batches(jax_front.NativePredictFront, _jax_client, {})
    np.testing.assert_array_equal(jkept[0], jsent[1])  # the JAX front's first input now holds batch 2


def _jax_client(port, f, o):
    c = jax_front.NativeClient(port, f, o)
    c._sock.settimeout(TIMEOUT)
    return c


def _raising(x):
    if (x[:, 0] < 0).any():
        raise RuntimeError("launch failed")
    return _model(x)


def _silent(client_cls, port, rows, settimeout):
    """True if a request of ``rows`` gets no answer within SILENT seconds."""
    c = client_cls(port, F, O)
    settimeout(c, SILENT)
    try:
        c.predict(rows)
    except (socket.timeout, TimeoutError):
        return True
    finally:
        c.close()
    return False


@pytest.mark.parametrize("package", ["port", "jax"])
def test_fault_8_a_raising_predict_leaves_requests_unanswered(package):
    """A predict function that raises ends the drain loop in both packages:
    that batch's client, and a later client, get no answer, while /healthz
    answers "ok". The port holds the exception on the front; JAX's thread
    dies with it."""
    cls = NativePredictFront if package == "port" else jax_front.NativePredictFront
    client_cls = NativeClient if package == "port" else jax_front.NativeClient
    settimeout = (lambda c, t: c._sock.settimeout(t))
    cfg = NativeFrontConfig(feature_width=F, out_width=O, max_batch_rows=64, max_delay_ms=1.0)
    died = []
    hook = threading.excepthook
    threading.excepthook = lambda args: died.append(args.exc_value)
    f = cls(_raising, cfg)
    try:
        good = np.ones((2, F), np.float32)
        c = client_cls(f.port, F, O)
        settimeout(c, TIMEOUT)
        try:
            np.testing.assert_allclose(c.predict(good), _model(good), rtol=1e-6)
        finally:
            c.close()
        assert _silent(client_cls, f.port, -good, settimeout)  # the raising batch: no answer
        assert _silent(client_cls, f.port, good, settimeout)  # nothing drains later requests
        h = client_cls(f.port, F, O)
        settimeout(h, TIMEOUT)
        try:
            assert h.get("/healthz") == b"ok"  # health does not see it
        finally:
            h.close()
        assert f.stats()["requests"] == 3
        if package == "port":
            assert isinstance(f.error, RuntimeError) and "launch failed" in str(f.error)
            assert died == []
        else:
            assert not hasattr(f, "error")
            assert len(died) == 1 and "launch failed" in str(died[0])
    finally:
        threading.excepthook = hook
        f.close()
