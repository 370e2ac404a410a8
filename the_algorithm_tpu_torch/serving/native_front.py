"""Native predict front: C++ socket/batching plane + model drain loop.

≡ navi's runtime split (``navi/navi/src/predict_service.rs:25,40`` +
``batch.rs:23,116-200``): the native side (``native/src/serving_core.cc``)
owns the HTTP front, request parsing, and size+deadline batch assembly; the
model side is a Python drain loop that pulls ready batches, runs the model
on the card, and hands results back for response fan-out.

The port of ``the_algorithm_tpu/serving/native_front.py``, with the same
wire protocol and C ABI, and two differences in the drain loop:

- ``sc_next_batch`` writes each batch into one reused host buffer. The
  predict function gets a copy of the batch's rows, never a view of that
  buffer: a copy to the device started from the view without waiting
  (``non_blocking=True`` from pinned memory), or a tensor kept past the
  call, would read the next batch's rows.
- A predict function that raises ends the drain loop, as it does in the JAX
  package: that batch's requests, and every later one, stay unanswered
  while ``GET /healthz`` keeps answering "ok". The port keeps the exception
  in :attr:`NativePredictFront.error` so that its owner can see the front is
  dead and raise it.

Wire protocol: ``POST /predict`` with a binary body
``u32 n_rows | f32 data[n_rows × feature_width]`` → response
``u32 n_rows | f32 data[n_rows × out_width]``; ``GET /healthz``;
``GET /stats`` (JSON counters). See :class:`NativeClient` below.
"""

from __future__ import annotations

import ctypes
import dataclasses
import socket
import struct
import threading
from typing import Callable, Dict, Optional

import numpy as np

from the_algorithm_tpu_torch import native
from the_algorithm_tpu_torch.core.device import host_array


@dataclasses.dataclass(frozen=True)
class NativeFrontConfig:
    port: int = 0  # 0 = ephemeral
    feature_width: int = 128
    out_width: int = 1
    max_batch_rows: int = 256
    max_delay_ms: float = 2.0
    drain_timeout_ms: float = 50.0


class NativePredictFront:
    """Runs ``predict_fn`` over batches assembled by the C++ core.

    ``predict_fn(batch [B, feature_width] f32) -> [B, out_width] f32``; B
    varies up to max_batch_rows (pad inside predict_fn if the compiled
    program needs stable shapes — ``serving.batcher`` has the pattern).
    """

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], np.ndarray],
        config: NativeFrontConfig = NativeFrontConfig(),
    ):
        self._fn = predict_fn
        self._cfg = config
        self.error: Optional[Exception] = None  # what ended the drain loop
        L = native.lib()
        self._h = L.sc_start(
            config.port,
            config.feature_width,
            config.out_width,
            config.max_batch_rows,
            int(config.max_delay_ms * 1000),
        )
        if not self._h:
            raise OSError("serving core failed to start")
        self.port = int(L.sc_port(self._h))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        L = native.lib()
        cfg = self._cfg
        buf = np.empty((cfg.max_batch_rows, cfg.feature_width), np.float32)
        bid = ctypes.c_int64()
        f32p = ctypes.POINTER(ctypes.c_float)
        while not self._stop.is_set():
            n = L.sc_next_batch(
                self._h,
                buf.ctypes.data_as(f32p),
                ctypes.byref(bid),
                int(cfg.drain_timeout_ms * 1000),
            )
            if n <= 0:
                continue
            try:
                out = np.ascontiguousarray(
                    host_array(self._fn(buf[:n].copy())), np.float32
                ).reshape(n, cfg.out_width)
            except Exception as e:  # noqa: BLE001 — kept for the owner
                self.error = e
                return
            L.sc_complete(self._h, bid.value, out.ctypes.data_as(f32p))

    def stats(self) -> Dict[str, float]:
        raw = (ctypes.c_uint64 * 8)()
        native.lib().sc_stats(self._h, raw)
        reqs, rows, batches, sum_rows, sum_q, b_in, b_out, errs = (
            int(x) for x in raw
        )
        return {
            "requests": reqs,
            "rows": rows,
            "batches": batches,
            "avg_batch_rows": sum_rows / batches if batches else 0.0,
            "avg_queue_us": sum_q / reqs if reqs else 0.0,
            "bytes_in": b_in,
            "bytes_out": b_out,
            "http_errors": errs,
        }

    def close(self) -> None:
        if self._h:
            self._stop.set()
            self._thread.join(timeout=5)
            native.lib().sc_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeClient:
    """Minimal blocking client for the binary predict protocol (loadtests)."""

    def __init__(self, port: int, feature_width: int, out_width: int,
                 timeout: Optional[float] = None):
        """``timeout`` (seconds) bounds every socket operation; None blocks."""
        self._sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
        self._f = feature_width
        self._o = out_width

    def predict(self, rows: np.ndarray) -> np.ndarray:
        rows = np.ascontiguousarray(rows, np.float32)
        n = rows.shape[0]
        body = struct.pack("<I", n) + rows.tobytes()
        head = (
            f"POST /predict HTTP/1.1\r\nHost: x\r\n"
            f"Content-Length: {len(body)}\r\n\r\n"
        ).encode()
        self._sock.sendall(head + body)
        return self._read_response(n)

    def _read_response(self, n: int) -> np.ndarray:
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("closed")
            data += chunk
        head, _, rest = data.partition(b"\r\n\r\n")
        status = int(head.split(b" ")[1])
        clen = 0
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                clen = int(line.split(b":")[1])
        while len(rest) < clen:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("closed")
            rest += chunk
        if status != 200:
            raise RuntimeError(f"predict failed: {status} {rest[:100]!r}")
        (got_n,) = struct.unpack_from("<I", rest, 0)
        assert got_n == n
        return np.frombuffer(rest, np.float32, count=n * self._o, offset=4).reshape(
            n, self._o
        )

    def get(self, path: str) -> bytes:
        req = f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode()
        self._sock.sendall(req)
        data = b""
        while b"\r\n\r\n" not in data:
            data += self._sock.recv(65536)
        head, _, rest = data.partition(b"\r\n\r\n")
        clen = 0
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                clen = int(line.split(b":")[1])
        while len(rest) < clen:
            rest += self._sock.recv(65536)
        return rest

    def close(self) -> None:
        self._sock.close()
