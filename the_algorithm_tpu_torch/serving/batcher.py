"""Size + deadline dynamic batching — the navi BatchPredictor.

≡ ``navi/navi/src/batch.rs:23,116-200``: requests enqueue with a callback;
a batch fires when it reaches ``max_batch_size`` OR the oldest request has
waited ``max_delay`` (``duration_past:200``); the model runs once per batch
and each caller gets its slice.

Batching is what keeps the GPU's tensor cores fed — single-candidate
requests would waste the card. The worker thread pads the batch to the next
power of two (a few stable GEMM shapes) and masks the padding.

A host copy of ``the_algorithm_tpu/serving/batcher.py``, which cannot be
imported without JAX (its metrics import runs through a package
``__init__`` that imports the JAX mesh module).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from the_algorithm_tpu_torch.core.metrics import NullStats, StatsReceiver


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_batch_size: int = 256
    max_delay_ms: float = 5.0
    pad_to_power_of_two: bool = True  # stable shapes → one compiled program


@dataclasses.dataclass
class _Pending:
    inputs: np.ndarray  # [n, ...] this request's examples
    future: Future
    enqueued_at: float


def _record_waits(stats: StatsReceiver, batch: List[_Pending], start: float) -> None:
    """Each item's wait from its enqueue to its batch's start, as the stat
    ``queue_wait_ms``."""
    for p in batch:
        stats.stat("queue_wait_ms", (start - p.enqueued_at) * 1e3)


class RequestBatcher:
    """Size + deadline coalescing of WHOLE requests (the navi front applied
    at the product edge, not just the model call).

    ``serve_fn(items: List) -> List`` handles one coalesced batch —
    e.g. ``BatchedForYouEngine.serve_batch`` — so R concurrent requests
    share every device program of the product pipeline. Same firing rule
    as :class:`DynamicBatcher` (``batch.rs:116-200``): a batch dispatches
    at ``max_batch_size`` items or when the oldest has waited
    ``max_delay_ms``.
    """

    def __init__(
        self,
        serve_fn: Callable[[List[Any]], List[Any]],
        config: BatcherConfig = BatcherConfig(max_batch_size=16),
        stats: Optional[StatsReceiver] = None,
        n_workers: int = 1,
    ):
        """``n_workers > 1`` pipelines batches: while one worker's batch
        executes on the device, another worker runs the NEXT batch's host
        phases (request building, columnar prep) — the device stream
        serializes the programs, so throughput gains come from hiding the
        host time, not from device contention. serve_fn must be
        thread-safe for reads (jax dispatch is)."""
        self.serve_fn = serve_fn
        self.config = config
        self.stats = stats or NullStats()
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._shutdown = threading.Event()
        self._workers = [
            threading.Thread(target=self._run, daemon=True)
            for _ in range(max(1, n_workers))
        ]
        for w in self._workers:
            w.start()

    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        self._queue.put(_Pending(item, fut, time.perf_counter()))
        return fut

    def serve(self, item: Any, timeout: float = 60.0) -> Any:
        return self.submit(item).result(timeout=timeout)

    def close(self) -> None:
        self._shutdown.set()
        for w in self._workers:
            w.join(timeout=2.0)

    def _collect(self) -> List[_Pending]:
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        # drain everything ALREADY queued first — items that accumulated
        # while the worker served the previous batch are free. (Checking
        # the deadline before draining degenerates to size-1 batches
        # whenever the worker falls behind: the oldest item's deadline has
        # always passed by then.)
        while len(batch) < self.config.max_batch_size:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        # NOTE: the straggler deadline stays anchored at the OLDEST item's
        # enqueue (navi's duration_past rule). Anchoring at collect start
        # was measured SLOWER end to end: fragment batches of stragglers
        # pipeline the host phases of one batch under the device phases of
        # the next, where perfectly coalesced batches serialize.
        deadline = first.enqueued_at + self.config.max_delay_ms / 1e3
        while len(batch) < self.config.max_batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self) -> None:
        while not self._shutdown.is_set():
            batch = self._collect()
            if not batch:
                continue
            self.stats.stat("request_batch_size", len(batch))
            t0 = time.perf_counter()
            _record_waits(self.stats, batch, t0)
            try:
                outs = self.serve_fn([p.inputs for p in batch])
            except Exception as e:
                for p in batch:
                    p.future.set_exception(e)
                continue
            self.stats.stat("serve_ms", (time.perf_counter() - t0) * 1e3)
            if len(outs) != len(batch):
                # Contract violation: zip-truncating would leave the excess
                # callers blocked until their serve() timeout.
                err = RuntimeError(
                    f"serve_fn returned {len(outs)} outputs for "
                    f"{len(batch)} inputs")
                for p in batch:
                    p.future.set_exception(err)
                continue
            for p, o in zip(batch, outs):
                p.future.set_result(o)


class DynamicBatcher:
    """Queue + worker thread around a batched ``predict_fn``.

    ``predict_fn(batch [B, ...]) -> [B, ...]`` must accept any B up to
    max_batch_size (padded if configured).
    """

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], np.ndarray],
        config: BatcherConfig = BatcherConfig(),
        stats: Optional[StatsReceiver] = None,
    ):
        self.predict_fn = predict_fn
        self.config = config
        self.stats = stats or NullStats()
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._shutdown = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, inputs: np.ndarray) -> Future:
        """Enqueue [n, ...] examples; resolves to [n, ...] outputs."""
        fut: Future = Future()
        self._queue.put(_Pending(np.asarray(inputs), fut, time.perf_counter()))
        return fut

    def predict(self, inputs: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        return self.submit(inputs).result(timeout=timeout)

    def close(self) -> None:
        self._shutdown.set()
        self._worker.join(timeout=2.0)

    # -- worker --------------------------------------------------------------

    def _collect(self) -> List[_Pending]:
        """Block for one request, drain the backlog for free, then wait
        out the oldest item's remaining deadline for stragglers."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        total = first.inputs.shape[0]
        # free drain (see RequestBatcher._collect: deadline-first checking
        # degenerates to single-item batches once the worker lags)
        while total < self.config.max_batch_size:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            batch.append(nxt)
            total += nxt.inputs.shape[0]
        deadline = first.enqueued_at + self.config.max_delay_ms / 1e3
        while total < self.config.max_batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(nxt)
            total += nxt.inputs.shape[0]
        return batch

    def _run(self) -> None:
        while not self._shutdown.is_set():
            batch = self._collect()
            if not batch:
                continue
            inputs = np.concatenate([p.inputs for p in batch], axis=0)
            n = inputs.shape[0]
            padded_n = n
            if self.config.pad_to_power_of_two:
                padded_n = 1 << (n - 1).bit_length()
                padded_n = min(padded_n, self.config.max_batch_size)
                padded_n = max(padded_n, n)
            if padded_n > n:
                pad = np.zeros((padded_n - n,) + inputs.shape[1:], inputs.dtype)
                inputs = np.concatenate([inputs, pad], axis=0)
            self.stats.stat("batch_size", n)
            t0 = time.perf_counter()
            _record_waits(self.stats, batch, t0)
            try:
                outputs = np.asarray(self.predict_fn(inputs))[:n]
            except Exception as e:
                for p in batch:
                    p.future.set_exception(e)
                continue
            self.stats.stat("predict_ms", (time.perf_counter() - t0) * 1e3)
            off = 0
            for p in batch:
                k = p.inputs.shape[0]
                p.future.set_result(outputs[off : off + k])
                off += k
