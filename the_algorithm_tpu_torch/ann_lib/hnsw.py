"""HNSW index: the native C++ engine behind the Queryable/Appendable API.

Counterpart of ``the_algorithm_tpu/ann_lib/hnsw.py``
(``ann/src/main/java/com/twitter/ann/hnsw/HnswIndex.java``: insert :153,
searchKnn :538, and its typed wrappers ``TypedHnswIndex`` /
``SerializableHnsw``): a hierarchical small-world graph with greedy
upper-layer descent and a beam search (``ef``) at layer 0.

The engine is ``native/src/hnsw.cc``, a byte-for-byte copy of the JAX
package's, built into the port's native library (``native/__init__.py``);
a snapshot saved by either package loads in the other. It runs on the host:
it plays the offline and CPU-serving role the Java engine plays in the
reference, beside the device scans of :mod:`.index`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from the_algorithm_tpu_torch import native
from the_algorithm_tpu_torch.ann_lib.index import Metric

_METRIC_CODE = {Metric.L2: 0, Metric.INNER_PRODUCT: 1, Metric.COSINE: 2}


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class HnswIndex:
    """Appendable + Queryable HNSW (``ef`` ≡ the Java engine's ef param)."""

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.COSINE,
        m: int = 16,
        ef_construction: int = 200,
        ef: int = 100,
        seed: int = 0,
        _handle: Optional[int] = None,
    ):
        self.dim = dim
        self.metric = metric
        self.ef = ef
        self._lib = native.lib()
        if _handle is not None:
            self._h = _handle
        else:
            self._h = self._lib.tpurecsys_hnsw_create(dim, _METRIC_CODE[metric], m, ef_construction, seed)
        if not self._h:
            raise RuntimeError("hnsw create/load failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.tpurecsys_hnsw_free(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.tpurecsys_hnsw_size(self._h))

    # Appendable
    def append(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        vectors = np.ascontiguousarray(np.asarray(vectors, np.float32).reshape(-1, self.dim))
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).reshape(-1))
        if ids.shape[0] != vectors.shape[0]:
            raise ValueError("ids/vectors length mismatch")
        self._lib.tpurecsys_hnsw_insert_batch(self._h, _f32p(vectors), _i64p(ids), ids.shape[0])

    # Queryable
    def query(self, queries: np.ndarray, k: int, ef: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """[Q, dim] → (ids [Q, k], distances [Q, k]); -1 ids pad short rows."""
        queries = np.ascontiguousarray(np.asarray(queries, np.float32).reshape(-1, self.dim))
        ef = max(ef or self.ef, k)
        Q = queries.shape[0]
        out_ids = np.full((Q, k), -1, np.int64)
        out_dists = np.full((Q, k), np.inf, np.float32)
        for q in range(Q):
            row_ids = np.zeros(k, np.int64)
            row_d = np.zeros(k, np.float32)
            n = self._lib.tpurecsys_hnsw_search(self._h, _f32p(queries[q]), k, ef, _i64p(row_ids), _f32p(row_d))
            out_ids[q, :n] = row_ids[:n]
            out_dists[q, :n] = row_d[:n]
        return out_ids, out_dists

    # Serialization (≡ SerializableHnsw)
    def save(self, path: str) -> None:
        if self._lib.tpurecsys_hnsw_save(self._h, path.encode()) != 0:
            raise IOError(f"hnsw save failed: {path}")

    @classmethod
    def load(cls, path: str, dim: int, metric: Metric = Metric.COSINE, ef: int = 100) -> "HnswIndex":
        handle = native.lib().tpurecsys_hnsw_load(path.encode())
        if not handle:
            raise IOError(f"hnsw load failed: {path}")
        return cls(dim, metric, ef=ef, _handle=handle)
