"""ctypes bindings for the native host data plane (libtpurecsys).

A copy of the JAX package's ``native/__init__.py`` for the port's copies of
``src/tpurecsys.cc`` (the TRec block codec, densifiers, the hashing
discretizer, murmur3 and the multiplicative hash) and
``src/serving_core.cc`` (the ``sc_*`` socket front and batcher that
``serving/native_front.py`` drives) and ``src/hnsw.cc`` (the HNSW engine
behind ``ann_lib/hnsw.py``, a byte-for-byte copy), with the same Python
functions and C entry points.

The library is built from the three sources with ``g++ -O3 -std=c++17
-pthread`` at first use into ``build/native/`` under the repository root
(gitignored), named by a hash of the flags and of every source, never into
the package directory; a failed build raises. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SRCS = tuple(os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", name)
              for name in ("tpurecsys.cc", "hnsw.cc", "serving_core.cc"))
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build", "native"
)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _SRCS:  # every source: an edit to any one names a new library
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtpurecsys_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless one of the same sources exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, *_SRCS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder never loads a torn file
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            _declare(handle)
            _lib = handle
        return _lib


def _declare(L: ctypes.CDLL) -> None:
    """Every entry point's C signature (``src/tpurecsys.cc``,
    ``src/hnsw.cc``, ``src/serving_core.cc``)."""
    u8p, u32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    u64p, f32p = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_float)
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    sigs = {
        "tpurecsys_murmur3_x64_128": (None, [u8p, u64, u32, u64p]),
        "tpurecsys_feature_id": (ctypes.c_int64, [ctypes.c_char_p, u64]),
        "tpurecsys_multiplicative_hash": (None, [i64p, i64p, i32p, u64, u64]),
        "tpurecsys_encode_block": (u64, [i64p, f32p, u32p, i64p, f32p, u32p, u32, u8p, u64]),
        "tpurecsys_block_num_records": (u32, [u8p, u64]),
        "tpurecsys_block_totals": (ctypes.c_int, [u8p, u64, u64p, u64p]),
        "tpurecsys_decode_block": (ctypes.c_int, [u8p, u64, i64p, f32p, u32p, i64p, f32p, u32p]),
        "tpurecsys_densify": (ctypes.c_int, [u8p, u64, i64p, u32, f32p, u8p]),
        "tpurecsys_densify_labels": (ctypes.c_int, [u8p, u64, i64p, u32, f32p, u8p]),
        "tpurecsys_hash_discretize": (ctypes.c_int, [u8p, u64, i64p, u32, f32p, u32, u32, u32, i32p, f32p, u8p]),
        # the HNSW engine (ann_lib/hnsw.py)
        "tpurecsys_hnsw_create": (ctypes.c_void_p, [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                                    u64]),
        "tpurecsys_hnsw_free": (None, [ctypes.c_void_p]),
        "tpurecsys_hnsw_size": (u64, [ctypes.c_void_p]),
        "tpurecsys_hnsw_insert": (ctypes.c_int32, [ctypes.c_void_p, f32p, ctypes.c_int64]),
        "tpurecsys_hnsw_insert_batch": (None, [ctypes.c_void_p, f32p, i64p, u64]),
        "tpurecsys_hnsw_search": (ctypes.c_int32, [ctypes.c_void_p, f32p, ctypes.c_int32, ctypes.c_int32, i64p, f32p]),
        "tpurecsys_hnsw_save": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p]),
        "tpurecsys_hnsw_load": (ctypes.c_void_p, [ctypes.c_char_p]),
        # the serving core (navi-equivalent socket front + batcher)
        "sc_start": (ctypes.c_void_p, [ctypes.c_int, u32, u32, u32, ctypes.c_int64]),
        "sc_port": (ctypes.c_int, [ctypes.c_void_p]),
        "sc_next_batch": (ctypes.c_int, [ctypes.c_void_p, f32p, i64p, ctypes.c_int64]),
        "sc_complete": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, f32p]),
        "sc_stats": (None, [ctypes.c_void_p, u64p]),
        "sc_stop": (None, [ctypes.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(L, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def murmur3_x64_128(data: bytes, seed: int = 0) -> Tuple[int, int]:
    buf = np.frombuffer(data, np.uint8) if data else np.zeros(0, np.uint8)
    out = (ctypes.c_uint64 * 2)()
    lib().tpurecsys_murmur3_x64_128(
        _u8(np.ascontiguousarray(buf)), len(data), seed, out
    )
    return int(out[0]), int(out[1])


def feature_id(name: str) -> int:
    raw = name.encode("utf-8")
    return int(lib().tpurecsys_feature_id(raw, len(raw)))


def multiplicative_hash(
    feature_ids: np.ndarray, buckets: np.ndarray, output_bits: int
) -> np.ndarray:
    f = np.ascontiguousarray(feature_ids.reshape(-1), np.int64)
    b = np.ascontiguousarray(buckets.reshape(-1), np.int64)
    out = np.empty(f.shape[0], np.int32)
    lib().tpurecsys_multiplicative_hash(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        f.shape[0], output_bits,
    )
    return out.reshape(feature_ids.shape)


# -- TRec block codec --------------------------------------------------------


def encode_block(
    records: list,  # list of (cont: {fid: val}, labels: {fid: val})
) -> bytes:
    """Encode python records → TRec block bytes (C++ does the packing)."""
    cont_f, cont_v, cont_off = [], [], [0]
    lab_f, lab_v, lab_off = [], [], [0]
    for cont, labels in records:
        for k, v in cont.items():
            cont_f.append(k)
            cont_v.append(v)
        cont_off.append(len(cont_f))
        for k, v in labels.items():
            lab_f.append(k)
            lab_v.append(v)
        lab_off.append(len(lab_f))

    cf = np.asarray(cont_f, np.int64)
    cv = np.asarray(cont_v, np.float32)
    co = np.asarray(cont_off, np.uint32)
    lf = np.asarray(lab_f, np.int64)
    lv = np.asarray(lab_v, np.float32)
    lo = np.asarray(lab_off, np.uint32)
    n = len(records)

    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    args = (
        cf.ctypes.data_as(i64p), cv.ctypes.data_as(f32p), co.ctypes.data_as(u32p),
        lf.ctypes.data_as(i64p), lv.ctypes.data_as(f32p), lo.ctypes.data_as(u32p),
        n,
    )
    need = lib().tpurecsys_encode_block(*args, None, 0)
    out = np.empty(need, np.uint8)
    wrote = lib().tpurecsys_encode_block(*args, _u8(out), need)
    if wrote != need:
        raise RuntimeError(f"encode_block wrote {wrote} of {need} bytes")
    return out.tobytes()


def decode_block(buf: bytes):
    """TRec block bytes → list of (cont dict, label dict)."""
    if len(buf) < 8 or buf[:4] != b"TREC":
        raise ValueError("corrupt TRec block (bad magic)")
    arr = np.frombuffer(buf, np.uint8)
    L = lib()
    n = L.tpurecsys_block_num_records(_u8(arr), len(buf))
    tc = ctypes.c_uint64()
    tl = ctypes.c_uint64()
    ok = L.tpurecsys_block_totals(
        _u8(arr), len(buf), ctypes.byref(tc), ctypes.byref(tl)
    )
    if not ok:
        raise ValueError("corrupt TRec block")
    cf = np.empty(tc.value, np.int64)
    cv = np.empty(tc.value, np.float32)
    co = np.empty(n + 1, np.uint32)
    lf = np.empty(tl.value, np.int64)
    lv = np.empty(tl.value, np.float32)
    lo = np.empty(n + 1, np.uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    L.tpurecsys_decode_block(
        _u8(arr), len(buf),
        cf.ctypes.data_as(i64p), cv.ctypes.data_as(f32p), co.ctypes.data_as(u32p),
        lf.ctypes.data_as(i64p), lv.ctypes.data_as(f32p), lo.ctypes.data_as(u32p),
    )
    out = []
    for r in range(n):
        cont = {
            int(cf[i]): float(cv[i]) for i in range(co[r], co[r + 1])
        }
        labels = {
            int(lf[i]): float(lv[i]) for i in range(lo[r], lo[r + 1])
        }
        out.append((cont, labels))
    return out


def densify(buf: bytes, vocab: np.ndarray):
    """TRec block → ([n, |vocab|] values, mask). vocab sorted int64."""
    arr = np.frombuffer(buf, np.uint8)
    L = lib()
    n = L.tpurecsys_block_num_records(_u8(arr), len(buf))
    v = np.ascontiguousarray(vocab, np.int64)
    values = np.zeros((n, v.shape[0]), np.float32)
    mask = np.zeros((n, v.shape[0]), np.uint8)
    L.tpurecsys_densify(
        _u8(arr), len(buf),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), v.shape[0],
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return values, mask.astype(bool)


def densify_labels(buf: bytes, vocab: np.ndarray):
    """TRec block label section → ([n, |vocab|] values, mask)."""
    arr = np.frombuffer(buf, np.uint8)
    L = lib()
    n = L.tpurecsys_block_num_records(_u8(arr), len(buf))
    v = np.ascontiguousarray(vocab, np.int64)
    values = np.zeros((n, v.shape[0]), np.float32)
    mask = np.zeros((n, v.shape[0]), np.uint8)
    L.tpurecsys_densify_labels(
        _u8(arr), len(buf),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), v.shape[0],
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return values, mask.astype(bool)


def hash_discretize(
    buf: bytes,
    vocab: np.ndarray,  # sorted int64 [F]
    bin_vals: np.ndarray,  # [F, n_bins-1] float32 (row order = vocab order)
    output_bits: int,
    max_width: int,
):
    """TRec block → hashed sparse batch (indices, values, mask) in C++."""
    arr = np.frombuffer(buf, np.uint8)
    L = lib()
    n = L.tpurecsys_block_num_records(_u8(arr), len(buf))
    v = np.ascontiguousarray(vocab, np.int64)
    b = np.ascontiguousarray(bin_vals, np.float32)
    indices = np.zeros((n, max_width), np.int32)
    values = np.zeros((n, max_width), np.float32)
    mask = np.zeros((n, max_width), np.uint8)
    L.tpurecsys_hash_discretize(
        _u8(arr), len(buf),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), v.shape[0],
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b.shape[1],
        output_bits, max_width,
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return indices, values, mask.astype(bool)
