"""Deterministic feature hashing, bit-identical to the reference's libtwml.

Three pieces (parity targets in the reference):

1. ``murmur3_x64_128`` — pure-Python MurmurHash3 x64 128-bit
   (``twml/libtwml/src/lib/murmur_hash3.cpp``, public-domain algorithm by
   Austin Appleby).
2. ``feature_id`` — feature-name → int64 id: first 8 bytes (LE) of the
   murmur3_x64_128 of the UTF-16-LE encoding of the name, with two-stage
   hashing for ``"name#key"`` features
   (``twml/libtwml/src/lib/functions.cpp: twml_get_feature_id_internal``).
3. ``multiplicative_hash`` — (feature_id, bucket_index) → bucket in
   [0, 2**output_bits): Knuth multiplicative hashing exactly as
   ``integer_multiplicative_hashing`` in
   ``twml/libtwml/src/lib/hashing_discretizer_impl.cpp:51-70`` — available
   vectorized for numpy (host input pipeline) and torch (on the device), both
   bit-identical to the C++ (only bits <32 matter).

A copy of ``the_algorithm_tpu/core/hashing.py`` (whose package imports JAX);
the torch form stands in for the JAX package's ``multiplicative_hash_jnp``.
"""

from __future__ import annotations

import struct
from typing import Tuple, Union

import numpy as np
import torch

_M64 = (1 << 64) - 1


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _M64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _M64
    k ^= k >> 33
    return k


def murmur3_x64_128(data: bytes, seed: int = 0) -> Tuple[int, int]:
    """MurmurHash3 x64 128-bit. Returns (h1, h2) as uint64 ints."""
    length = len(data)
    nblocks = length // 16
    h1 = seed & _M64
    h2 = seed & _M64
    c1 = 0x87C37B91114253D5
    c2 = 0x4CF5AD432745937F

    for i in range(nblocks):
        k1, k2 = struct.unpack_from("<QQ", data, i * 16)
        k1 = (k1 * c1) & _M64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * c2) & _M64
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _M64
        h1 = (h1 * 5 + 0x52DCE729) & _M64

        k2 = (k2 * c2) & _M64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * c1) & _M64
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _M64
        h2 = (h2 * 5 + 0x38495AB5) & _M64

    tail = data[nblocks * 16 :]
    k1 = 0
    k2 = 0
    tl = len(tail)
    if tl >= 9:
        for i in range(min(tl, 16) - 1, 7, -1):
            k2 = (k2 << 8) | tail[i]
        k2 = (k2 * c2) & _M64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * c1) & _M64
        h2 ^= k2
    if tl > 0:
        for i in range(min(tl, 8) - 1, -1, -1):
            k1 = (k1 << 8) | tail[i]
        k1 = (k1 * c1) & _M64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * c2) & _M64
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    return h1, h2


def feature_id(name: str) -> int:
    """Feature-name → int64 id, parity with ``twml_get_feature_id``.

    Names containing ``#`` are hashed in two stages: the first 8 bytes of
    murmur(utf16(prefix)) are prepended to utf16(suffix) and re-hashed, so
    ``a#b`` ids are stable under suffix-vocabulary growth.
    """
    k = name.find("#")
    if k > 0:
        h1, _ = murmur3_x64_128(name[:k].encode("utf-16-le"))
        prefix = struct.pack("<Q", h1)
        h1, _ = murmur3_x64_128(prefix + name[k + 1 :].encode("utf-16-le"))
    else:
        h1, _ = murmur3_x64_128(name.encode("utf-16-le"))
    # reinterpret as signed int64 (the reference memcpy's into int64_t)
    return struct.unpack("<q", struct.pack("<Q", h1))[0]


# Knuth's 2654435761 = 2^32 / golden ratio, coprime with 2^32.
_HASH_CONSTANT_32 = np.uint32(2654435761)


def multiplicative_hash_np(
    feature_ids: np.ndarray, bucket_indices: np.ndarray, output_bits: int
) -> np.ndarray:
    """Vectorized (feature_id, bucket) → [0, 2**output_bits) bucket id.

    Bit-identical to ``integer_multiplicative_hashing``
    (``hashing_discretizer_impl.cpp:51-70``): h = ((id*c + bucket)*c) with
    uint arithmetic, then take bits [32-output_bits, 32).
    """
    if not 0 < output_bits <= 32:
        raise ValueError("output_bits must be in (0, 32]")
    with np.errstate(over="ignore"):
        h = feature_ids.astype(np.uint32) * _HASH_CONSTANT_32
        h = h + bucket_indices.astype(np.uint32)
        h = h * _HASH_CONSTANT_32
    h = h >> np.uint32(32 - output_bits)
    mask = np.uint32((1 << output_bits) - 1)
    return (h & mask).astype(np.int32)


_M32 = 0xFFFFFFFF


def _mul_mod32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h · c mod 2**32 for int64 ``h`` in [0, 2**32): c split in 16-bit
    halves so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def multiplicative_hash_torch(
    feature_ids: torch.Tensor, bucket_indices: torch.Tensor, output_bits: int
) -> torch.Tensor:
    """Device version of :func:`multiplicative_hash_np`: the uint32 math of
    the C++ done in int64, masked to 32 bits after every step."""
    if not 0 < output_bits <= 32:
        raise ValueError("output_bits must be in (0, 32]")
    c = int(_HASH_CONSTANT_32)
    h = _mul_mod32(feature_ids.to(torch.int64) & _M32, c)
    h = (h + (bucket_indices.to(torch.int64) & _M32)) & _M32
    h = _mul_mod32(h, c)
    h = h >> (32 - output_bits)
    return (h & ((1 << output_bits) - 1)).to(torch.int32)


def multiplicative_hash(
    feature_ids: Union[np.ndarray, torch.Tensor],
    bucket_indices: Union[np.ndarray, torch.Tensor],
    output_bits: int,
):
    if isinstance(feature_ids, np.ndarray):
        return multiplicative_hash_np(
            feature_ids, np.asarray(bucket_indices), output_bits
        )
    return multiplicative_hash_torch(feature_ids, bucket_indices, output_bits)
